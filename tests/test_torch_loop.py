"""PyTorch port: the rest of the training loop against the JAX package's.
``MetricLogger`` on the same records; the steps at which ``fit`` logs,
evaluates and saves ("norm", "lr", "best" and ``best_metric.json``)
against ``em_adapt_tpu``'s ``Trainer.fit`` on the same cadences and
scripted eval scores; the loss checked one step late (the JAX package's
watchdog tests, ported); losses and state bit-equal whatever the log
cadence and with periodic eval on or off; the best score across a
trainer restart."""

import dataclasses
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator  # noqa: E402
from em_adapt_torch.eval.miou import miou_from_confusion  # noqa: E402
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.train.state import bitwise_diff  # noqa: E402
from em_adapt_torch.train.trainer import Trainer  # noqa: E402
from em_adapt_torch.utils.logging import MetricLogger  # noqa: E402
from em_adapt_tpu.utils.logging import MetricLogger as JaxMetricLogger  # noqa: E402
from tests.test_torch_checkpoint import batches, port_cfg, trainer_for  # noqa: E402
from tests.test_torch_failure import cfg_for, stream  # noqa: E402

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# MetricLogger


def _log_both(tmp_path, records, port_records=None):
    """stdout and JSONL of the port's logger and of the JAX package's on
    the same records (``port_records``: the port's own spelling of them),
    with the wall-clock field ``t`` taken out."""
    out = {}
    for name, cls, recs in (("port", MetricLogger, port_records or records),
                            ("jax", JaxMetricLogger, records)):
        buf, path = io.StringIO(), tmp_path / f"{name}.jsonl"
        logger = cls(str(path), stream=buf)
        for rec, prefix in recs:
            logger.log(rec, prefix=prefix)
        logger.close()
        lines = [" ".join(w for w in line.split() if not w.startswith("t="))
                 for line in buf.getvalue().splitlines()]
        jsonl = [{k: v for k, v in json.loads(line).items() if k != "t"}
                 for line in path.read_text().splitlines()]
        out[name] = (lines, jsonl)
    return out


def test_metric_logger_matches_jax_on_plain_records(tmp_path):
    records = [({"loss": 1.5, "step": 10, "lr": 1e-3, "images_per_sec": 123.456789}, "train"),
               ({"miou": 0.42, "name": "val", "none": None, "flag": True}, "eval"),
               ({"step": 20, "val_metric": 0.3333333333}, "train")]
    got = _log_both(tmp_path, records)
    assert got["port"] == got["jax"]
    lines, jsonl = got["port"]
    assert lines[0] == "[train] loss=1.5 step=10 lr=0.001 images_per_sec=123.457"
    assert jsonl[1] == {"prefix": "eval", "miou": 0.42, "name": "val", "none": None,
                        "flag": True}


def test_metric_logger_matches_jax_on_non_finite_and_nested_values(tmp_path):
    """NaN and ±inf, at the top and nested in dicts and lists, go into the
    JSONL as strings; numpy scalars nested in containers convert (ints
    stay ints); a vector becomes a list."""
    records = [({"loss": float("nan"), "per_class": {"cat": float("inf"), "dog": np.float32(0.25)},
                 "curve": [np.float32(1.5), np.int32(2), float("-inf")],
                 "step": np.int64(500), "iou": np.array([0.5, 0.25], np.float32)}, "train")]
    got = _log_both(tmp_path, records)
    assert got["port"] == got["jax"]
    (rec,) = got["port"][1]
    assert rec["loss"] == "nan" and rec["per_class"] == {"cat": "inf", "dog": 0.25}
    assert rec["curve"] == [1.5, 2, "-inf"] and rec["step"] == 500
    assert isinstance(rec["step"], int) and rec["iou"] == [0.5, 0.25]


def test_metric_logger_takes_torch_scalars_as_jax_takes_jax_scalars(tmp_path):
    """0-d tensors (float, integer, nested) log as the JAX logger logs the
    same values as 0-d JAX arrays; a tensor vector becomes a list."""
    jax_records = [({"loss": jnp.float32(2.0), "step": jnp.int32(7),
                     "nested": {"l2": jnp.float32(0.125)}, "v": jnp.arange(3)}, "train")]
    port_records = [({"loss": torch.tensor(2.0), "step": torch.tensor(7, dtype=torch.int32),
                      "nested": {"l2": torch.tensor(0.125)}, "v": torch.arange(3)}, "train")]
    got = _log_both(tmp_path, jax_records, port_records)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["[train] loss=2 step=7 nested={'l2': 0.125} v=[0, 1, 2]"]
    assert isinstance(got["port"][1][0]["step"], int)


# --------------------------------------------------------------------------
# Cadences of fit against the JAX package's


# (accum, steps_per_epoch, lr_schedule, log_every, eval_every, save_every,
# batches, scripted eval scores): windows that divide the run and ones that
# do not, an eval that regresses, evals on the save steps, an LR drop.
CADENCE_CASES = {
    "log1-eval2-save3": (2, 3, ((1, 1e-4),), 1, 2, 3, 7, [0.1, 0.3, 0.2]),
    "log2-eval3-save0": (1, 4, (), 2, 3, 0, 8, [0.5, 0.4]),
    "log3-eval1-save2": (2, 2, ((2, 1e-4),), 3, 1, 2, 6, [0.1, 0.1, 0.2, 0.05, 0.3, 0.3]),
    "log0-evalnone-save4": (1, 3, ((1, 1e-4),), 0, None, 4, 9, []),
    "log4-eval4-save4": (2, 3, (), 4, 4, 4, 10, [0.7, 0.9]),
}


def _jax_cadences(save_dir, accum, spe, lr_schedule, log_every, eval_every, save_every, n,
                  scores):
    """The JAX package's fit with its microbatch step replaced by a counter
    (as tests/test_torch_fit.py does): what it logged and saved."""
    from em_adapt_tpu import config as jcfg
    from em_adapt_tpu.train import Trainer as JaxTrainer
    from em_adapt_tpu.train.state import TrainState as JaxState

    cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8),
        optim=jcfg.OptimConfig(accum_steps=accum, base_lr=0.01, lr_schedule=lr_schedule),
        train=jcfg.TrainConfig(batch_size=8, epochs=10, seed=0, log_every_steps=log_every,
                               eval_every_steps=eval_every),
        data=jcfg.DataConfig(prefetch=0),
        checkpoint=jcfg.CheckpointConfig(save_dir=str(save_dir), save_every_steps=save_every,
                                         max_to_keep=10, async_save=False),
    )
    trainer = JaxTrainer(cfg, steps_per_epoch=spe)
    trainer.train_step = lambda s, b: (s.replace(step=s.step + 1),
                                       {"loss": s.step.astype(jnp.float32) + 1.0})
    state = JaxState.create({"w": jnp.zeros(2)}, trainer.tx, jax.random.key(0))
    batch = {"image": np.zeros((8, 1, 1, 3), np.float32),
             "label": np.zeros((8, 1, 1, 1), np.float32)}
    logged = []
    it = iter(scores)
    trainer.fit(state, (batch for _ in range(n)), log_fn=logged.append,
                eval_fn=lambda s: next(it))
    try:
        saved = {tag: sorted(trainer.checkpointer._manager(tag).all_steps())
                 for tag in ("norm", "lr", "best")}
    finally:
        trainer.checkpointer.close()
    return logged, saved


def _summary(logged):
    train = [(r["step"], r["epoch"], r["lr"]) for r in logged if "loss" in r]
    evals = [(r["step"], r["val_metric"]) for r in logged if "val_metric" in r]
    return train, evals


@pytest.mark.parametrize("case", list(CADENCE_CASES))
def test_log_eval_and_save_steps_match_jax_fit(tmp_path, case):
    """Log records (step, epoch, lr), eval records (step, val_metric), the
    steps saved under "norm", "lr" and "best", and best_metric.json equal
    the JAX package's on the same cadences and eval scores; every train
    record has the JAX package's keys."""
    accum, spe, lr_schedule, log_every, eval_every, save_every, n, scores = CADENCE_CASES[case]
    want_logged, want_saved = _jax_cadences(tmp_path / "jax", *CADENCE_CASES[case])
    cfg = port_cfg(tmp_path / "port", accum=accum, lr_schedule=lr_schedule,
                   save_every=save_every, max_to_keep=10, log_every=log_every, epochs=10)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_every_steps=eval_every))
    trainer = trainer_for(cfg, spe)
    state = trainer.init_state()
    logged = []
    it = iter(scores)
    records = trainer.fit(state, (b for _, b in zip(range(n), batches(cfg))),
                          log_fn=logged.append, eval_fn=lambda s: next(it))
    assert len(records) == n and all(math.isfinite(r["loss"]) for r in records)
    assert _summary(logged) == _summary(want_logged)
    jax_keys = {"step", "epoch", "lr", "images_per_sec", "loss", "loss_norm", "loss_l2"}
    assert all(jax_keys <= r.keys() for r in logged if "loss" in r)
    assert {tag: trainer.checkpointer.all_steps(tag) for tag in ("norm", "lr", "best")} \
        == want_saved
    sidecar = [d / "best_metric.json" for d in (tmp_path / "jax", tmp_path / "port")]
    assert [p.exists() for p in sidecar] == [bool(want_saved["best"])] * 2
    if want_saved["best"]:
        assert json.loads(sidecar[1].read_text()) == json.loads(sidecar[0].read_text())


def test_log_window_records_sum_their_steps(tmp_path):
    """A window record carries the last step's loss and the window's own
    steps: their count, wait and launches (0 on the CPU), and a positive
    wall time; per-step records hold the host's launch time."""
    cfg = port_cfg(tmp_path, accum=1, log_every=3)
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    logged = []
    records = trainer.fit(state, batches(cfg), num_steps=7, log_fn=logged.append)
    assert [r["step"] for r in logged] == [3, 6]
    for w, last in zip(logged, (records[2], records[5])):
        assert w["loss"] == last["loss"] and w["window_steps"] == 3
        assert w["window_seconds"] > 0 and w["images_per_sec"] > 0
        assert w["estep_launches"] == w["block1_fwd_launches"] == w["block1_bwd_launches"] == 0
        assert w["loss"] == pytest.approx(w["loss_norm"] + 1e-5 * w["loss_l2"], rel=1e-6)
    assert logged[1]["wait_seconds"] == pytest.approx(sum(r["wait_seconds"] for r in records[3:6]))
    assert all(r["seconds"] > 0 for r in records)


# --------------------------------------------------------------------------
# The loss checked one step late: the JAX package's watchdog tests, ported


def test_fit_watchdog_fires_below_log_cadence(tmp_path):
    """tests/test_failure.py::test_fit_watchdog_fires_below_log_cadence: a
    NaN batch at step 1 of 50 with a log window of 10^6 steps is caught
    one step late, right after step 2's launch; log_fn never fired."""
    cfg = cfg_for(tmp_path, accum=1, log_every=10**6)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    logged = []
    with pytest.raises(RuntimeError, match="training unhealthy at step 1: non-finite"):
        trainer.fit(state, stream(poison_at=1), num_steps=50, log_fn=logged.append)
    assert not logged and state.step == 3


def test_fit_watchdog_checks_final_dispatch(tmp_path):
    """tests/test_failure.py::test_fit_watchdog_checks_final_dispatch: the
    last step has no next step to be read behind; a 2-step run whose
    second (final) batch is NaN raises all the same."""
    cfg = cfg_for(tmp_path, accum=1, log_every=10**6)
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="training unhealthy at step 1: non-finite"):
        trainer.fit(trainer.init_state(), stream(poison_at=1), num_steps=2)


@pytest.mark.parametrize("tag", ["norm", "lr", "best"])
def test_fit_never_checkpoints_nan_state(tmp_path, tag):
    """tests/test_failure.py::test_fit_never_checkpoints_nan_state, for
    each cadence save: the step that lands on the save (step 1, after
    which "norm" every 2, "lr" before the drop at step 2 and "best" after
    the eval every 2 would save) is NaN; its loss is checked before the
    save, the run raises, and nothing of that state is written."""
    cfg = cfg_for(tmp_path, accum=1, log_every=10**6, save_every=2 if tag == "norm" else 0)
    if tag == "lr":
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr_schedule=((2, 1e-3),)))
    if tag == "best":
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_every_steps=2))
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="training unhealthy at step 1: non-finite"):
        trainer.fit(trainer.init_state(), stream(poison_at=1), num_steps=4,
                    eval_fn=lambda s: 1.0)
    for t in ("norm", "lr", "best"):
        assert trainer.checkpointer.all_steps(t) == []
    assert not (tmp_path / "best_metric.json").exists()


# --------------------------------------------------------------------------
# Losses and state do not depend on the cadences


def _run(save_dir, *, log_every=500, eval_every=None, eval_fn=None, steps=7):
    cfg = port_cfg(save_dir, accum=3, log_every=log_every, save_every=4)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_every_steps=eval_every))
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    logged = []
    records = trainer.fit(state, batches(cfg), num_steps=steps, log_fn=logged.append,
                          eval_fn=eval_fn)
    return records, state, logged


def test_losses_and_state_are_bit_equal_at_log_every_1_and_7(tmp_path):
    rec1, state1, log1 = _run(tmp_path / "every1", log_every=1)
    rec7, state7, log7 = _run(tmp_path / "every7", log_every=7)
    assert [r["loss"] for r in rec1] == [r["loss"] for r in rec7]
    assert bitwise_diff(state1.state_dict(), state7.state_dict()) == []
    assert [r["step"] for r in log1] == list(range(1, 8)) and [r["step"] for r in log7] == [7]
    assert [r["loss"] for r in log1] == [r["loss"] for r in rec1]


def test_periodic_eval_leaves_losses_state_and_mode_as_they_were(tmp_path):
    """A real eval (the fixed-resolution mIoU of the training model on
    synthetic val images, which puts the model in eval mode) every 2
    steps: the losses, the final state (generator included) and the
    model's train mode are those of the run without eval, bit for bit."""
    cfg = port_cfg(tmp_path / "cfg")
    val = SyntheticVOC(3, 4, seed=1)
    scores = []

    def eval_fn(state):
        vb = batch_iterator(val, cfg.data, batch_size=2, seed=0, epochs=1, train=False)
        scores.append(miou_from_confusion(Evaluator(cfg, state.model).confusion_fixed(vb))[0])
        assert not state.model.training
        return scores[-1]

    rec0, state0, _ = _run(tmp_path / "plain")
    rec1, state1, logged = _run(tmp_path / "eval", eval_every=2, eval_fn=eval_fn)
    assert len(scores) == 3 and [r["step"] for r in logged if "val_metric" in r] == [2, 4, 6]
    assert [r["loss"] for r in rec1] == [r["loss"] for r in rec0]
    assert bitwise_diff(state1.state_dict(), state0.state_dict()) == []
    assert state1.model.training


def test_best_metric_survives_trainer_restart(tmp_path):
    """tests/test_trainer.py::test_best_metric_survives_trainer_restart: a
    resumed state (step > 0) inherits the stored best, so a worse first
    eval after the restart writes no "best"; a better one does; a fresh
    state (step 0), in a new Trainer or in the same one, starts from -inf."""
    cfg = port_cfg(tmp_path, accum=2, lr_schedule=(), max_to_keep=10)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_every_steps=2))
    side = tmp_path / "best_metric.json"

    def fit(trainer, state, scores, start=0):
        it = iter(scores)
        trainer.fit(state, batches(cfg, start), num_steps=state.step + 2 * len(scores),
                    eval_fn=lambda s: next(it))

    trainer = trainer_for(cfg, 3)
    fit(trainer, trainer.init_state(), [0.1, 0.5, 0.2])
    assert trainer.checkpointer.all_steps("best") == [2, 4]
    assert json.loads(side.read_text()) == {"metric": 0.5, "step": 4}

    trainer2 = trainer_for(cfg, 3)
    state = trainer2.restore_state("best")  # step 4
    fit(trainer2, state, [0.3], start=4)
    assert trainer2.checkpointer.all_steps("best") == [2, 4]
    assert json.loads(side.read_text())["metric"] == 0.5

    trainer3 = trainer_for(cfg, 3)
    state = trainer3.restore_state("best")
    fit(trainer3, state, [0.9], start=4)
    assert trainer3.checkpointer.all_steps("best") == [2, 4, 6]
    assert json.loads(side.read_text()) == {"metric": 0.9, "step": 6}

    trainer4 = trainer_for(cfg, 3)
    fit(trainer4, trainer4.init_state(), [0.2, 0.05, 0.01])
    assert json.loads(side.read_text())["metric"] == 0.2
    fit(trainer4, trainer4.init_state(), [0.15, 0.02, 0.01])
    assert json.loads(side.read_text()) == {"metric": 0.15, "step": 2}
