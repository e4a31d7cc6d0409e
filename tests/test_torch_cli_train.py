"""PyTorch port: the ``train`` command's new flags against the JAX
package's CLI. ``--warm-start DIR[:STEP]`` parsed as ``em_adapt_tpu``
parses it; exit 2 for ``--warm-start`` with ``--resume`` and for a
``--synthetic-val`` of 0 or less; ``--strong-fraction``, periodic eval with
``--synthetic-val`` (val_metric records in ``--log-jsonl``, "best",
``best_metric.json``) and a warm start from that "best"."""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from em_adapt_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(2)

CLI = ["--synthetic", "8", "--device", "cpu", "model.width_multiplier=0.125",
       "model.fc6_channels=8", "model.num_classes=4", "model.input_size=(33, 33)",
       "train.batch_size=2", "optim.accum_steps=2", "data.num_workers=1",
       "model.init_scheme=he", "eval.batch_size=2"]


def test_parse_warm_start_matches_jax():
    from em_adapt_torch.__main__ import parse_warm_start
    from em_adapt_tpu.cli import _parse_warm_start

    for spec in ("saver", "/a/b/saver:120", "saver:latest", "saver:12x", ":5", "a:b:7"):
        assert parse_warm_start(spec) == _parse_warm_start(spec)


@pytest.mark.parametrize("argv", [["--warm-start", "x", "--resume"], ["--synthetic-val", "0"],
                                  ["--synthetic-val", "-3"]], ids=["warm+resume", "val0", "val-3"])
def test_cli_rejects_bad_flag_combinations_with_exit_2(tmp_path, capsys, argv):
    from em_adapt_torch.__main__ import main

    assert main(["train", *argv, *CLI, f"checkpoint.save_dir={tmp_path}"]) == 2
    assert "error:" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())  # failed before any work


def test_cli_semi_supervised_eval_best_and_warm_start(tmp_path, capsys, monkeypatch):
    """--strong-fraction turns semi-supervision on; train.eval_every_steps
    with --synthetic-val logs val_metric records (in --log-jsonl), saves
    "best" and writes best_metric.json; a second run warm-starts from that
    "best" (DIR:STEP, --warm-start-tag best) at step 0."""
    from em_adapt_torch import __main__ as cli

    made = []

    class Recorded(Trainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "Trainer", Recorded)
    first, log = tmp_path / "first", tmp_path / "first.jsonl"
    assert cli.main(["train", "--steps", "4", "--strong-fraction", "0.5", "--synthetic-val", "3",
                     "--log-jsonl", str(log), *CLI, f"checkpoint.save_dir={first}",
                     "train.eval_every_steps=2", "train.log_every_steps=1"]) == 0
    out = capsys.readouterr().out
    assert made[0].cfg.semi_supervised and "estep calibration:" in out
    records = [json.loads(line) for line in log.read_text().splitlines()]
    evals = [r for r in records if "val_metric" in r]
    assert [r["step"] for r in evals] == [2, 4] and all(0 <= r["val_metric"] <= 1 for r in evals)
    train = [r for r in records if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["estep_us_per_image_calib"] > 0 for r in train)
    best = made[0].checkpointer.all_steps("best")
    side = json.loads((first / "best_metric.json").read_text())
    assert best and side["step"] == best[-1] and side["metric"] == max(
        r["val_metric"] for r in evals)

    assert cli.main(["train", "--steps", "1", "--warm-start", f"{first}:{best[-1]}",
                     "--warm-start-tag", "best", *CLI,
                     f"checkpoint.save_dir={tmp_path / 'second'}"]) == 0
    out = capsys.readouterr().out
    assert f"warm start: params from {first} (tag=best, step={best[-1]})" in out
    assert "done at step 1" in out and not made[1].cfg.semi_supervised


def test_config_accepts_the_ported_keys_and_names_item_7_for_the_voc_protocol():
    """The JAX package's TrainConfig keys load with its defaults; the TPU
    dispatch levers are accepted and not ported; optim.lr_multipliers no
    longer raises; train.eval_protocol="voc" (Queue 1 item 7, ported) is
    accepted, another value is refused."""
    import dataclasses

    from em_adapt_torch import config as pcfg
    from em_adapt_tpu import config as jcfg

    port, ref = pcfg.TrainConfig(), jcfg.TrainConfig()
    assert {f.name for f in dataclasses.fields(port)} <= {f.name for f in dataclasses.fields(ref)}
    assert pcfg.ExperimentConfig().semi_supervised is jcfg.ExperimentConfig().semi_supervised
    cfg = pcfg.apply_overrides(pcfg.ExperimentConfig(), [
        "train.macro_steps=10", "train.rng_impl=rbg", "train.donate_state=false",
        "optim.lr_multipliers=true", "train.tag_warmup_steps=5", "train.eval_every_steps=10"])
    pcfg.check_supported(cfg)
    voc = pcfg.apply_overrides(pcfg.ExperimentConfig(), ["train.eval_protocol=voc"])
    pcfg.check_supported(voc)
    assert voc.train.eval_protocol == "voc"
    with pytest.raises(ValueError, match="eval_protocol"):
        pcfg.check_supported(pcfg.apply_overrides(pcfg.ExperimentConfig(),
                                                  ["train.eval_protocol=other"]))


def test_cli_synthetic_learnable_trains_and_races_best_on_the_learnable_val_set(
        tmp_path, monkeypatch):
    """The counterpart of tests/test_e2e_voc.py::test_train_cli_synthetic_
    learnable_with_strong_and_eval: --synthetic-learnable trains on
    LearnableSyntheticVOC (blobs of data.input_size, --strong-fraction
    flagging the first images) and races "best" over the learnable val set,
    whose images are the JAX package's val set for the same seed (its
    category offset, not seed + 1)."""
    import numpy as np

    from em_adapt_torch import __main__ as cli
    from em_adapt_tpu.data.pipeline import LearnableSyntheticVOC as JaxLearnable

    made = []

    class Recorded(cli.LearnableSyntheticVOC):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "LearnableSyntheticVOC", Recorded)
    log, saver = tmp_path / "learn.jsonl", tmp_path / "saver"
    assert cli.main(["train", "--synthetic", "16", "--synthetic-learnable", "--synthetic-val", "4",
                     "--strong-fraction", "0.25", "--steps", "4", "--log-jsonl", str(log),
                     "--device", "cpu", "model.width_multiplier=0.125", "model.fc6_channels=8",
                     "model.num_classes=4", "model.input_size=(33, 33)", "model.init_scheme=he",
                     "data.input_size=(33, 33)", "data.num_workers=2", "estep.num_iter=2",
                     "optim.accum_steps=1", "train.batch_size=8", "train.log_every_steps=2",
                     "train.eval_every_steps=2", "train.calibrate_estep=false",
                     "eval.batch_size=2", f"checkpoint.save_dir={saver}",
                     "checkpoint.async_save=false"]) == 0
    train, val = made
    assert (len(train), train.category, train.image_size) == (16, "train", 33)
    np.testing.assert_array_equal(train.is_strong, np.arange(16) < 4)
    want = JaxLearnable(n=4, num_classes=4, seed=0, category="val", image_size=33)
    assert (len(val), val.category) == (4, "val") and val.ids == want.ids
    for i in range(4):
        for got, ref in zip(val.load_raw(i), want.load_raw(i)):
            np.testing.assert_array_equal(got, ref)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    evals = [r for r in records if "val_metric" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    side = json.loads((saver / "best_metric.json").read_text())
    assert side["metric"] == max(r["val_metric"] for r in evals)
    assert (saver / "best" / str(side["step"]) / "state.pt").is_file()


def test_cli_synthetic_learnable_without_synthetic_exits_2(tmp_path, capsys):
    from em_adapt_torch.__main__ import main

    assert main(["train", "--synthetic-learnable", "--device", "cpu",
                 f"checkpoint.save_dir={tmp_path}"]) == 2
    assert "--synthetic-learnable needs --synthetic" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


_PRESETS = {
    "reference": [],
    "gpu-perf": ["model.compute_dtype=bfloat16", "model.block1_impl=pallas",
                 "data.wire_dtype=uint8", "data.train_label_size=(41,41)"],
    "gpu-perf-fold": ["model.compute_dtype=bfloat16", "model.block1_impl=pallas",
                      "data.wire_dtype=uint8", "data.train_label_size=(41,41)",
                      "train.batch_size=30", "optim.accum_steps=1"],
    "gpu-highres": ["model.compute_dtype=bfloat16", "data.wire_dtype=uint8",
                    "model.input_size=(513,513)", "model.remat=true"],
}


def _train_args(preset, *overrides, strong_fraction=0.0):
    import argparse

    return argparse.Namespace(preset=preset, overrides=list(overrides), strong_list=None,
                              strong_fraction=strong_fraction)


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_preset_resolves_to_its_overrides_and_user_overrides_win(preset):
    """Each preset's config is the intended overrides on the defaults, and
    a dotted override of the user's wins over the preset's value."""
    from em_adapt_torch.__main__ import train_config
    from em_adapt_torch.config import ExperimentConfig, apply_overrides

    want = apply_overrides(ExperimentConfig(), _PRESETS[preset])
    assert train_config(_train_args(preset)) == want
    got = train_config(_train_args(preset, "model.compute_dtype=float32", "train.batch_size=4"))
    assert (got.model.compute_dtype, got.train.batch_size) == ("float32", 4)
    assert got.data == want.data and got.optim == want.optim


def test_presets_are_the_jax_presets_levers_on_the_card():
    """The port's presets carry the JAX presets' overrides (cli.py:249-286)
    but the TPU-only ones (fused dispatch, the hardware RNG) and the
    spatial mesh axis, with block 1 on K2/K3 in gpu-perf. gpu-highres
    leaves ``mesh.axes`` out: JAX's space=3 fails on one device, and one
    H100 holds the 513² step whole, so the preset runs on one card;
    ``--multihost`` with ``mesh.axes=(("data",-1),("space",3))`` gives
    JAX's layout."""
    from em_adapt_torch.__main__ import train_presets
    from em_adapt_tpu.cli import train_presets as jax_presets

    tpu_only = ("train.macro_steps", "train.rng_impl", "mesh.axes")
    ours, theirs = train_presets(), jax_presets()
    for gpu, tpu in (("reference", "reference"), ("gpu-perf", "tpu-perf"),
                     ("gpu-perf-fold", "tpu-perf-fold"), ("gpu-highres", "tpu-highres")):
        kept = [o.replace(" ", "") for o in theirs[tpu] if not o.startswith(tpu_only)]
        assert kept == [o for o in ours[gpu] if o != "model.block1_impl=pallas"], gpu
    assert "model.block1_impl=pallas" in ours["gpu-perf"]


@pytest.mark.parametrize("strong_fraction,warns", [(0.5, True), (0.0, False)])
def test_fold_preset_warns_under_semi_supervision(capsys, strong_fraction, warns):
    """gpu-perf-fold with semi-supervision warns as the JAX CLI does
    (cli.py:347-353): batch 30 is not the mean of five batch-6 means there."""
    from em_adapt_torch.__main__ import train_config

    cfg = train_config(_train_args("gpu-perf-fold", strong_fraction=strong_fraction))
    err = capsys.readouterr().err
    assert cfg.semi_supervised is warns
    assert ("WARNING: gpu-perf-fold with semi-supervised training" in err) is warns
    train_config(_train_args("gpu-perf", strong_fraction=0.5))
    assert "WARNING" not in capsys.readouterr().err


def test_cli_preset_flag_reaches_the_trainer(tmp_path, monkeypatch):
    """``train --preset gpu-perf`` trains under the preset (the user's
    small-model overrides on top), the plain versions of K2 and K3
    standing in on the CPU."""
    from em_adapt_torch import __main__ as cli

    made = []

    class Recorded(Trainer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            made.append(self)

    monkeypatch.setattr(cli, "Trainer", Recorded)
    assert cli.main(["train", "--steps", "1", "--preset", "gpu-perf", *CLI,
                     "data.train_label_size=(5,5)", "train.calibrate_estep=false",
                     f"checkpoint.save_dir={tmp_path}"]) == 0
    cfg = made[0].cfg
    assert (cfg.model.compute_dtype, cfg.model.block1_impl, cfg.data.wire_dtype) == (
        "bfloat16", "pallas", "uint8")
    assert cfg.train.batch_size == 2


def test_profile_dir_writes_a_trace_of_the_first_steps(tmp_path):
    """``--profile-dir`` on a 2-step CPU run: one Chrome trace in the
    directory, with a ProfilerStep span for each step taken and one for
    the loop's tail after the last (the final loss check)."""
    from em_adapt_torch.__main__ import main

    trace_dir = tmp_path / "trace"
    assert main(["train", "--steps", "2", "--profile-dir", str(trace_dir), *CLI,
                 "train.calibrate_estep=false", f"checkpoint.save_dir={tmp_path / 'ck'}"]) == 0
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = {e["name"] for e in events if str(e.get("name", "")).startswith("ProfilerStep#")}
    assert steps == {"ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"}
