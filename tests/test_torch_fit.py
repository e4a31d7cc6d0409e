"""PyTorch port: the training loop against the JAX package's. ``fit``
saves at the same steps per tag as ``em_adapt_tpu``'s ``Trainer.fit`` on
the same configs, and its step budget is absolute and checked before a
batch is pulled."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_checkpoint import batches, port_cfg, trainer_for  # noqa: E402

torch.set_num_threads(2)


# The saved steps per tag of the JAX package's fit and of the port's fit.
# (accum, steps_per_epoch, epochs, lr_schedule, save_every, max_to_keep,
# batches available): test_trainer.py::test_trainer_fit_loop's config,
# ::test_tail_flush_takes_lr_snapshot_and_norm_save's cadences on single
# steps, ::test_zero_cadences_disable_instead_of_crash's, "norm" rolling
# at max_to_keep=2, and three LR drops (every "lr" snapshot kept).
FIT_CASES = {
    "fit-loop": (2, 3, 2, ((1, 1e-4),), 4, 2, 10),
    "tail-cadences": (1, 3, 3, ((2, 1e-4),), 5, 2, 7),
    "zero-cadences": (1, 3, 1, (), 0, 2, 3),
    "retention": (2, 3, 3, (), 2, 2, 9),
    "several-drops": (1, 2, 4, ((1, 1e-4), (2, 1e-5), (3, 1e-6)), 3, 2, 8),
}


def _jax_saved_steps(save_dir, accum, spe, epochs, lr_schedule, save_every, keep, n):
    """Run the JAX package's Trainer.fit with its own Orbax checkpointer.
    Which steps it saves depends on the step counter only, so its
    microbatch step is replaced by one that advances the counter and
    returns a finite, changing loss (no XLA compile of the model). Its
    batch is 8 rows, one for each device of the test session's CPU mesh."""
    from em_adapt_tpu import config as jcfg
    from em_adapt_tpu.train import Trainer as JaxTrainer
    from em_adapt_tpu.train.state import TrainState as JaxState

    cfg = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8),
        optim=jcfg.OptimConfig(accum_steps=accum, lr_schedule=lr_schedule),
        train=jcfg.TrainConfig(batch_size=8, epochs=epochs, seed=0, log_every_steps=10**6),
        data=jcfg.DataConfig(prefetch=0),
        checkpoint=jcfg.CheckpointConfig(save_dir=str(save_dir), save_every_steps=save_every,
                                         max_to_keep=keep, async_save=False),
    )
    trainer = JaxTrainer(cfg, steps_per_epoch=spe)
    trainer.train_step = lambda s, b: (s.replace(step=s.step + 1),
                                       {"loss": s.step.astype(jnp.float32) + 1.0})
    state = JaxState.create({"w": jnp.zeros(2)}, trainer.tx, jax.random.key(0))
    batch = {"image": np.zeros((8, 1, 1, 3), np.float32),
             "label": np.zeros((8, 1, 1, 1), np.float32)}
    state = trainer.fit(state, (batch for _ in range(n)))
    try:
        return int(state.step), {tag: sorted(trainer.checkpointer._manager(tag).all_steps())
                                 for tag in ("norm", "lr")}
    finally:
        trainer.checkpointer.close()


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_saved_steps_per_tag_match_jax_fit(tmp_path, case):
    accum, spe, epochs, lr_schedule, save_every, keep, n = FIT_CASES[case]
    want_step, want = _jax_saved_steps(tmp_path / "jax", *FIT_CASES[case])
    cfg = port_cfg(tmp_path / "port", accum=accum, lr_schedule=lr_schedule,
                   save_every=save_every, max_to_keep=keep, async_save=True, epochs=epochs)
    trainer = trainer_for(cfg, spe)
    state = trainer.init_state()
    trainer.fit(state, (b for _, b in zip(range(n), batches(cfg))))
    assert state.step == want_step
    assert {tag: trainer.checkpointer.all_steps(tag) for tag in ("norm", "lr")} == want
    assert any(want.values()) == (case != "zero-cadences")


def test_fit_does_not_consume_batches_past_the_budget(tmp_path):
    """The budget is checked before a batch is pulled, and it is absolute:
    a state at step 2 with num_steps=4 pulls two batches; no num_steps
    means epochs * steps_per_epoch."""
    cfg = port_cfg(tmp_path, accum=1, epochs=2)
    pulled = []

    def gen():
        for i, batch in enumerate(batches(cfg)):
            pulled.append(i)
            yield batch

    trainer = trainer_for(cfg, steps_per_epoch=3)
    state = trainer.init_state()
    trainer.fit(state, gen(), num_steps=4)
    assert len(pulled) == 4 and state.step == 4
    pulled.clear()
    state.step = 2
    records = trainer.fit(state, gen(), num_steps=4)
    assert len(pulled) == 2 and [r["step"] for r in records] == [2, 3] and state.step == 4
    pulled.clear()
    state.step = 0
    trainer.fit(state, gen())
    assert len(pulled) == 6 and state.step == 6


def test_resumed_fit_stops_at_the_absolute_budget(tmp_path):
    cfg = port_cfg(tmp_path, accum=2, save_every=3)
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    trainer.fit(state, batches(cfg), num_steps=3)
    resumed = trainer_for(cfg).restore_state()
    assert resumed.step == 3
    records = trainer_for(cfg).fit(resumed, batches(cfg, 3), num_steps=5)
    assert [r["step"] for r in records] == [3, 4] and resumed.step == 5
    assert trainer_for(cfg).fit(resumed, batches(cfg, 5), num_steps=5) == []


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-fused-block1"])
def test_fit_with_the_prefetcher_equals_fit_without(tmp_path, bf16):
    """data.prefetch=2 and data.prefetch=0 give the same losses, saves and
    final state (params, momentum, acc, generator), bit for bit; every
    record has the host's wait for its batch."""
    import dataclasses

    from em_adapt_torch.train.state import bitwise_diff

    runs = {}
    for depth in (0, 2):
        cfg = port_cfg(tmp_path / f"prefetch{depth}", bf16=bf16, save_every=3)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, prefetch=depth))
        trainer = trainer_for(cfg)
        state = trainer.init_state()
        records = trainer.fit(state, batches(cfg), num_steps=6)
        runs[depth] = (records, state.state_dict(), trainer.checkpointer.all_steps("norm"))
    (rec0, state0, saved0), (rec2, state2, saved2) = runs[0], runs[2]
    assert [r["loss"] for r in rec2] == [r["loss"] for r in rec0]
    assert len(rec2) == 6 and saved0 == saved2 == [3, 6]
    assert bitwise_diff(state2, state0) == []
    assert all(r["wait_seconds"] >= 0.0 and r["seconds"] > 0.0 for r in rec0 + rec2)


def _poisoned(cfg, at):
    for i, batch in enumerate(batches(cfg)):
        if i == at:
            batch = dict(batch, image=np.full_like(batch["image"], np.nan))
        yield batch


@pytest.mark.parametrize("way_out", ["budget", "batches-end", "sigterm", "watchdog"])
def test_fit_closes_its_prefetcher_on_every_way_out(tmp_path, monkeypatch, way_out):
    """The prefetcher fit makes is closed when the budget is reached, the
    batches end, a SIGTERM stops the run and the watchdog raises: its
    thread is dead and has left the source generator, which can then be
    closed."""
    import signal

    from em_adapt_torch.data import pipeline
    from em_adapt_torch.train import trainer as trainer_mod

    made = []

    class Recorded(pipeline.DevicePrefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(trainer_mod, "DevicePrefetcher", Recorded)
    cfg = port_cfg(tmp_path, accum=1, log_every=1)
    trainer = trainer_for(cfg)
    state = trainer.init_state()
    source = _poisoned(cfg, 1) if way_out == "watchdog" else batches(cfg)
    stream = (b for _, b in zip(range(2), source)) if way_out == "batches-end" else source

    def log_fn(record):  # the window record after step 0 (one step done)
        if way_out == "sigterm" and record["step"] == 1:
            signal.raise_signal(signal.SIGTERM)

    if way_out == "watchdog":
        with pytest.raises(RuntimeError, match="training unhealthy at step 1"):
            trainer.fit(state, stream, num_steps=5, log_fn=log_fn)
    else:
        records = trainer.fit(state, stream, num_steps=5, log_fn=log_fn)
        want = {"budget": 5, "batches-end": 2, "sigterm": 1}[way_out]
        assert len(records) == want and state.step == want
    assert len(made) == 1 and made[0]._limit == 5
    assert not made[0]._thread.is_alive()  # fit joined it before returning
    stream.close()  # raises "generator already executing" if a thread were inside it
