"""PyTorch port: failure handling. The loss watchdog against the JAX
package's on the same loss sequences, the SIGTERM/SIGINT trap, the
preemption save (and a resume from it that reproduces the uninterrupted
run), no checkpoint of a state whose loss is not finite, and checkpoint
writes that fail or are killed midway."""

import copy
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.train.checkpoint import CheckpointManager  # noqa: E402
from em_adapt_torch.train.state import bitwise_diff  # noqa: E402
from em_adapt_torch.train.trainer import Trainer  # noqa: E402
from em_adapt_torch.utils.failure import GracefulShutdown, LossWatchdog  # noqa: E402
from em_adapt_tpu.utils import failure as jax_failure  # noqa: E402

torch.set_num_threads(2)

NAN, INF = float("nan"), float("inf")
WATCHDOG_CASES = {
    "nan": ([1.0, 0.9, NAN, 0.8], 50),
    "inf": ([1.0, INF], 50),
    "-inf-first": ([-INF, 1.0], 50),
    "frozen-50": ([2.5] * 52, 50),
    "frozen-resets": ([0.5, 0.5, 0.5, 0.6, 0.6, 0.6, 0.6, 0.7], 3),
    "signed-zero": ([0.0, -0.0, 0.0, -0.0], 3),
    "healthy": (list(np.linspace(2.0, 1.0, 60)), 50),
}


@pytest.mark.parametrize("case", list(WATCHDOG_CASES))
def test_watchdog_matches_jax(case):
    """Check by check, the port's verdicts (None or the reason) equal
    em_adapt_tpu/utils/failure.py::LossWatchdog's."""
    losses, patience = WATCHDOG_CASES[case]
    port, ref = LossWatchdog(patience), jax_failure.LossWatchdog(patience)
    got = [port.check(v) for v in losses]
    assert got == [ref.check(v) for v in losses]
    flagged = [i for i, r in enumerate(got) if r is not None]
    assert (flagged != []) == (case != "healthy")
    if case == "frozen-50":
        assert flagged[0] == 50 and "frozen" in got[50]


def _deliver(sig):
    signal.raise_signal(sig)  # the Python handler has run when this returns


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_graceful_shutdown_sets_the_flag_and_restores_the_handler(sig):
    before = signal.getsignal(sig)
    with GracefulShutdown() as s:
        assert not s.requested and not s.requested_uniform()
        assert signal.getsignal(sig) is not before
        _deliver(sig)
        assert s.requested and s.requested_uniform()
        assert s.agreed_stop_step(7) == 7  # one process: its own proposal
    assert signal.getsignal(sig) is before


def test_second_signal_goes_to_the_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        with GracefulShutdown() as s:
            _deliver(signal.SIGTERM)
            assert s.requested and seen == []
            _deliver(signal.SIGTERM)
            assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_handlers_are_installed_only_from_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def enter():
        with GracefulShutdown():
            seen.append(signal.getsignal(signal.SIGTERM))

    t = threading.Thread(target=enter)
    t.start()
    t.join(10)
    assert not t.is_alive() and seen == [before]


def cfg_for(save_dir, *, save_every=0, accum=2, keep=0.5, log_every=500):
    return pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(num_classes=4, input_size=(33, 33), fc6_channels=8,
                               width_multiplier=0.125, init_scheme="he",
                               dropout_keep_prob=keep),
        estep=pcfg.EStepConfig(num_iter=2),
        optim=pcfg.OptimConfig(accum_steps=accum, base_lr=0.01, lr_schedule=()),
        train=pcfg.TrainConfig(batch_size=2, seed=0, log_every_steps=log_every),
        checkpoint=pcfg.CheckpointConfig(save_dir=str(save_dir), save_every_steps=save_every),
    )


def stream(poison_at=None, n=100):
    g = np.random.default_rng(0)
    for step in range(n):
        img = (g.normal(size=(2, 33, 33, 3)) * 20).astype(np.float32)
        if step == poison_at:
            img[:] = np.nan
        label = g.integers(0, 4, size=(2, 33, 33, 1)).astype(np.float32)
        label[:, :4] = 255.0
        yield {"image": img, "label": label}


def test_fit_saves_on_preemption_and_resume_reproduces_the_control(tmp_path):
    """A SIGTERM during step 2 (sent from log_fn, which gets a record after
    every step): fit saves "norm" at step 3, the stop step, and returns; a
    fresh Trainer restored from it and fed the rest of the stream ends
    equal to a run never stopped."""
    control_cfg = cfg_for(tmp_path / "control")
    control = Trainer(control_cfg, device="cpu")
    want = control.init_state()
    want_records = control.fit(want, stream(), num_steps=6)

    cfg = cfg_for(tmp_path / "run", log_every=1)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    handler = signal.getsignal(signal.SIGTERM)

    def log_fn(record):
        if record["step"] == 3:  # three steps done: the window record of step 2
            _deliver(signal.SIGTERM)

    records = trainer.fit(state, stream(), num_steps=6, log_fn=log_fn)
    assert [r["step"] for r in records] == [0, 1, 2] and state.step == 3
    assert trainer.checkpointer.all_steps("norm") == [3]
    assert signal.getsignal(signal.SIGTERM) is handler

    resumed_trainer = Trainer(cfg, device="cpu")
    resumed = resumed_trainer.restore_state()
    assert resumed.step == 3 and resumed.optimizer.mini_step == 1  # mid-window
    rest = stream()
    for _ in range(3):
        next(rest)
    records = resumed_trainer.fit(resumed, rest, num_steps=6)
    assert [r["loss"] for r in records] == [r["loss"] for r in want_records[3:]]
    assert bitwise_diff(resumed.state_dict(), want.state_dict()) == []


def test_fit_watchdog_fires_at_the_poisoned_step(tmp_path):
    """A NaN batch at step 1 of 50 stops fit at step 1: with a log window
    every step, step 0's record (one step done) is the only one logged;
    the window of step 1 checks step 1's loss before it logs."""
    trainer = Trainer(cfg_for(tmp_path, accum=1, log_every=1), device="cpu")
    logged = []
    with pytest.raises(RuntimeError, match="training unhealthy at step 1: non-finite"):
        trainer.fit(trainer.init_state(), stream(poison_at=1), num_steps=50,
                    log_fn=logged.append)
    assert [r["step"] for r in logged] == [1]


def test_fit_watchdog_checks_final_dispatch(tmp_path):
    """The last step of the budget is checked too: a 2-step run whose
    second batch is NaN raises, and its end-of-run state is never saved."""
    trainer = Trainer(cfg_for(tmp_path, accum=1), device="cpu")
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.fit(trainer.init_state(), stream(poison_at=1), num_steps=2)


def test_fit_never_checkpoints_nan_state(tmp_path):
    """The step whose loss is NaN lands on a save boundary (every 2): fit
    raises before the save, and no checkpoint exists."""
    trainer = Trainer(cfg_for(tmp_path, save_every=2, accum=1), device="cpu")
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.fit(trainer.init_state(), stream(poison_at=1), num_steps=4)
    assert trainer.checkpointer.all_steps("norm") == []
    assert not os.path.exists(tmp_path / "norm")


def test_fit_watchdog_stops_a_frozen_loss(tmp_path):
    """LR 0, no dropout, one background-only batch again and again (so the
    E-step's drawn class orders do not matter): the loss is bit-frozen and
    fit raises at the 50th repeat (step 50), read one step late, after
    step 51's launch, having saved nothing of that state."""
    cfg = cfg_for(tmp_path, save_every=60, accum=1, keep=1.0)
    cfg = cfg.replace(optim=pcfg.OptimConfig(accum_steps=1, base_lr=0.0, lr_schedule=()))
    batch = next(stream())
    batch["label"] = np.where(batch["label"] == 255.0, 255.0, 0.0).astype(np.float32)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    with pytest.raises(RuntimeError, match="training unhealthy at step 50: loss frozen"):
        trainer.fit(state, (batch for _ in range(100)), num_steps=100)
    assert state.step == 52 and trainer.checkpointer.all_steps("norm") == []


def trained_state():
    """A state at step 3 of accumulation 2: momentum made, acc mid-window."""
    trainer = Trainer(cfg_for("unused"), device="cpu")
    state = trainer.init_state()
    trainer.fit(state, stream(), num_steps=3)
    return state


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("resave", [False, True], ids=["new-step", "same-step"])
def test_write_failing_midway_keeps_the_previous_latest(tmp_path, monkeypatch, async_save, resave):
    """A write that fails halfway through its file, of a new step or of
    the latest step again, raises (at save, or at wait for an async save)
    and leaves the latest step as it was; a half-written step is not
    listed and its temporary file is gone."""
    state = trained_state()
    ckpt = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path),
                                                   async_save=async_save))
    ckpt.save(state, "norm")
    ckpt.wait()
    saved = copy.deepcopy(state.state_dict())
    real_save = torch.save

    def dies_midway(obj, f, *a, **kw):
        f.write(b"\x80\x02half a checkpoint")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", dies_midway)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    state.step = 3 if resave else 4
    if async_save:
        ckpt.save(state, "norm")
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            ckpt.wait()
    else:
        with pytest.raises(OSError, match="disk gone"):
            ckpt.save(state, "norm")
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.all_steps("norm") == [3]
    assert os.listdir(ckpt.step_dir("norm", state.step)) == (["state.pt"] if resave else [])
    assert bitwise_diff(ckpt.load("norm"), saved) == []
    ckpt.wait()  # the failure was reported once


_KILLED_WRITER = r"""
import os, sys, torch
from em_adapt_torch.config import CheckpointConfig
from em_adapt_torch.train.checkpoint import CheckpointManager

class State:
    def __init__(self, value):
        self.value = value
    def state_dict(self):
        return {"step": 3, "params": {"w": torch.full((1000,), self.value)}}

ckpt = CheckpointManager(CheckpointConfig(save_dir=sys.argv[1], async_save=False))
ckpt.save(State(1.0), "norm")

def killed_midway(obj, f, *a, **kw):
    f.write(b"\x80\x02half a checkpoint")
    f.flush()
    os._exit(9)  # the process dies here: no handler, no clean-up

torch.save = killed_midway
ckpt.save(State(2.0), "norm")
"""


def test_process_killed_midway_through_a_resave_keeps_the_latest(tmp_path):
    """A process killed while it rewrites its latest step leaves that step
    readable with its earlier contents; the torn temporary file stays
    beside it and is never read."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _KILLED_WRITER, str(tmp_path)], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 9, out.stderr
    ckpt = CheckpointManager(pcfg.CheckpointConfig(save_dir=str(tmp_path)))
    assert ckpt.all_steps("norm") == [3]
    assert sorted(os.listdir(ckpt.step_dir("norm", 3)))[0] == "state.pt"
    assert len(os.listdir(ckpt.step_dir("norm", 3))) == 2
    assert torch.equal(ckpt.load("norm")["params"]["w"], torch.full((1000,), 1.0))
