"""PyTorch port: ``train --multihost`` through the command line in
several CPU processes (``em_adapt_torch/tools/multihost_dryrun.py``, a gloo
world over a FileStore), against one process: the counterparts of
``tests/test_multihost.py``'s runs, the stop at a SIGTERM that reaches one
process only, and a process that cannot reach its peers."""

import os
import socket
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from em_adapt_torch.tools.multihost_dryrun import (  # noqa: E402
    launch, launch_preempt_resume, loss_stream, norm_steps, val_stream,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = ["train.eval_every_steps=2", "train.eval_protocol=fixed"]


def test_two_process_train_matches_single_process(tmp_path):
    """Two processes at global batch 8 against one: losses within rel 1e-5
    at steps 1-2, the process-sharded val mIoU within 1e-6 of the whole
    set's, "norm" and "best" written; rank 1 prints no log line."""
    single = launch(1, 2, str(tmp_path / "single"), overrides_extra=EVAL)
    multi = launch(2, 2, str(tmp_path / "multi"), overrides_extra=EVAL)
    want, got = loss_stream(single), loss_stream(multi)
    assert set(want) == set(got) == {1, 2}
    for step in (1, 2):
        assert got[step] == pytest.approx(want[step], rel=1e-5), (want, got)
    assert set(val_stream(single)) == set(val_stream(multi)) == {2}
    assert val_stream(multi)[2] == pytest.approx(val_stream(single)[2], abs=1e-6)
    assert norm_steps(str(tmp_path / "multi")) == [2]
    assert os.listdir(tmp_path / "multi" / "saver" / "best") == ["2"]
    rank0 = (tmp_path / "multi" / "proc0.log").read_text()
    rank1 = (tmp_path / "multi" / "proc1.log").read_text()
    assert "world: 2 processes" in rank0 and "done at step 2" in rank0
    assert "[train]" not in rank1 and "done at" not in rank1


def test_four_process_dryrun(tmp_path):
    """Four processes (2 rows each), 2 steps with the process-sharded eval:
    finite losses, val in [0, 1], "norm" written."""
    log = launch(4, 2, str(tmp_path / "quad"), overrides_extra=EVAL)
    losses = loss_stream(log)
    assert set(losses) == {1, 2} and all(v == v and v < 1e4 for v in losses.values())
    assert 0.0 <= val_stream(log)[2] <= 1.0
    assert norm_steps(str(tmp_path / "quad")) == [2]


def test_space_model_mesh_train_matches_single_process(tmp_path):
    """Four processes as (data 1, space 2, model 2) at 32x32 against one:
    the image's rows split on the host, fc6/fc7 split over the model
    axis; losses within rel 1e-5, the val mIoU (images split over data x
    space, each evaluated whole by its model pair) within 1e-6, the world
    line names the layout, "norm" holds the whole model, and each rank
    reports its kernel launches a step (none on the CPU, where the plain
    versions stand in) and that its peak was not measured."""
    import torch

    size = ["model.input_size=(32,32)", "data.input_size=(32,32)"]
    mesh = ['mesh.axes=(("data",1),("space",2),("model",2))']
    single = launch(1, 2, str(tmp_path / "single"), overrides_extra=size + EVAL)
    multi = launch(4, 2, str(tmp_path / "mesh"), overrides_extra=size + EVAL + mesh)
    want, got = loss_stream(single), loss_stream(multi)
    assert set(want) == set(got) == {1, 2}
    for step in (1, 2):
        assert got[step] == pytest.approx(want[step], rel=1e-5), (want, got)
    assert val_stream(multi)[2] == pytest.approx(val_stream(single)[2], abs=1e-6)
    rank0 = (tmp_path / "mesh" / "proc0.log").read_text()
    assert "world: 4 processes as data 1 x space 2 x model 2" in rank0
    saved = torch.load(tmp_path / "mesh" / "saver" / "norm" / "2" / "state.pt",
                       weights_only=True)
    assert saved["params"]["layers.fc6.weight"].shape[0] == 8
    assert saved["params"]["layers.fc7.weight"].shape[1] == 8
    for r in range(4):
        log = (tmp_path / "mesh" / f"proc{r}.log").read_text()
        assert (f"rank {r}: K1/K2/K3 launches a step [(0, 0, 0), (0, 0, 0)]; peak device "
                "memory not measured (no card)") in log


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """The uninterrupted two-process control run of the preemption tests."""
    return launch(2, 8, str(tmp_path_factory.mktemp("control")))


@pytest.mark.parametrize("ranks", [None, (1,)], ids=["every_process", "rank1_only"])
def test_two_process_preempt_resume_bitexact(tmp_path, control, ranks):
    """SIGTERM after step 3 to every process, or to rank 1 alone: both ranks
    stop at one step (the flag's all-reduce, the max of their proposals),
    "norm" is saved once, every process exits 0 (``launch`` raises
    otherwise); the ``--resume``d losses equal the control's bit for bit
    at every step, at least two of them after the resume."""
    result = launch_preempt_resume(2, 8, 3, str(tmp_path), preempt_ranks=ranks,
                                   control_log=control)
    assert result["loss_mismatches"] == []
    assert 3 <= result["stop_step"] < 8
    assert result["post_resume_steps"] >= 2, result
    assert result["pass"] is True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("pid", [0, 1])
def test_a_process_without_peers_fails_within_its_timeout(tmp_path, pid):
    """Process ``pid`` of a world of 2 whose peer never comes (rank 0 waits
    for it; rank 1 finds no rank 0 at HOST:PORT) fails with the
    rendezvous error within its ``--dist-timeout``, and never trains
    alone."""
    cmd = [sys.executable, "-m", "em_adapt_torch", "train", "--synthetic", "16", "--steps", "1",
           "--device", "cpu", "--multihost", "--coordinator", f"localhost:{_free_port()}",
           "--num-processes", "2", "--process-id", str(pid), "--dist-timeout", "3",
           "train.log_every_steps=1", f"checkpoint.save_dir={tmp_path}"]
    t0 = time.monotonic()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert out.returncode != 0
    assert time.monotonic() - t0 < 60
    text = out.stdout + out.stderr
    assert "timed out" in text.lower() or "timeout" in text.lower(), text[-2000:]
    assert "[train]" not in text and "done at" not in text
    assert not os.path.isdir(tmp_path / "norm")


def test_multihost_flags_need_multihost(capsys):
    """--coordinator, --num-processes or --process-id without --multihost
    is a usage error (exit 2) before anything is built."""
    from em_adapt_torch.__main__ import main

    for flags in (["--coordinator", "localhost:1"], ["--num-processes", "2"],
                  ["--process-id", "0"]):
        assert main(["train", "--synthetic", "4", "--device", "cpu", *flags]) == 2
        assert "need --multihost" in capsys.readouterr().err
