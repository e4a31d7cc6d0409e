"""Data-parallel training through the command line, N processes at once.

    python -m em_adapt_torch.tools.multihost_dryrun [--processes 2] [--steps 2]
        [--device cpu|cuda|cuda:0] [--dist-backend auto|gloo] [--preempt]
        [--workdir DIR] [key=value ...]

The port's counterpart of ``tools/multihost_dryrun.py``. It starts
``--processes`` processes of ``python -m em_adapt_torch train --multihost``
(a FileStore rendezvous under the workdir, so that concurrent runs never
share a port) on ``SyntheticVOC`` with a small model (:data:`SMALL`, the
JAX tool's at VGG width 0.125; overrides given after the options replace
its values), waits for them, kills them all when one fails or the
timeout passes, and prints process 0's metrics. ``--device cuda`` puts
process i on card i (``--device cuda:0`` puts every process on card 0,
with ``--dist-backend gloo``: NCCL refuses two processes on one card).

``--preempt`` runs :func:`launch_preempt_resume`: a control run to the
end, the same run sent SIGTERM after step 5 (by default every process;
``preempt_ranks`` picks some) and resumed with ``--resume``; its losses
must equal the control's bit for bit at every step. It prints the checks
as JSON and exits 1 when they fail.

The default workdir is a new directory under ``build/`` of the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: The small model and input of the CPU dryrun: the JAX tool's overrides
#: (4 classes, 33x33, fc6 8, 2 E-step rounds, accumulation 1, global batch
#: 8) at VGG width 0.125, without the E-step calibration.
SMALL = ("model.num_classes=4", "model.input_size=(33,33)", "model.fc6_channels=8",
         "model.width_multiplier=0.125", "estep.num_iter=2", "optim.accum_steps=1",
         "train.batch_size=8", "data.num_workers=2", "data.prefetch=1",
         "train.calibrate_estep=false")


def read_records(path: str) -> list[dict]:
    """The complete JSON lines of a metrics file (a line mid-write is skipped)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    except OSError:
        pass
    return out


def loss_stream(path: str) -> dict[int, float]:
    """{step: loss} of a metrics file's training records."""
    return {int(r["step"]): r["loss"] for r in read_records(path) if "loss" in r}


def val_stream(path: str) -> dict[int, float]:
    """{step: val_metric} of a metrics file's eval records."""
    return {int(r["step"]): r["val_metric"] for r in read_records(path) if "val_metric" in r}


def _tail(path: str, lines: int = 40) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def launch(
    num_processes: int = 2,
    steps: int = 2,
    workdir: str | None = None,
    overrides_extra: list[str] | tuple[str, ...] = (),
    extra_flags: list[str] | tuple[str, ...] = (),
    preempt_after_step: int | None = None,
    preempt_ranks: tuple[int, ...] | None = None,
    *,
    device: str = "cpu",
    model: tuple[str, ...] = SMALL,
    synthetic: int = 16,
    multihost: bool | None = None,
    timeout: float = 600.0,
    log_name: str = "proc0_metrics.jsonl",
    threads: int | None = 2,
) -> str:
    """Run ``train`` in ``num_processes`` processes; return the path of
    process 0's metrics JSONL (one record a step). ``multihost`` (default:
    more than one process) adds ``--multihost`` with a FileStore
    rendezvous; one process without it is the reference run.

    Every process gets ``--synthetic synthetic --steps steps --device
    device``, ``extra_flags``, then ``model``, a log record every step,
    synchronous checkpoints under ``workdir/saver`` with no cadence, and
    ``overrides_extra``. Each writes its output to ``workdir/procI.log``;
    ``threads`` caps its CPU threads (``OMP_NUM_THREADS``; None: the
    default). With ``preempt_after_step`` the processes ``preempt_ranks``
    (default: all) are sent SIGTERM once process 0 has logged that step.

    Raises RuntimeError, with the failing processes' log tails, when one
    exits non-zero (the others are killed 10 s later if they hang) or the
    ``timeout`` passes (all killed)."""
    workdir = workdir or tempfile.mkdtemp(prefix="multihost-dryrun-",
                                          dir=os.path.join(ROOT, "build"))
    os.makedirs(workdir, exist_ok=True)
    multihost = num_processes > 1 if multihost is None else multihost
    log_path = os.path.join(workdir, log_name)
    overrides = [*model, "train.log_every_steps=1",
                 f"checkpoint.save_dir={os.path.join(workdir, 'saver')}",
                 "checkpoint.save_every_steps=1000000", "checkpoint.async_save=false",
                 *overrides_extra]
    rendezvous = f"file://{os.path.join(os.path.abspath(workdir), f'rdzv-{uuid.uuid4().hex}')}"
    env = {**os.environ, "PYTHONPATH": ROOT}
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            cmd = [sys.executable, "-m", "em_adapt_torch", "train", "--synthetic", str(synthetic),
                   "--steps", str(steps), "--device", device]
            if multihost:
                cmd += ["--multihost", "--coordinator", rendezvous,
                        "--num-processes", str(num_processes), "--process-id", str(pid)]
            if pid == 0:
                cmd += ["--log-jsonl", log_path]
            cmd += [*extra_flags, *overrides]
            logs.append(os.path.join(workdir, f"proc{pid}.log"))
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        if preempt_after_step is not None:
            targets = range(num_processes) if preempt_ranks is None else preempt_ranks
            while not any(s >= preempt_after_step for s in loss_stream(log_path)):
                if all(p.poll() is not None for p in procs):
                    raise RuntimeError(f"the run ended before step {preempt_after_step} was "
                                       "logged: raise steps")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"step {preempt_after_step} not logged in {timeout} s")
                time.sleep(0.05)
            for pid in targets:
                procs[pid].send_signal(signal.SIGTERM)
        first_failure = None
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                first_failure = first_failure or time.monotonic()
                if time.monotonic() - first_failure > 10:
                    break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "".join(f"--- process {i} (exit {rc}) ---\n{_tail(logs[i])}"
                        for i, rc in enumerate(rcs) if rc != 0)
        raise RuntimeError(f"multihost dryrun: exit codes {rcs}\n{tails}")
    return log_path


def norm_steps(workdir: str) -> list[int]:
    """The steps of the "norm" checkpoints under ``workdir/saver``."""
    root = os.path.join(workdir, "saver", "norm")
    return sorted(int(n) for n in os.listdir(root) if n.isdigit()) if os.path.isdir(root) else []


def launch_preempt_resume(
    num_processes: int = 2,
    steps: int = 16,
    preempt_after_step: int = 5,
    workdir: str | None = None,
    preempt_ranks: tuple[int, ...] | None = None,
    control_log: str | None = None,
    **kw,
) -> dict:
    """A control run to ``steps``; the same run sent SIGTERM (the ranks
    ``preempt_ranks``, default all) once process 0 logged
    ``preempt_after_step``, which must save "norm" once at one step and
    exit 0 on every process; then ``--resume`` to ``steps``. Its losses
    must equal the control's bit for bit at every step, with at least
    two steps after the resume (``tools/multihost_dryrun.py::
    launch_preempt_resume``). ``control_log`` reuses a control run's
    metrics. ``kw`` goes to every :func:`launch`. Returns the checks."""
    workdir = workdir or tempfile.mkdtemp(prefix="multihost-preempt-",
                                          dir=os.path.join(ROOT, "build"))
    flags = list(kw.pop("extra_flags", ()))
    if control_log is None:
        control_log = launch(num_processes, steps, os.path.join(workdir, "control"),
                             extra_flags=flags, **kw)
    preempt = os.path.join(workdir, "preempt")
    first = launch(num_processes, steps, preempt, extra_flags=flags,
                   preempt_after_step=preempt_after_step, preempt_ranks=preempt_ranks,
                   log_name="proc0_phase1.jsonl", **kw)
    saved = norm_steps(preempt)
    if len(saved) != 1:
        raise RuntimeError(f"the preempted run saved 'norm' at steps {saved}, not once")
    second = launch(num_processes, steps, preempt, extra_flags=[*flags, "--resume"],
                    log_name="proc0_phase2.jsonl", **kw)
    control = loss_stream(control_log)
    resumed = {**loss_stream(first), **loss_stream(second)}
    common = sorted(set(control) & set(resumed))
    mismatches = [{"step": s, "control": control[s], "preempt": resumed[s]}
                  for s in common if control[s] != resumed[s]]
    result = {
        "processes": num_processes,
        "steps": steps,
        "preempt_trigger_step": preempt_after_step,
        "preempt_ranks": list(range(num_processes)) if preempt_ranks is None
        else list(preempt_ranks),
        "stop_step": saved[0],
        "loss_stream_control": sorted(control.items()),
        "loss_stream_preempt": sorted(resumed.items()),
        "loss_mismatches": mismatches,
        "post_resume_steps": len([s for s in common if s > saved[0]]),
        "workdir": workdir,
    }
    result["pass"] = (not mismatches and len(common) == steps
                      and result["post_resume_steps"] >= 2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cpu", help="cpu, cuda (card i for process i) or cuda:N")
    ap.add_argument("--dist-backend", choices=("auto", "gloo"), default="auto")
    ap.add_argument("--preempt", action="store_true",
                    help="control, SIGTERM after step 5, --resume: losses bit-equal")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("overrides", nargs="*", help="dotted config overrides after SMALL's")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, extra_flags=["--dist-backend", args.dist_backend],
              overrides_extra=args.overrides)
    if args.preempt:
        result = launch_preempt_resume(args.processes, max(args.steps, 16),
                                       workdir=args.workdir, **kw)
        print(json.dumps({k: v for k, v in result.items() if not isinstance(v, list)}))
        return 0 if result["pass"] else 1
    log_path = launch(args.processes, args.steps, args.workdir, **kw)
    print(f"multihost dryrun OK; process 0's metrics at {log_path}")
    with open(log_path) as f:
        sys.stdout.write(f.read())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
