"""The reference's 40-epoch schedule, rehearsed: three LR drops, "lr",
"norm" and "best" saves, a preemption and a resume, all through ``train``.

    python -m em_adapt_torch.tools.schedule_rehearsal [--out PATH] [--workdir DIR]
        [--knobs reference|perf] [--regime semi|weak-warmstart] [--warm-start DIR[:TAG]]
        [--arms all|control] [--device DEV]

The port's counterpart of ``tools/schedule_rehearsal.py``. The
reference's production run (reference deeplab.py:242-285) is 40 epochs
through three 10x LR drops at epochs 10, 20 and 30 with an "lr" snapshot
at each, rolling "norm" checkpoints and periodic loss logs. Each cadence
has its unit tests; this tool runs them together at schedule scale, in
three processes of ``python -m em_adapt_torch train``:

* the task: ``--synthetic 768 --synthetic-learnable`` (``LearnableSyntheticVOC``)
  at 129x129, 4 classes, full-width VGG, fc6 64, He init, batch 8,
  accumulation 1: 96 steps an epoch, 40 epochs, 3,840 steps;
* the cadences scaled alike: LR 1e-3 -> 1e-4 -> 1e-5 -> 1e-6 at steps
  960, 1920 and 2880, "norm" every 384 steps, a log record every 96, a
  VOC-protocol eval on 48 val images with the "best" race every 192;
* ``--strong-fraction 0.15``: the reference always starts from the
  ImageNet-pretrained init.npy, whose prior makes the E-step informative
  from step one; from a random init the small strong subset breaks the
  symmetry instead, while 85% of the images train through the weak-tag
  E-step (``--regime weak-warmstart`` instead warm-starts the parameters
  from a trained weak-EM prior and trains on weak tags only, the
  reference's ``model_path`` regime, reference deeplab.py:229-234);
* three arms: control, to the end; preempt, sent SIGTERM once its log
  reports step 1,632 (between the first and second drops); resume
  (``--resume``), to the end. Preempt + resume must give the control's
  losses bit for bit at every common logged step, and the same "best".

``--knobs perf`` runs the same contracts under the port's performance
levers: ``model.compute_dtype=bfloat16`` (block 1 on K2 and K3 on the
card: 129 is square and odd), ``data.wire_dtype=uint8`` and
``data.train_label_size=(17,17)``. The JAX tool's fourth lever,
``train.rng_impl=rbg``, is the TPU's hardware generator and has no
counterpart here: the port draws from one ``torch.Generator``, whose
state the checkpoint carries.

Every arm runs with ``train --deterministic``: under cuDNN's default
algorithms two processes of one seed part from the first logged loss on
(PERF.md §6), and a resumed run is another process than the one
it continues. The artifact records it.

``--arms control`` runs the control arm alone and writes only its val
curve, its "best" sidecar and its wall (no artifact by default): it
re-makes the control's "best" checkpoint under ``--workdir`` for tools
that measure it (``accuracy_cost.py``, ``crf_tuning.py``).

The artifact (``--out``; by default ``SCHEDULE_REHEARSAL_TORCH.json``,
``SCHEDULE_REHEARSAL_TORCH_PERF.json`` or ``SCHEDULE_REHEARSAL_TORCH_WEAK.json``,
never the JAX package's files) holds the logged loss, LR and val streams
of both lineages, the checkpoints found on disk and ``checks`` under the
JAX tool's keys, so ``tests/test_torch_schedule.py`` recomputes every
contract from it; ``card`` is the card's name and power limit. Exit 1
when a contract fails.

All constants live in :data:`PROTOCOL` (:class:`Protocol`), whose
defaults are the JAX tool's; a test runs the same protocol at a
miniature size by passing another.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Protocol:
    """The rehearsal's constants (the JAX tool's l.59-67, 86-107)."""

    images: int = 768
    val_images: int = 48
    batch_size: int = 8
    epochs: int = 40
    lr_drop_epochs: tuple[int, ...] = (10, 20, 30)
    lr_stages: tuple[float, ...] = (1e-3, 1e-4, 1e-5, 1e-6)
    norm_every: int = 384
    log_every: int = 96
    eval_every: int = 192
    preempt_after_step: int = 1632
    strong_fraction: float = 0.15
    #: Model and data overrides of the task.
    task: tuple[str, ...] = (
        "model.num_classes=4", "model.input_size=(129,129)", "model.fc6_channels=64",
        "model.init_scheme=he",
    )
    #: Seconds between two looks at the preempt arm's log.
    poll_seconds: float = 2.0
    #: Seconds an arm may take.
    arm_timeout: float = 3600.0

    @property
    def steps_per_epoch(self) -> int:
        return self.images // self.batch_size

    @property
    def total_steps(self) -> int:
        return self.steps_per_epoch * self.epochs

    @property
    def lr_drop_steps(self) -> tuple[int, ...]:
        return tuple(e * self.steps_per_epoch for e in self.lr_drop_epochs)

    def expected_lr(self, step: int) -> float:
        """The LR of a record at ``step`` steps done: the JSONL logs the
        last executed step's LR, ``lr_at(step - 1)``."""
        return self.lr_stages[sum(step > s for s in self.lr_drop_steps)]


PROTOCOL = Protocol()

#: Steps of the weak-EM prior that ``--regime weak-warmstart`` trains
#: without ``--warm-start`` (``convergence_rehearsal.run_rehearsal``, seed 0).
PRIOR_STEPS = 2500

#: The port's performance levers at the rehearsal's geometry (a 17x17
#: score map at 129x129).
PERF_KNOBS = (
    "model.compute_dtype=bfloat16",
    "data.wire_dtype=uint8",
    "data.train_label_size=(17,17)",
)


def train_cmd(proto: Protocol, save_dir: str, jsonl: str, *extra: str, knobs: tuple = (),
              strong_fraction: float | None = None, device: str | None = None) -> list[str]:
    """One arm's ``python -m em_adapt_torch train`` command line."""
    sf = proto.strong_fraction if strong_fraction is None else strong_fraction
    schedule = tuple(zip(proto.lr_drop_epochs, proto.lr_stages[1:]))
    return [
        sys.executable, "-m", "em_adapt_torch", "train",
        "--synthetic", str(proto.images), "--synthetic-learnable",
        "--synthetic-val", str(proto.val_images),
        "--strong-fraction", str(sf),
        "--log-jsonl", jsonl, "--deterministic",
        *(["--device", device] if device else []),
        *extra,
        *proto.task,
        "optim.accum_steps=1", f"optim.base_lr={proto.lr_stages[0]}",
        f"optim.lr_schedule={schedule}",
        "data.num_workers=2", "data.random_scale=false",
        f"train.batch_size={proto.batch_size}", f"train.epochs={proto.epochs}",
        f"train.log_every_steps={proto.log_every}",
        f"train.eval_every_steps={proto.eval_every}", "train.eval_protocol=voc",
        "train.calibrate_estep=false",
        f"checkpoint.save_dir={save_dir}",
        f"checkpoint.save_every_steps={proto.norm_every}",
        *knobs,
    ]


def _read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _loss_stream(records: list[dict]) -> dict[int, float]:
    return {r["step"]: r["loss"] for r in records if "loss" in r}


def _lr_stream(records: list[dict]) -> dict[int, float]:
    return {r["step"]: r["lr"] for r in records if "lr" in r}


def _val_stream(records: list[dict]) -> list[tuple[int, float]]:
    return [(r["step"], r["val_metric"]) for r in records if "val_metric" in r]


def _ckpt_steps(save_dir: str, tag: str) -> list[int]:
    path = os.path.join(save_dir, tag)
    if not os.path.isdir(path):
        return []
    return sorted(int(name) for name in os.listdir(path) if name.isdigit())


def _first_argmax(curve: list[tuple[int, float]]) -> tuple[int, float]:
    """The trainer's best race takes a strict '>': ties keep the first."""
    if not curve:
        raise RuntimeError("no val_metric records in the JSONL stream: the arm logged no "
                           "evals, and the best-race contracts need a val curve")
    best_step, best = curve[0]
    for step, v in curve[1:]:
        if v > best:
            best_step, best = step, v
    return best_step, best


def _run(proto: Protocol, cmd: list[str], log,
         preempt_jsonl: str | None = None) -> tuple[int, float]:
    """Run one arm; with ``preempt_jsonl``, SIGTERM it once its JSONL
    reports a step >= ``proto.preempt_after_step``. Returns (returncode,
    seconds)."""
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    sent = False

    def pump():
        for line in proc.stdout:
            log("  | " + line.rstrip())

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        while proc.poll() is None:
            if time.time() - t0 > proto.arm_timeout:
                raise RuntimeError(f"arm timed out after {proto.arm_timeout} s: {cmd}")
            if preempt_jsonl and not sent and os.path.exists(preempt_jsonl):
                try:
                    steps = [r["step"] for r in _read_jsonl(preempt_jsonl) if "step" in r]
                except json.JSONDecodeError:
                    steps = []  # a record mid-write: look again
                if steps and max(steps) >= proto.preempt_after_step:
                    log(f"  -> SIGTERM at logged step {max(steps)}")
                    proc.send_signal(signal.SIGTERM)
                    sent = True
            time.sleep(proto.poll_seconds)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        pumper.join(timeout=10)
    if preempt_jsonl and not sent:
        raise RuntimeError("the preempt arm finished before its SIGTERM step was logged")
    return proc.returncode, time.time() - t0


def _card(device: str | None) -> str | None:
    import torch

    from em_adapt_torch.device import card_info

    if device is not None and torch.device(device).type != "cuda":
        return None
    return card_info()


def _sidecar(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "best_metric.json")) as f:
        return json.load(f)


def run(proto: Protocol = PROTOCOL, *, knobs: str = "reference", regime: str = "semi",
        warm_start: str | None = None, workdir: str | None = None, device: str | None = None,
        arms: str = "all", log=print) -> dict:
    """The three arms and the artifact's dict (``pass`` included); with
    ``arms="control"`` the control arm alone and a dict of its val curve,
    its "best" sidecar and its wall."""
    knob_args = PERF_KNOBS if knobs == "perf" else ()
    weak = regime == "weak-warmstart"
    strong_fraction = 0.0 if weak else proto.strong_fraction
    work = workdir or tempfile.mkdtemp(prefix="em_schedule_")
    os.makedirs(work, exist_ok=True)
    warm_args: tuple = ()
    if weak:
        if warm_start is None:
            from em_adapt_torch.tools.convergence_rehearsal import run_rehearsal

            warm_start = os.path.join(work, "prior")
            log(f"no --warm-start: training a weak-EM prior with the convergence rehearsal's "
                f"protocol ({PRIOR_STEPS} steps, seed 0)")
            run_rehearsal(steps=PRIOR_STEPS, seed=0, refine_steps=0, save_dir=warm_start,
                          device=device, log=log)
            warm_start += ":best"
        wdir, tag = warm_start, "best"
        if ":" in warm_start.rpartition("/")[2]:
            wdir, _, tag = warm_start.rpartition(":")
        # --warm-start is params-only and goes to the fresh arms; the
        # resume arm continues its own state.
        warm_args = ("--warm-start", wdir, "--warm-start-tag", tag)

    def cmd(save_dir, jsonl, *extra):
        return train_cmd(proto, save_dir, jsonl, *extra, knobs=knob_args,
                         strong_fraction=strong_fraction, device=device)

    t0 = time.time()
    dir_c, dir_p = os.path.join(work, "control"), os.path.join(work, "preempt")
    jl_c = os.path.join(work, "control.jsonl")
    jl_p1 = os.path.join(work, "preempt_phase1.jsonl")
    jl_p2 = os.path.join(work, "preempt_phase2.jsonl")
    log(f"workdir: {work}")
    log(f"=== arm 1/3: control (uninterrupted, {proto.total_steps} steps) ===")
    rc, t_c = _run(proto, cmd(dir_c, jl_c, *warm_args), log)
    if rc != 0:
        raise RuntimeError(f"control arm failed with rc={rc}")
    log(f"control done in {t_c:.0f}s")
    if arms == "control":
        return {"regime": regime, "knobs": knobs, "total_steps": proto.total_steps,
                "val_curve_control": _val_stream(_read_jsonl(jl_c)),
                "best_sidecar_control": _sidecar(dir_c),
                "elapsed_sec": {"control": round(t_c, 1)}, "workdir": work,
                "card": _card(device)}
    log("=== arm 2/3: preempt (SIGTERM mid-run) ===")
    rc, t_p1 = _run(proto, cmd(dir_p, jl_p1, *warm_args), log, preempt_jsonl=jl_p1)
    if rc != 0:
        raise RuntimeError(f"preempt arm failed with rc={rc}")
    resume_step = max(_ckpt_steps(dir_p, "norm"))
    log(f"preempted cleanly in {t_p1:.0f}s; norm checkpoint at step {resume_step}")
    log("=== arm 3/3: resume (--resume, to completion) ===")
    rc, t_p2 = _run(proto, cmd(dir_p, jl_p2, "--resume"), log)
    if rc != 0:
        raise RuntimeError(f"resume arm failed with rc={rc}")
    log(f"resume done in {t_p2:.0f}s")

    rec_c, rec_p1, rec_p2 = (_read_jsonl(p) for p in (jl_c, jl_p1, jl_p2))
    loss_c = _loss_stream(rec_c)
    loss_p = {**_loss_stream(rec_p1), **_loss_stream(rec_p2)}
    common = sorted(set(loss_c) & set(loss_p))
    post_resume = [s for s in common if s > resume_step]
    mismatches = [{"step": s, "control": loss_c[s], "preempt": loss_p[s]}
                  for s in common if loss_c[s] != loss_p[s]]
    lr_c = _lr_stream(rec_c)
    lr_errors = [{"step": s, "logged": lr, "expected": proto.expected_lr(s)}
                 for s, lr in sorted(lr_c.items()) if lr != proto.expected_lr(s)]
    val_c = _val_stream(rec_c)
    val_p = _val_stream(rec_p1) + _val_stream(rec_p2)
    best_step_c, best_val_c = _first_argmax(val_c)
    best_step_p, best_val_p = _first_argmax(val_p)

    side_c, side_p = _sidecar(dir_c), _sidecar(dir_p)
    lr_snaps_c, lr_snaps_p = _ckpt_steps(dir_c, "lr"), _ckpt_steps(dir_p, "lr")
    norm_c = _ckpt_steps(dir_c, "norm")
    drops = list(proto.lr_drop_steps)
    checks = {
        "losses_bitexact": not mismatches,
        "post_resume_overlap_records": len(post_resume),
        "post_resume_overlap_ok": len(post_resume) >= 15,
        "lr_snapshots_control": lr_snaps_c,
        "lr_snapshots_preempt": lr_snaps_p,
        "lr_snapshots_ok": lr_snaps_c == drops and lr_snaps_p == drops,
        "lr_schedule_errors": lr_errors,
        "lr_schedule_ok": not lr_errors,
        "best_sidecar_control": side_c,
        "best_sidecar_preempt": side_p,
        "best_race_ok": (side_c["step"] == best_step_c and side_p["step"] == best_step_p
                         and side_c["metric"] == best_val_c and side_p["metric"] == best_val_p),
        "best_lineages_identical": (side_c["step"] == side_p["step"]
                                    and side_c["metric"] == side_p["metric"]),
        "norm_steps_control": norm_c,
        "norm_retention_ok": len(norm_c) <= 2 and norm_c[-1] == proto.total_steps,
        "peak_miou": best_val_c,
        "final_miou": val_c[-1][1],
        "learning_ok": best_val_c >= 0.30 and val_c[-1][1] >= best_val_c - 0.06,
    }
    result = {
        "task": "miniature reference 40-epoch schedule rehearsal (LearnableSyntheticVOC, "
                + ("params warm-started from a weak-EM prior + PURE-weak EM — the reference's "
                   "model_path regime, reference deeplab.py:229-234" if weak
                   else "semi-supervised 15% strong")
                + ", preempt+resume)",
        "regime": regime,
        "warm_start": dict(zip(("dir", "tag"), (warm_args[1], warm_args[3]))) if weak else None,
        "total_steps": proto.total_steps,
        "steps_per_epoch": proto.steps_per_epoch,
        "lr_drop_steps": drops,
        "norm_every": proto.norm_every,
        "eval_every": proto.eval_every,
        "log_every": proto.log_every,
        "preempt_trigger_step": proto.preempt_after_step,
        "knobs": knobs,
        "knob_overrides": list(knob_args),
        "deterministic": True,
        "resume_step": resume_step,
        "lr_stream_control": sorted(lr_c.items()),
        "lr_stream_preempt": sorted({**_lr_stream(rec_p1), **_lr_stream(rec_p2)}.items()),
        "loss_stream_control": sorted(loss_c.items()),
        "loss_stream_preempt": sorted(loss_p.items()),
        "loss_mismatches": mismatches,
        "val_curve_control": val_c,
        "val_curve_preempt": val_p,
        "checks": checks,
        "elapsed_sec": {"control": round(t_c, 1), "preempt": round(t_p1, 1),
                        "resume": round(t_p2, 1), "total": round(time.time() - t0, 1)},
        "workdir": work,
        "card": _card(device),
    }
    result["pass"] = (all(checks[k] for k in checks if k.endswith("_ok"))
                      and checks["losses_bitexact"] and checks["best_lineages_identical"])
    return result


def main(argv=None, proto: Protocol = PROTOCOL) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None, help="keep the arms' directories here "
                                                    "(default: a fresh temporary directory)")
    ap.add_argument("--knobs", choices=("reference", "perf"), default="reference",
                    help="'perf': the same contracts under bf16 compute (K2 and K3 on block "
                         "1), the uint8 wire and labels shrunk on the host (PERF_KNOBS)")
    ap.add_argument("--regime", choices=("semi", "weak-warmstart"), default="semi",
                    help="'semi': 15%% strong labels stand in for the pretrained prior; "
                         "'weak-warmstart': params warm-started from a trained weak-EM prior, "
                         "then weak tags only, through the whole schedule")
    ap.add_argument("--warm-start", default=None, metavar="DIR[:TAG]",
                    help="--regime weak-warmstart's prior (default: train one with the "
                         "convergence rehearsal's protocol)")
    ap.add_argument("--arms", choices=("all", "control"), default="all",
                    help="'control': the control arm alone, to re-make its checkpoints under "
                         "--workdir (no contracts; --out only if given)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.arms == "control":
        from em_adapt_torch.device import set_deterministic

        set_deterministic()
        result = run(proto, knobs=args.knobs, regime=args.regime, warm_start=args.warm_start,
                     workdir=args.workdir, device=args.device, arms="control",
                     log=lambda m: print(m, flush=True))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result))
        return 0
    out = args.out or ("SCHEDULE_REHEARSAL_TORCH_WEAK.json" if args.regime == "weak-warmstart"
                       else "SCHEDULE_REHEARSAL_TORCH_PERF.json" if args.knobs == "perf"
                       else "SCHEDULE_REHEARSAL_TORCH.json")
    from em_adapt_torch.device import set_deterministic

    set_deterministic()  # the prior of --regime weak-warmstart trains in this process
    result = run(proto, knobs=args.knobs, regime=args.regime, warm_start=args.warm_start,
                 workdir=args.workdir, device=args.device,
                 log=lambda m: print(m, flush=True))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result["checks"].items() if not isinstance(v, list)},
                     indent=1))
    print(f"pass={result['pass']} -> {out}")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
