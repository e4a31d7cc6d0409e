"""The dense CRF's hyperparameters, tuned on a trained checkpoint.

    python -m em_adapt_torch.tools.crf_tuning [--checkpoint DIR[:TAG]] [--tune-images N]
        [--val-images N] [--workers N] [--workdir DIR] [--deterministic] [--device DEV]
        [--out PATH]

The port's counterpart of ``tools/crf_tuning.py``, with its streams, its
grid and its contracts. The reference's CRF (reference network.py:63:
bilateral sxy 121, srgb 5, compat 10) was tuned for VOC photos; on the
129x129 ``LearnableSyntheticVOC`` task its bilateral kernel spans the
whole frame. This tool searches the space on a stream of its own and
measures the winner once on another:

* the tune stream: ``LearnableSyntheticVOC`` "val" images of seed 555,
  disjoint from the checkpoint's selection stream (seed 0, the "best"
  race) and from the measurement stream (seed 777, ``accuracy_cost.py``'s
  first);
* each image's class probabilities are computed once
  (:func:`_collect_probs`), by the path of ``Evaluator.confusion_voc``: the
  network at the training input size, a TF1-grid bilinear upsample of
  the logits to the image's size, softmax;
* stage A: the bilateral kernel's sxy x srgb x compat (:data:`STAGE_A`,
  the VOC point among them), the spatial kernel at the reference's (3, 3);
* stage B around stage A's best: the spatial kernel's sxy x compat, and
  2 or 5 mean-field iterations (:func:`stage_b_settings`);
* the best tune setting, applied once to the measurement stream beside
  the VOC point and no CRF.

Each setting's mIoU refines every cached image with the host CRF
(``eval/crf.py::dense_crf``, the permutohedral lattice) on ``--workers``
threads; the confusion matrix does not depend on their number. Without
``--checkpoint`` the tool first trains the convergence rehearsal's
2,500-step weak-EM prior of seed 0 under ``--workdir`` (as the JAX tool).
The artifact (``--out``, by default ``CRF_TUNING_TORCH.json``, never the
JAX package's file) keeps the JAX tool's keys, and ``card`` (the card's
name and power limit) and ``platform`` (the torch device type); exit 1
when the contract fails (``pass``: a tune baseline of at least 0.30, at
least 50 settings, and a best at least as good as the VOC point's).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from em_adapt_torch.config import (
    CheckpointConfig, DataConfig, EvalConfig, ExperimentConfig, ModelConfig,
)
from em_adapt_torch.data.augment import preprocess_eval, resize_bilinear_np

SIZE = 129
NUM_CLASSES = 4
SEEDS = {"selection": 0, "tune": 555, "measurement": 777}
#: Steps and seed of the weak-EM prior trained when no checkpoint is given.
PRIOR_STEPS, PRIOR_SEED = 2500, 0

#: Stage A: bilateral sxy (the VOC 121 kept as the reference point) x
#: srgb x compat, in the JAX tool's order.
STAGE_A = tuple(itertools.product(
    (4.0, 8.0, 16.0, 32.0, 64.0, 121.0),  # crf_bi_sxy
    (3.0, 5.0, 10.0),                     # crf_bi_srgb
    (1.0, 3.0, 10.0),                     # crf_bi_compat
))


def stage_a_settings() -> list[dict]:
    return [dict(crf_bi_sxy=sxy, crf_bi_srgb=srgb, crf_bi_compat=compat)
            for sxy, srgb, compat in STAGE_A]


def stage_b_settings(best_a: dict) -> list[dict]:
    """The spatial kernel's sxy x compat, then 2 and 5 iterations, each
    at stage A's best bilateral kernel."""
    bi = {k: best_a[k] for k in ("crf_bi_sxy", "crf_bi_srgb", "crf_bi_compat")}
    out = [dict(bi, crf_g_sxy=g_sxy, crf_g_compat=g_compat)
           for g_sxy, g_compat in itertools.product((1.0, 2.0, 3.0, 5.0), (1.0, 3.0))]
    return out + [dict(bi, crf_iterations=iters) for iters in (2, 5)]


def task_config(crf_workers: int = 8) -> ExperimentConfig:
    """The rehearsal geometry (4 classes, 129x129, fc6 64, He init); the
    card CRF in one bucket of the task's image size (the default 512²
    bucket would pad 16 times the area), the host CRF on ``crf_workers``
    threads."""
    return ExperimentConfig(
        model=ModelConfig(num_classes=NUM_CLASSES, input_size=(SIZE, SIZE), fc6_channels=64,
                          init_scheme="he"),
        data=DataConfig(input_size=(SIZE, SIZE), num_workers=2),
        eval=EvalConfig(crf_bucket=(SIZE, SIZE), crf_buckets=(), crf_workers=crf_workers),
    )


def parse_checkpoint(spec: str) -> tuple[str, str]:
    """'DIR[:TAG]' -> (DIR, TAG), TAG "best" by default."""
    from em_adapt_torch.train.checkpoint import split_checkpoint

    return split_checkpoint(spec, "best")


def train_prior(workdir: str | None, device, log=print) -> tuple[str, str]:
    """The convergence rehearsal's weak-EM prior
    (``run_rehearsal(steps=2500, seed=0, refine_steps=0)``) under
    ``workdir/prior`` (a fresh temporary directory by default, kept);
    returns (its directory, "best")."""
    from em_adapt_torch.tools.convergence_rehearsal import run_rehearsal

    root = workdir or tempfile.mkdtemp(prefix="em_acc_prior_")
    save_dir = os.path.join(root, "prior")
    log(f"no --checkpoint: training the rehearsal prior ({PRIOR_STEPS} steps, seed "
        f"{PRIOR_SEED}) into {save_dir}")
    run_rehearsal(steps=PRIOR_STEPS, seed=PRIOR_SEED, refine_steps=0, save_dir=save_dir,
                  device=device, log=log)
    return save_dir, "best"


def load_model(cfg: ExperimentConfig, ckpt_dir: str, tag: str, device):
    """The model of ``cfg`` on ``device`` with the parameters of the latest
    ``tag`` checkpoint under ``ckpt_dir``; (model, the checkpoint's step)."""
    from em_adapt_torch.models.deeplab import build_model
    from em_adapt_torch.train.checkpoint import CheckpointManager

    model = build_model(cfg.model, cfg.train.seed, device)
    step = CheckpointManager(CheckpointConfig(save_dir=ckpt_dir)).restore_params(model, tag)
    return model, step


def check_lattice(device) -> None:
    """On the card the host CRF must run on the lattice, as in
    ``Evaluator.confusion_voc``: raise when it did not build."""
    from em_adapt_torch.eval import permutohedral

    if device.type == "cuda" and not permutohedral.available():
        raise RuntimeError(f"the permutohedral lattice did not build: "
                           f"{permutohedral.load_error()}")


def _collect_probs(ev, ds, cfg: ExperimentConfig) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(probs [H,W,C] f32, RGB [H,W,3] uint8, label [H,W])] for every image
    of ``ds``: the host branch of ``Evaluator.confusion_voc`` up to its
    CRF (batches of ``eval.batch_size``, the tail padded; each image's
    logits upsampled to its size on the TF1 grid; softmax)."""
    from em_adapt_torch.eval.predict import _pad_rows, _softmax_np

    bs = cfg.eval.batch_size
    out, pending = [], []

    def flush() -> None:
        if not pending:
            return
        logits = ev.logits(_pad_rows(np.stack([p[0] for p in pending]), bs)).cpu().numpy()
        for lg, (_, raw_img, raw_label) in zip(logits, pending):
            out.append((_softmax_np(resize_bilinear_np(lg, raw_label.shape[:2])), raw_img,
                        raw_label))
        pending.clear()

    for i in range(len(ds)):
        raw_img, raw_label = ds.load_raw(i)
        img, _ = preprocess_eval(raw_img, None, input_size=cfg.model.input_size)
        pending.append((img, raw_img, raw_label))
        if len(pending) == bs:
            flush()
    flush()
    return out


def _miou_for_setting(cached, eval_cfg: EvalConfig | None, num_classes: int,
                     workers: int = 1) -> tuple[float, list[float]]:
    """(mIoU, per-class IoU) of argmax(dense_crf(probs)) over ``cached``;
    ``eval_cfg`` None scores the probabilities themselves (no CRF)."""
    from em_adapt_torch.eval.crf import dense_crf
    from em_adapt_torch.eval.miou import ConfusionAccumulator, miou_from_confusion

    def one(item):
        probs, rgb, label = item
        q = probs if eval_cfg is None else dense_crf(probs, rgb, eval_cfg)
        return q.argmax(-1), label

    acc = ConfusionAccumulator(num_classes)
    with ThreadPoolExecutor(max(1, workers)) as pool:
        for pred, label in pool.map(one, cached):
            acc.update_host(pred, label)
    miou, iou = miou_from_confusion(acc.matrix())
    return float(miou), [float(v) for v in iou]


def run_tuning(ev, cfg: ExperimentConfig, *, tune_images: int = 48, val_images: int = 64,
               workers: int = 8, stage_a: list[dict] | None = None, stage_b=stage_b_settings,
               log=print) -> dict:
    """The sweep and the measurement of the artifact (no checkpoint,
    platform or card): stage A over ``stage_a`` (default
    :func:`stage_a_settings`), stage B over ``stage_b(best of A)``."""
    from em_adapt_torch.data.pipeline import LearnableSyntheticVOC

    size = cfg.model.input_size[0]
    t0 = time.time()
    tune_ds = LearnableSyntheticVOC(n=tune_images, num_classes=NUM_CLASSES, seed=SEEDS["tune"],
                                    category="val", image_size=size)
    log(f"caching {len(tune_ds)} tune-stream prob maps ...")
    tune = _collect_probs(ev, tune_ds, cfg)
    base_tune, base_tune_iou = _miou_for_setting(tune, None, NUM_CLASSES)
    log(f"tune baseline (no CRF): {base_tune:.4f}")

    def setting_cfg(**kw) -> EvalConfig:
        # The reference's VOC values (EvalConfig's defaults), overridden per point.
        return dataclasses.replace(EvalConfig(), **kw)

    sweep: list[dict] = []

    def probe(stage: str, kw: dict) -> None:
        miou, _ = _miou_for_setting(tune, setting_cfg(**kw), NUM_CLASSES, workers)
        rec = {"stage": stage, **kw, "tune_miou": round(miou, 4),
               "delta": round(miou - base_tune, 4)}
        sweep.append(rec)
        log(json.dumps(rec))

    for kw in stage_a_settings() if stage_a is None else stage_a:
        probe("A", kw)
    best_a = max((r for r in sweep if r["stage"] == "A"), key=lambda r: r["tune_miou"])
    for kw in stage_b(best_a):
        probe("B", kw)

    best = max(sweep, key=lambda r: r["tune_miou"])
    best_kw = {k: v for k, v in best.items() if k.startswith("crf_")}
    log(f"best tune setting: {best_kw} (tune mIoU {best['tune_miou']:.4f} vs {base_tune:.4f})")

    val_ds = LearnableSyntheticVOC(n=val_images, num_classes=NUM_CLASSES,
                                   seed=SEEDS["measurement"], category="val", image_size=size)
    val = _collect_probs(ev, val_ds, cfg)
    base_val, base_val_iou = _miou_for_setting(val, None, NUM_CLASSES)
    tuned_val, tuned_val_iou = _miou_for_setting(val, setting_cfg(**best_kw), NUM_CLASSES, workers)
    voc_val, voc_val_iou = _miou_for_setting(val, EvalConfig(), NUM_CLASSES, workers)
    voc_points = [r["tune_miou"] for r in sweep
                  if r.get("crf_bi_sxy") == 121.0 and r.get("crf_bi_srgb") == 5.0]
    result = {
        "task": "domain-tuned denseCRF sweep: select on a disjoint tune stream (seed 555), "
                "measure once on the untouched measurement stream (seed 777)",
        "tune_images": tune_images,
        "val_images": val_images,
        "input_size": size,
        "seeds": dict(SEEDS),
        "tune_baseline_miou": round(base_tune, 4),
        "tune_baseline_per_class_iou": [round(v, 4) for v in base_tune_iou],
        "sweep": sweep,
        "best_setting": best_kw,
        "best_tune_miou": best["tune_miou"],
        "measurement": {
            "f32_miou": round(base_val, 4),
            "f32_per_class_iou": [round(v, 4) for v in base_val_iou],
            "crf_tuned_miou": round(tuned_val, 4),
            "crf_tuned_per_class_iou": [round(v, 4) for v in tuned_val_iou],
            "crf_voc_miou": round(voc_val, 4),
            "crf_voc_per_class_iou": [round(v, 4) for v in voc_val_iou],
            "delta_tuned": round(tuned_val - base_val, 4),
            "delta_voc": round(voc_val - base_val, 4),
        },
        "positive_control": bool(tuned_val > base_val),
        "elapsed_sec": round(time.time() - t0, 1),
    }
    # The JAX tool's contract: the sweep really searched, and its best is
    # no worse than the VOC point on the tune stream.
    result["pass"] = bool(base_tune >= 0.30 and len(sweep) >= 50 and voc_points
                          and best["tune_miou"] >= max(voc_points))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None, metavar="DIR[:TAG]",
                    help="the port's checkpoint tree (tag 'best' by default), the rehearsal "
                         "geometry (4 classes, 129x129, fc6 64); default: train the prior")
    ap.add_argument("--tune-images", type=int, default=48)
    ap.add_argument("--val-images", type=int, default=64,
                    help="measurement stream size (accuracy_cost.py's protocol)")
    ap.add_argument("--workers", type=int, default=8, help="host CRF threads")
    ap.add_argument("--workdir", default=None,
                    help="without --checkpoint: where the prior is trained and kept")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms, no autotuning (device.py::"
                         "set_deterministic), before any model is built")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default="CRF_TUNING_TORCH.json")
    args = ap.parse_args(argv)

    from em_adapt_torch.device import resolve_device, set_deterministic
    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.tools.convergence_rehearsal import _card

    if args.deterministic:
        set_deterministic()
    device = resolve_device(args.device)
    check_lattice(device)
    log = lambda m: print(m, flush=True)  # noqa: E731
    if args.checkpoint:
        ckpt_dir, tag = parse_checkpoint(args.checkpoint)
    else:
        ckpt_dir, tag = train_prior(args.workdir, device, log)
    cfg = task_config(crf_workers=args.workers)
    model, step = load_model(cfg, ckpt_dir, tag, device)
    log(f"checkpoint {ckpt_dir}:{tag} step {step}")
    result = run_tuning(Evaluator(cfg, model), cfg, tune_images=args.tune_images,
                        val_images=args.val_images, workers=args.workers, log=log)
    result = {"checkpoint": {"dir": ckpt_dir, "tag": tag, "step": step}, **result,
              "platform": device.type, "card": _card(device),
              "deterministic": args.deterministic}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "sweep"}, indent=1))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
