"""What int8 and the dense CRF cost or gain in mIoU on a trained checkpoint.

    python -m em_adapt_torch.tools.accuracy_cost [--checkpoint DIR[:TAG]] [--val-images N]
        [--streams N] [--tuning PATH] [--workdir DIR] [--deterministic] [--device DEV]
        [--out PATH]

The port's counterpart of ``tools/accuracy_cost.py``, with its arms, names,
streams and contracts. One checkpoint of the rehearsal geometry
(``crf_tuning.py::task_config``: 4 classes, 129x129, fc6 64) is scored by
the VOC protocol (``Evaluator.evaluate_voc``, each image at its own size)
in these arms:

* ``f32``: the model as trained, no CRF;
* ``int8``: ``eval/quantize.py::quantize_model``, calibrated on one batch
  of 8 images of seed 778, a stream disjoint from every measured one;
* ``crf_host``: the reference's VOC CRF (reference network.py:63) on the
  host, the permutohedral lattice on 8 threads;
* ``crf_tpu``: the same CRF on the model's device (``eval.crf_impl=
  "tpu"``, the port's name for ``eval/crf_device.py`` on the card), one
  bucket of 129x129;
* with the tuning artifact's ``best_setting`` (``--tuning``, by default
  ``CRF_TUNING_TORCH.json``; skipped when it is absent): ``crf_tuned``,
  ``int8_crf_tuned`` (the int8 model and the tuned CRF) and
  ``crf_tuned_tpu`` (the tuned CRF on the device).

Every arm runs on ``--streams`` disjoint val streams of ``--val-images``
``LearnableSyntheticVOC`` images, seeds 777 + 1000·k (at most 9: the t
table stops there), so each delta against ``f32`` carries a mean and a
95% interval (:func:`_interval`). Without ``--checkpoint`` the tool trains
the convergence rehearsal's 2,500-step weak-EM prior of seed 0 under
``--workdir`` first (``crf_tuning.py::train_prior``). The artifact
(``--out``, by default ``ACCURACY_COST_TORCH.json``, never the JAX
package's file) keeps the JAX tool's keys (the first stream's arms at the
top level, ``per_stream``, ``f32_miou_stats``, ``delta_stats``, ``pass``)
and adds ``card`` (the card's name and power limit) and ``platform`` (the
torch device type); exit 1 when the contract fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np

from em_adapt_torch.tools.crf_tuning import (
    NUM_CLASSES, check_lattice, load_model, parse_checkpoint, task_config, train_prior,
)

#: Two-sided 97.5% Student-t quantiles by degrees of freedom (n - 1).
_T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365, 8: 2.306}
#: The calibration stream's seed and the first measurement stream's.
CALIB_SEED, FIRST_SEED = 778, 777


def _interval(values: list[float]) -> dict:
    """Mean, sample std and the 95% t-interval's half width of ``values``
    (None for a single value), rounded as the JAX tool rounds them."""
    n = len(values)
    mean = sum(values) / n
    if n == 1:
        return {"mean": round(mean, 4), "std": 0.0, "ci95_half": None,
                "n": 1, "values": [round(v, 4) for v in values]}
    var = sum((v - mean) ** 2 for v in values) / (n - 1)
    std = math.sqrt(var)
    half = _T975[n - 1] * std / math.sqrt(n)
    return {"mean": round(mean, 4), "std": round(std, 5),
            "ci95_half": round(half, 4), "n": n,
            "values": [round(v, 4) for v in values]}


def calibration_batch(cfg) -> np.ndarray:
    """The int8 calibration batch: 8 "val" images of seed 778 through the
    eval pipeline (``batch_iterator``, ``train=False``)."""
    from em_adapt_torch.data.pipeline import LearnableSyntheticVOC, batch_iterator

    ds = LearnableSyntheticVOC(n=8, num_classes=NUM_CLASSES, seed=CALIB_SEED, category="val",
                               image_size=cfg.model.input_size[0])
    it = batch_iterator(ds, cfg.data, batch_size=8, seed=0, epochs=1, train=False)
    try:
        return next(it)["image"]
    finally:
        it.close()


def build_arms(cfg, model, calib: np.ndarray, tuned_kw: dict | None = None) -> dict:
    """{arm: fn(dataset) -> (mIoU, per-class IoU)} in the JAX tool's order."""
    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.eval.quantize import quantize_model

    def on_card(c):
        return c.replace(eval=dataclasses.replace(c.eval, crf_impl="tpu"))

    qmodel = quantize_model(cfg.model, model, [calib])
    ev, ev_q, ev_card = Evaluator(cfg, model), Evaluator(cfg, qmodel), Evaluator(on_card(cfg), model)
    arms = {
        "f32": lambda ds: ev.evaluate_voc(ds, use_crf=False),
        "int8": lambda ds: ev_q.evaluate_voc(ds, use_crf=False),
        "crf_host": lambda ds: ev.evaluate_voc(ds, use_crf=True),
        "crf_tpu": lambda ds: ev_card.evaluate_voc(ds, use_crf=True),
    }
    if tuned_kw is not None:
        tuned = cfg.replace(eval=dataclasses.replace(cfg.eval, **tuned_kw))
        ev_t, ev_qt = Evaluator(tuned, model), Evaluator(tuned, qmodel)
        ev_tc = Evaluator(on_card(tuned), model)
        arms["crf_tuned"] = lambda ds: ev_t.evaluate_voc(ds, use_crf=True)
        arms["int8_crf_tuned"] = lambda ds: ev_qt.evaluate_voc(ds, use_crf=True)
        arms["crf_tuned_tpu"] = lambda ds: ev_tc.evaluate_voc(ds, use_crf=True)
    return arms


def measure(arms: dict, seeds: list[int], val_images: int, size: int, log=print) -> list[dict]:
    """Every arm on every stream: [{seed, arms: {arm: {miou, per_class_iou,
    elapsed_sec}}, deltas: {arm: mIoU - f32's}}]."""
    from em_adapt_torch.data.pipeline import LearnableSyntheticVOC

    per_stream = []
    for seed in seeds:
        ds = LearnableSyntheticVOC(n=val_images, num_classes=NUM_CLASSES, seed=seed,
                                   category="val", image_size=size)
        got = {}
        for name, fn in arms.items():
            t0 = time.time()
            miou, iou = fn(ds)
            got[name] = {"miou": round(float(miou), 4),
                         "per_class_iou": [round(float(v), 4) for v in iou],
                         "elapsed_sec": round(time.time() - t0, 1)}
        base = got["f32"]["miou"]
        deltas = {k: round(got[k]["miou"] - base, 4) for k in got if k != "f32"}
        per_stream.append({"seed": seed, "arms": got, "deltas": deltas})
        log(f"stream seed={seed}: f32={base:.4f} deltas={deltas}")
    return per_stream


def summarize(per_stream: list[dict]) -> dict:
    """The artifact's measured part: the first stream's arms at the top
    level, the per-stream table, the interval statistics and ``pass``."""
    names = [k for k in per_stream[0]["arms"] if k != "f32"]
    delta_stats = {k: _interval([s["deltas"][k] for s in per_stream]) for k in names}
    f32_stats = _interval([s["arms"]["f32"]["miou"] for s in per_stream])
    first = per_stream[0]
    result = {
        "arms": first["arms"],
        "deltas_vs_f32": first["deltas"],
        "per_stream": per_stream,
        "f32_miou_stats": f32_stats,
        "delta_stats": delta_stats,
    }
    # The JAX tool's contract (l.260-275): a trained model on every stream,
    # a mean int8 cost of at most 2 points, and the host and device CRFs
    # within 0.015 on the mean and 0.02 on every stream.
    result["pass"] = bool(
        min(f32_stats["values"]) >= 0.30
        and delta_stats["int8"]["mean"] >= -0.02
        and abs(delta_stats["crf_host"]["mean"] - delta_stats["crf_tpu"]["mean"]) <= 0.015
        and all(abs(s["arms"]["crf_host"]["miou"] - s["arms"]["crf_tpu"]["miou"]) <= 0.02
                for s in per_stream)
    )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=None, metavar="DIR[:TAG]",
                    help="the port's checkpoint tree (tag 'best' by default), the rehearsal "
                         "geometry (4 classes, 129x129, fc6 64); default: train the prior")
    ap.add_argument("--val-images", type=int, default=64)
    ap.add_argument("--streams", type=int, default=5,
                    help="disjoint val streams (seeds 777, 1777, ...) the deltas average over")
    ap.add_argument("--tuning", default="CRF_TUNING_TORCH.json",
                    help="CRF tuning artifact whose best_setting adds the tuned arms "
                         "(skipped if the file is absent)")
    ap.add_argument("--workdir", default=None,
                    help="without --checkpoint: where the prior is trained and kept")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms, no autotuning (device.py::"
                         "set_deterministic), before any model is built")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default="ACCURACY_COST_TORCH.json")
    args = ap.parse_args(argv)
    if not 1 <= args.streams <= 9:
        ap.error("--streams must be in 1..9")

    from em_adapt_torch.device import resolve_device, set_deterministic
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
    cfg = task_config()
    model, step = load_model(cfg, ckpt_dir, tag, device)
    log(f"checkpoint {ckpt_dir}:{tag} step {step}")
    tuned_kw = None
    if args.tuning and os.path.exists(args.tuning):
        with open(args.tuning) as f:
            tuned_kw = json.load(f)["best_setting"]
        log(f"crf_tuned arms from {args.tuning}: {tuned_kw}")
    arms = build_arms(cfg, model, calibration_batch(cfg), tuned_kw)
    seeds = [FIRST_SEED + 1000 * k for k in range(args.streams)]
    t0 = time.time()
    per_stream = measure(arms, seeds, args.val_images, cfg.model.input_size[0], log)
    result = {
        "task": "accuracy-cost on a TRAINED checkpoint (LearnableSyntheticVOC val, exact VOC "
                f"protocol, {args.streams} disjoint streams)",
        "checkpoint": {"dir": ckpt_dir, "tag": tag, "step": step},
        "tuning": {"path": args.tuning, "best_setting": tuned_kw},
        "val_images": args.val_images,
        "input_size": cfg.model.input_size[0],
        "streams": args.streams,
        "seeds": seeds,
        **summarize(per_stream),
        "elapsed_sec": round(time.time() - t0, 1),
        "platform": device.type,
        "card": _card(device),
        "deterministic": args.deterministic,
    }
    result["pass"] = result.pop("pass")  # last, as in the JAX artifact
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("arms", "per_stream")},
                     indent=1))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
