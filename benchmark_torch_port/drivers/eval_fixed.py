"""The fixed-resolution evaluation window: ``Evaluator.confusion_fixed``.

The protocol that ``train`` runs every ``train.eval_every_steps`` (the
``train`` command's ``eval_fn``): each image scored at the network's input
size against its label at that size, the upsample and argmax on the card,
no CRF. Set-up makes the weights on the card from the seed, builds the
port's model and ``Evaluator``, and a device-resident pool of
``pool_batches`` batches of ``eval.batch_size`` images with their labels
at the input size (``traffic.py::train_pool``), and warms up with one pass.
A pass is one ``confusion_fixed`` call over ``pass_batches`` batches, the
pool's in turn (a validation split's worth: VOC 2012 val's 1,449 images
at batch 6), ended by the confusion matrix's copy to the host, as the
``train`` command's ``eval_fn`` makes one call over the split. The window
makes passes until ``--seconds`` have passed. Benchmark-side hooks keep,
in the window's first pass only, each batch's labels (what
``predict_batch`` returns, held as they are: no kernel is added) and the
logits of ``compare_batches`` batches drawn from the seed; the warm-up
pass keeps the same, so that the first pass reuses the allocator's
blocks. Those labels are counted against the pool's after the clock
stops. With ``--trace 1`` one shorter pass of ``trace_batches`` batches
runs under ``torch.profiler`` (``harness.read_trace`` names each idle gap
by a scan of the host's events, which grows with the square of the
trace's events), so the traced span holds one end-of-pass copy to the
host a ``trace_batches`` batches, where the window holds one a pass; the
records give the traced span's idle before its first device event and
after its last (``trace_edges_s``), the pass's start and its end.

The comparison, after the window:

* ``logits_gap``: the network. The worst of ``compare_batches`` kept
  batches' ||program - reference|| over ||reference|| of the logits, the
  reference's network (``reference/model.py``) in float32 on the same
  images;
* ``label_gap``: the upsample and argmax. Among the pixels where the
  reference's two largest upsampled logits (TF1 bilinear to the input
  size) lie more than ``label_margin`` times the image's largest |logit|
  apart, a gap that bf16's rounding of the network does not cross, the
  share whose program label is not the reference's;
* ``confusion_gap``: the entries by which the window's first
  ``confusion_fixed`` matrix differs from the benchmark's own count of the
  labels the program returned in that pass against the pool's labels
  (exact: 0).
"""

from __future__ import annotations

import gc
import time

import numpy as np

import harness
import trace_ranges
import weights as weights_mod
from reference import crf as ref_crf
from reference import model as ref


def inputs(ctx):
    """The run's configuration, weights (OIHW) and pool of batches."""
    import traffic as traffic_mod

    cfg = ctx.experiment_config()
    c = cfg.model.num_classes
    widths = dict(num_classes=c, fc6_channels=cfg.model.fc6_channels,
                  width=cfg.model.width_multiplier)
    params = weights_mod.make(ctx.traffic["weights"], ctx.seed, ctx.device, **widths)
    pool = traffic_mod.train_pool(ctx.traffic, input_size=cfg.model.input_size, label_size=None,
                                  batch=cfg.eval.batch_size, num_classes=c, seed=ctx.seed,
                                  device=ctx.device)
    return cfg, params, pool


def count(labels: list, pool: list, c: int):
    """The [C, C] int64 confusion of labels (one tensor a batch, the pool's
    in turn from its first) against the pool's, on the device: rows the
    true class, void and out-of-range entries left out."""
    import torch

    counted = torch.zeros(c * c, dtype=torch.int64, device=labels[0].device)
    for i, pred in enumerate(labels):
        gt = pool[i % len(pool)]["label"][..., 0].reshape(-1).long()
        p = pred.reshape(-1).long()
        ok = (gt < c) & (p < c)
        counted += torch.bincount(gt[ok] * c + p[ok], minlength=c * c)
    return counted.reshape(c, c)


def run(ctx) -> dict:
    import torch

    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.models.registry import get_model

    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    ctx.mark("imports")
    cfg, params, pool = inputs(ctx)
    ctx.mark("weights and batches")
    c = cfg.model.num_classes
    model = get_model(cfg.model.name)(cfg.model).to(ctx.device)
    model.load_params(weights_mod.hwio(params))
    ev = Evaluator(cfg, model)
    ctx.mark("model")

    n = ctx.traffic["pass_batches"]
    picks = set(sample(ctx, n, ctx.traffic["compare_batches"]))
    labels, kept, state = [], {}, {"keep": False, "batch": 0}
    predict = ev.predict_batch

    def keep_logits(module, args, out):
        if state["keep"] and state["batch"] in picks:
            kept[state["batch"]] = out.detach().clone()

    def keep_labels(images):
        pred = predict(images)
        if state["keep"]:
            labels.append(pred)
        state["batch"] += 1
        return pred

    hook = model.register_forward_hook(keep_logits)
    ev.predict_batch = keep_labels

    def one_pass(batches: int = n, keep: bool = False) -> np.ndarray:
        state["batch"], state["keep"] = 0, keep
        try:
            return ev.confusion_fixed(harness.Feed(pool, 0, limit=batches))
        finally:
            state["keep"] = False

    # Warm-up: one pass, the shapes and the kept tensors the window repeats.
    one_pass(keep=True)
    sync()
    labels.clear()
    kept.clear()
    ctx.mark("warm-up")

    # The window; its first pass keeps its labels and sampled logits.
    setup_s = harness.seconds_since_process_start()
    t0 = time.perf_counter()
    first = one_pass(keep=True)
    passes = 1
    while time.perf_counter() - t0 < ctx.seconds:
        one_pass()
        passes += 1
    sync()
    wall = time.perf_counter() - t0
    images = passes * sum(pool[i % len(pool)]["image"].shape[0] for i in range(n))
    e2e = {"setup_s": setup_s, "eval_images_per_s": images / wall}
    h_in, w_in = cfg.model.input_size
    records = {"kind": "eval", "window_s": wall, "images": images, "input_size": (h_in, w_in),
               "num_classes": c, "batch": cfg.eval.batch_size, "trace": None}
    ctx.log(f"window: {images} images in {passes} passes, {wall:.3f} s")

    if ctx.trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                one_pass(ctx.traffic["trace_batches"])
                sync()
        with trace_ranges.Saved(prof) as saved:
            records["trace"] = harness.read_trace(saved, "bench.window")
            records["trace_edges_s"] = trace_ranges.edge_idle_s(saved.events, "bench.window")
        if records["trace"] and records["trace_edges_s"]:
            tr = records["trace"]
            head, tail = records["trace_edges_s"]
            ctx.log(f"traced pass: {tr['window_s']:.4f} s, busy {tr['busy_s']:.4f} s, idle "
                    f"{tr['window_s'] - tr['busy_s']:.4f} s, of it {head:.4f} s before the "
                    f"first device event and {tail:.4f} s after the last")
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    # The comparison, after the program's model is freed.
    hook.remove()
    counted = count(labels, pool, c).cpu().numpy()
    kept = {b: (z, labels[b]) for b, z in kept.items()}
    del ev, model, predict, labels
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(ctx, params, pool, kept)
    readings["confusion_gap"] = int(np.abs(counted - first).sum())
    ctx.log(f"comparison: {time.perf_counter() - t_ref:.2f} s")
    checks = [(name, readings[name], ctx.limits.get(name)) for name in ctx.limits]
    return {"e2e": e2e, "attempted": images, "failed": 0, "records": records, "checks": checks,
            "readings": readings, "memory_peak_bytes": peak}


def sample(ctx, n: int, k: int) -> list[int]:
    """``k`` of the indices below ``n`` (all where ``k`` >= ``n``), drawn
    from the seed, in order."""
    rng = np.random.default_rng([ctx.seed, 0x5A4])
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def label_gap(z_ref, labels, margin: float) -> tuple[int, int]:
    """(pixels whose program label differs from the reference's, pixels
    considered) of a batch: the reference's logits [B,h,w,C] upsampled to
    the labels' [B,H,W], where its top two lie more than ``margin`` times
    the image's largest |logit| apart."""
    import torch

    wrong = considered = 0
    for z, lab in zip(z_ref, labels):
        up = ref_crf.resize_bilinear(z, tuple(lab.shape))
        top = up.topk(2, -1).values
        sure = (top[..., 0] - top[..., 1]) > margin * z.abs().amax()
        wrong += int((sure & (up.argmax(-1) != lab.to(torch.int64))).sum())
        considered += int(sure.sum())
    return wrong, considered


def compare(ctx, params, pool, kept) -> dict:
    import torch

    ref.exact_float32()
    tr = ctx.traffic
    logits_gap, wrong, considered = 0.0, 0, 0
    keys = sorted(kept)
    for key in keys:
        z_p, lab_p = kept[key]
        with torch.no_grad():
            z_r = ref.forward(params, pool[key % len(pool)]["image"])
        logits_gap = max(logits_gap, float((z_p.float() - z_r).norm() / z_r.norm()))
        w, n = label_gap(z_r, lab_p, tr["label_margin"])
        wrong, considered = wrong + w, considered + n
    pixels = sum(kept[k][1].numel() for k in keys)
    return {"logits_gap": logits_gap, "label_gap": wrong / max(considered, 1),
            "label_considered_share": considered / max(pixels, 1), "compared": len(keys)}


def control_readings(ctx) -> dict:
    """The control's readings: the reference in fp8 put in the program's
    place, against the reference in float32, on as many batches of the
    pool as a run compares, drawn from the seed."""
    import torch

    ref.exact_float32()
    cfg, params, pool = inputs(ctx)
    tr = ctx.traffic
    logits_gap, wrong, considered, pixels = 0.0, 0, 0, 0
    for i in sample(ctx, len(pool), tr["compare_batches"]):
        image = pool[i]["image"]
        with torch.no_grad():
            z_r = ref.forward(params, image)
            z_q = ref.forward(params, image, quant=True)
        logits_gap = max(logits_gap, float((z_q - z_r).norm() / z_r.norm()))
        size = tuple(image.shape[1:3])
        low = torch.stack([ref_crf.resize_bilinear(z, size).argmax(-1) for z in z_q])
        w, n = label_gap(z_r, low, tr["label_margin"])
        wrong, considered, pixels = wrong + w, considered + n, pixels + low.numel()
    return {"logits_gap": logits_gap, "label_gap": wrong / max(considered, 1),
            "label_considered_share": considered / max(pixels, 1)}
