"""The VOC-protocol evaluation window: ``Evaluator.confusion_voc``.

Set-up makes the weights on the card from the seed, builds the port's
model and ``Evaluator``, makes the traffic's images (host arrays at their
own sizes, as a dataset hands them over) and warms up with one pass. The
window passes the whole set to ``confusion_voc`` again and again until
``--seconds`` have passed: every window scores the same sizes whatever
the seed, and each pass ends as a pass over a dataset ends, its partial
bucket batches flushed. A benchmark-side span, the host clock around
each ``voc_post_device`` call on the evaluator, times the post-process
(the call ends in a copy of the labels to the host) and keeps each
image's logits and labels for the comparison. With ``--trace 1`` one
more pass runs under ``torch.profiler``.

The comparison, after the window, on a sample of ``compare_images`` of
the window's images drawn from the seed, in two stages:

* ``logits_gap``: the network. The worst sampled image's ||program -
  reference|| over ||reference|| of the logits, the reference's network
  in float32 on the image as the protocol resizes it;
* ``label_gap``: the post-process (upsample, softmax, CRF, argmax, in
  float32), which the reference follows from the program's own logits:
  the CRF's mean field turns near-ties of the logits into whole regions
  of either label, so labels from the reference's own logits would
  differ by a whole marginal wherever bf16 moved a tie. The widest gap,
  over the sampled images' pixels, by which the reference's CRF marginal
  of the program's label lies below its best;
* ``confusion_gap``: the entries by which the confusion matrices
  ``confusion_voc`` returned differ from the one the benchmark counts from
  the labels it returned and the masks (exact: 0).
"""

from __future__ import annotations

import gc
import time

import numpy as np

import harness
import weights as weights_mod
from reference import crf as ref_crf
from reference import model as ref


def inputs(ctx):
    """The run's configuration, weights (OIHW) and images."""
    import traffic as traffic_mod

    cfg = ctx.experiment_config()
    c = cfg.model.num_classes
    widths = dict(num_classes=c, fc6_channels=cfg.model.fc6_channels,
                  width=cfg.model.width_multiplier)
    params = weights_mod.make(ctx.traffic["weights"], ctx.seed, ctx.device, **widths)
    data = traffic_mod.EvalImages(ctx.traffic, num_classes=c, seed=ctx.seed, device=ctx.device)
    return cfg, params, data


def run(ctx) -> dict:
    import torch

    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.models.registry import get_model

    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    ctx.mark("imports")
    cfg, params, data = inputs(ctx)
    ctx.mark("weights and images")
    c = cfg.model.num_classes
    model = get_model(cfg.model.name)(cfg.model).to(ctx.device)
    model.load_params(weights_mod.hwio(params))
    ev = Evaluator(cfg, model)
    ctx.mark("model")
    where = {id(img): i for i, img in enumerate(data.images)}

    spans, kept, state = [], {}, {"pass": -1}
    post = ev.voc_post_device

    def timed_post(logits, raw_imgs, bucket):
        t0 = time.perf_counter()
        labels = post(logits, raw_imgs, bucket)
        spans.append((time.perf_counter() - t0, [img.shape[:2] for img in raw_imgs]))
        if state["pass"] >= 0:
            for i, img in enumerate(raw_imgs):
                h, w = img.shape[:2]
                kept[(state["pass"], where[id(img)])] = (logits[i].clone(),
                                                           labels[i, :h, :w].copy())
        return labels

    ev.voc_post_device = timed_post

    # Warm-up: one pass, the shapes (and bucket batches) the window repeats.
    ev.confusion_voc(data)
    sync()
    spans.clear()
    ctx.mark("warm-up")

    # The window.
    setup_s = harness.seconds_since_process_start()
    t0 = time.perf_counter()
    confusion = np.zeros((c, c), np.int64)
    passes = 0
    while passes == 0 or time.perf_counter() - t0 < ctx.seconds:
        state["pass"] = passes
        confusion += ev.confusion_voc(data)
        passes += 1
    sync()
    wall = time.perf_counter() - t0
    state["pass"] = -1
    images = passes * len(data)
    window_spans = list(spans)
    e2e = {"setup_s": setup_s, "eval_images_per_s": images / wall}
    h_in, w_in = cfg.model.input_size
    records = {"kind": "eval", "window_s": wall, "images": images, "post_spans": window_spans,
               "input_size": (h_in, w_in), "num_classes": c, "batch": cfg.eval.batch_size,
               "crf_iterations": cfg.eval.crf_iterations, "crf_bi_sxy": cfg.eval.crf_bi_sxy,
               "crf_bi_srgb": cfg.eval.crf_bi_srgb, "trace": None}
    ctx.log(f"window: {images} images in {passes} passes, {wall:.3f} s; post-process "
            f"{sum(s for s, _ in window_spans):.3f} s in {len(window_spans)} calls")

    if ctx.trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                ev.confusion_voc(data)
                sync()
        records["trace"] = harness.read_trace(prof, "bench.window")
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    # The comparison, after the program's model is freed.
    del ev, model, post
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(ctx, cfg, params, data, kept, confusion, passes)
    ctx.log(f"comparison: {time.perf_counter() - t_ref:.2f} s")
    checks = [(name, readings[name], ctx.limits.get(name)) for name in ctx.limits]
    return {"e2e": e2e, "attempted": images, "failed": 0, "records": records, "checks": checks,
            "readings": readings, "memory_peak_bytes": peak}


def sample(ctx, kept: dict, n: int) -> list:
    keys = sorted(kept)
    rng = np.random.default_rng([ctx.seed, 0x5A3])
    return [keys[i] for i in sorted(rng.choice(len(keys), size=min(n, len(keys)),
                                               replace=False))]


def reference_logits(cfg, params, img: np.ndarray, quant: bool = False):
    """The reference network's logits [h,w,C] of one image."""
    import torch

    dev = params["fc8"]["w"].device
    x = torch.from_numpy(np.ascontiguousarray(
        ref_crf.network_input(img, cfg.model.input_size)))[None].to(dev)
    with torch.no_grad():
        return ref.forward(params, x, quant=quant)[0]


def post_process(cfg, logits, img: np.ndarray, dtype=None):
    """The reference's post-process of logits [h,w,C]: upsampled to the
    image's size, softmax, CRF; the marginals [H,W,C] (computed in
    ``dtype``, default float32)."""
    import torch

    e = cfg.eval
    dtype = dtype or torch.float32
    with torch.no_grad():
        up = ref_crf.resize_bilinear(logits, img.shape[:2]).to(dtype)
        return ref_crf.dense_crf(torch.softmax(up, -1), torch.from_numpy(img).to(logits.device),
                                 bi_sxy=e.crf_bi_sxy, bi_srgb=e.crf_bi_srgb,
                                 bi_compat=e.crf_bi_compat, g_sxy=e.crf_g_sxy,
                                 g_compat=e.crf_g_compat, iterations=e.crf_iterations,
                                 dtype=dtype)


def _label_gap(q, labels) -> float:
    import torch

    lab = torch.as_tensor(np.asarray(labels, np.int64)).to(q.device)
    return float((q.amax(-1) - q.gather(-1, lab[..., None])[..., 0]).amax())


def compare(ctx, cfg, params, data, kept, confusion, passes) -> dict:
    import torch

    ref.exact_float32()
    c = cfg.model.num_classes
    counted = np.zeros((c, c), np.int64)
    for p in range(passes):
        for i in range(len(data)):
            labels = kept[(p, i)][1]
            gt = data.labels[i].reshape(-1).astype(np.int64)
            pred = labels.reshape(-1).astype(np.int64)
            ok = (gt < c) & (pred < c)
            counted += np.bincount(gt[ok] * c + pred[ok], minlength=c * c).reshape(c, c)
    logits_gap = label_gap = 0.0
    keys = sample(ctx, kept, ctx.traffic["compare_images"])
    for key in keys:
        z_p, lab_p = kept[key]
        img = data.images[key[1]]
        z_r = reference_logits(cfg, params, img)
        logits_gap = max(logits_gap, float((z_p.float() - z_r).norm() / z_r.norm()))
        label_gap = max(label_gap, _label_gap(post_process(cfg, z_p.float(), img), lab_p))
    return {"logits_gap": logits_gap, "label_gap": label_gap,
            "confusion_gap": int(np.abs(counted - confusion).sum()),
            "compared": len(keys)}


def control_readings(ctx) -> dict:
    """The control's readings: the reference in fp8 put in the program's
    place, against the reference in float32, on as many images of the set
    as a run compares, drawn from the seed."""
    cfg, params, data = inputs(ctx)
    keys = sample(ctx, {(0, i): None for i in range(len(data))}, ctx.traffic["compare_images"])
    return control(ctx, cfg, params, data, [i for _, i in keys])


def control(ctx, cfg, params, data, keys) -> dict:
    """The control of each stage: the network in fp8 (one below its bf16)
    against the float32 reference's logits; the post-process in bfloat16
    (one below its float32) on the reference's logits, its labels against
    the float32 post-process's marginals."""
    import torch

    ref.exact_float32()
    logits_gap = label_gap = 0.0
    for i in keys:
        img = data.images[i]
        z_r = reference_logits(cfg, params, img)
        z_q = reference_logits(cfg, params, img, quant=True)
        logits_gap = max(logits_gap, float((z_q - z_r).norm() / z_r.norm()))
        low = post_process(cfg, z_r, img, torch.bfloat16).argmax(-1).cpu().numpy()
        label_gap = max(label_gap, _label_gap(post_process(cfg, z_r, img), low))
    return {"logits_gap": logits_gap, "label_gap": label_gap}
