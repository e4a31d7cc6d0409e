#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--quick] [--profile N]

Run from the root of a checkout. It builds the CUDA kernels from the
checkout's sources and K3's per-part variants (one nvcc per library, in
parallel), holds each against its plain PyTorch version on the card,
times K3 part by part (``em_adapt_torch/tools/bench_block1_bwd_parts.py``),
and drives the port's paths: full-width DeepLab-LargeFOV training at
321x321, batch 6, accumulation 5, through ``Trainer.fit`` in f32 (the
E-step kernel K1) and in bf16 (K1, the fused block1 forward K2 and
backward K3), batches copied through ``DevicePrefetcher``; the input
layer (the producer alone, ``fit`` with and without the prefetcher, and
``convert``, ``train`` and ``eval`` on a VOC-layout tree it writes); the
loop at three log cadences on cached batches (wall, busy share, host
syncs outside the cadences); the training variants through the command
line (tag warm-up, semi-supervision, LR groups, periodic eval with
"best", a warm start) and He init in f32 and bf16; and
the bf16 fixed-resolution evaluation at 321x321, eval batch 6, through
``Evaluator.evaluate_fixed`` (K2), then checks what comes out. Every
phase raises on failure and the script then exits non-zero; without a
CUDA card, or without the ``em_adapt_torch`` package beside it, it exits
non-zero before printing any result. ``--quick``
stops after the kernel checks; ``--profile N`` adds a torch.profiler
breakdown of N more training steps.

Output: the card's name and power limit, the builds, each kernel's check
and times, the training and evaluation numbers, then a line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
try:  # the card's peaks and the timers, shared with the port's tools
    from em_adapt_torch.utils.timing import (
        BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S, SIMT_OPS_PER_S, cuda_ms, cuda_ms_per_launch,
    )
except ImportError as e:  # main() refuses to run without the port beside this file
    PORT_MISSING: ImportError | None = e
else:
    PORT_MISSING = None

#: Training steps of the main path: two applied updates at accumulation 5.
STEPS = 10
#: Images of the evaluation path: 11 batches of 6, the last one padded.
EVAL_IMAGES = 62
#: K3's milliseconds per launch at B=6, 321x321 while each later tile
#: read, added and wrote back its CTA's partial row and loaded its own x
#: and dy: 1.7090 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
K3_READ_ADD_WRITE_MS = 1.7090
#: K2's milliseconds per launch at B=6, 321x321 while its four phases ran
#: one after another in all 16 warps of a CTA: 0.4690 on an NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md §6).
K2_SERIAL_MS = 0.4690
#: K2's cases (name, batch, size, large bias; seed 10 * size + batch). On a
#: 132-SM card: B=1 33^2 has 9 tiles of 7 x 8 pooled outputs, so every CTA
#: owns one; B=1 161^2 exactly 132; B=1 177^2 156, 24 CTAs with two; B=3
#: 99^2 168, its last tile row one pooled row deep and its last tile column
#: two wide. Every size but 161 and 321 has ragged last rows and columns.
K2_CASES = (("B=6 321x321", 6, 321, False), ("B=1 33x33", 1, 33, False),
            ("B=1 41x41", 1, 41, False), ("B=1 65x65", 1, 65, False),
            ("B=2 41x41 large bias", 2, 41, True), ("B=1 161x161", 1, 161, False),
            ("B=1 177x177", 1, 177, False), ("B=3 99x99", 3, 99, False))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def profiled_kernel_ms(fn, kernel: str, launches: int) -> float | None:
    """Device milliseconds per launch of the device kernel whose name holds
    ``kernel``, over ``launches`` calls of ``fn`` under torch.profiler;
    None when the profiler records no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel in e.key and e.count:
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            return dev_us / 1e3 / e.count if dev_us > 0 else None
    return None


def realistic_batch(rng: np.random.Generator, b: int, hw: int = 41, c: int = 21):
    """Score maps with VOC-like tags: background plus 1-3 foreground
    classes in rectangles, a void band on top."""
    scores = rng.normal(size=(b, hw, hw, c)).astype(np.float32) * 3.0
    label = np.zeros((b, hw, hw), np.float32)
    for i in range(b):
        for cls in rng.choice(np.arange(1, c), size=rng.integers(1, 4), replace=False):
            y0, x0 = rng.integers(0, hw - 8, size=2)
            y1, x1 = y0 + rng.integers(6, hw - y0 + 1), x0 + rng.integers(6, hw - x0 + 1)
            label[i, y0:y1, x0:x1] = cls
        label[i, : rng.integers(0, 5)] = 255.0
    orders = np.stack([rng.permutation(np.arange(1, c)) for _ in range(5)]).astype(np.int32)
    return scores, label, orders


#: K1's edge cases (``k1_edge_case``) and their score-map sizes: HW 49 and
#: 512 run the one-pixel-a-thread instance, 600 and 1024 the two-pixel
#: one, 1681 (41x41, the training path's) the four-pixel one.
K1_EDGE_CASES = ("ties", "zero_diffs", "subnormal", "inf", "k0", "k_last", "void_rows")
K1_EDGE_SIZES = ((7, 7), (16, 32), (20, 30), (32, 32), (41, 41))
#: The E-step's keywords on the training path (the reference recipe).
K1_RECIPE = dict(bg_p=0.4, fg_p=0.2, num_iter=5, suppress_others=True, margin_others=1e-5)


def k1_edge_case(name: str, h: int, w: int):
    """NHWC scores, labels, orders and E-step keywords of one K1 edge case,
    B=2, C=5, two rounds of visits, made from a seed:
    ``ties`` integer scores 0..3 (many diffs equal the k-th); ``zero_diffs``
    background the max everywhere (every background diff 0); ``subnormal``
    scores below 1e-38; ``inf`` a power of two of pixels where class 1
    scores 2^106 and class 2 -FLT_MAX, so class 2's diff overflows to +inf
    there (their sum, a power of two times 2^106, swallows every other
    score's and stays exact times 1/HW, so the final shift is exactly 0 in
    any summation order, with or without a fused multiply-add);
    ``k0`` and ``k_last`` ranks 0 and HW-1; ``void_rows`` void label rows
    and a second image with no tag at all."""
    hw = h * w
    rng = np.random.default_rng([K1_EDGE_CASES.index(name), hw])
    b, c = 2, 5
    scores = rng.normal(size=(b, h, w, c)).astype(np.float32)
    label = rng.integers(0, c, size=(b, h, w)).astype(np.float32)
    label.reshape(b, -1)[:, :c] = np.arange(c)  # every class present
    kw = dict(bg_p=0.4, fg_p=0.2, num_iter=2, suppress_others=True, margin_others=1e-5)
    if name == "ties":
        scores = rng.integers(0, 4, size=scores.shape).astype(np.float32)
    elif name == "zero_diffs":
        scores[..., 0] += 10.0
    elif name == "subnormal":
        scores *= np.float32(1e-39)
    elif name == "inf":
        flat = scores.reshape(b, hw, c)
        big = rng.choice(hw, size=1 << max(1, (hw // 20).bit_length() - 1), replace=False)
        flat[:, big, 1] = np.float32(2.0 ** 106)
        flat[:, big, 2] = -np.finfo(np.float32).max
    elif name == "k0":
        kw.update(bg_p=0.0, fg_p=0.0)
    elif name == "k_last":
        kw.update(bg_p=1 - 0.5 / hw, fg_p=1 - 0.5 / hw)
    elif name == "void_rows":
        label[0, : max(1, h // 3)] = 255.0
        label[1] = 255.0
    else:
        raise ValueError(f"unknown K1 edge case {name!r}")
    orders = np.stack([rng.permutation(np.arange(1, c)) for _ in range(kw["num_iter"])])
    return scores, label, orders.astype(np.int32), kw


def partition_thresholds(scores, label, orders, *, bg_p, fg_p, num_iter, suppress_others,
                         margin_others):
    """The per-visit bias of the numpy oracle's loop (np.partition),
    [B, num_iter * C], 0 for an absent class."""
    f = scores.astype(np.float32).copy()
    b, h, w, c = f.shape
    lab = label.astype(np.uint8)
    tags = np.stack([np.isin(np.arange(c), lab[i]) for i in range(b)])
    if suppress_others:
        present = tags[:, None, None, :]
        lifted = f + np.where(present, 0.0, f.max()).astype(np.float32)
        pmin = lifted.min(3, keepdims=True)
        f = np.where(~present & (f > pmin), pmin - np.float32(margin_others), f).astype(np.float32)
    k_bg, k_fg = int(h * w * bg_p), int(h * w * fg_p)
    out = []
    for it in range(num_iter):
        for j in np.concatenate([[0], orders[it]]):
            row = np.zeros(b, np.float32)
            for i in range(b):
                if tags[i, j]:
                    diff = (f[i].max(2) - f[i, :, :, j]).reshape(-1)
                    row[i] = np.partition(diff, k_bg if j == 0 else k_fg)[k_bg if j == 0 else k_fg]
                    f[i, :, :, j] += row[i]
            out.append(row)
    return np.stack(out, 1) if out else np.zeros((b, 0), np.float32)


def k1_inputs(scores, label, orders, device, *, bg_p, fg_p, num_iter, suppress_others,
              margin_others):
    """The kernel's arguments for NHWC numpy inputs, as the training path
    builds them (ops/estep.py::_estep_bisect_nchw)."""
    import torch

    from em_adapt_torch.ops.estep import visit_schedule

    b, h, w, c = scores.shape
    hw = h * w
    flat = torch.from_numpy(scores).to(device).permute(0, 3, 1, 2).reshape(b, c, hw).contiguous()
    labels = torch.from_numpy(label).to(device).to(torch.uint8).to(torch.int32).reshape(b, hw)
    visit = visit_schedule(torch.from_numpy(orders).to(device))
    assert visit.numel() == num_iter * c
    args = (flat, labels.contiguous(), visit, flat.amax().reshape(1))
    kw = dict(k_bg=int(hw * bg_p), k_fg=int(hw * fg_p), suppress=suppress_others,
              margin=margin_others)
    return args, kw


def present_visits(label, orders) -> list[int]:
    """Per image, the class visits K1 runs (those of a tagged class)."""
    b, c = label.shape[0], orders.shape[1] + 1
    tags = np.stack([np.isin(np.arange(c), label[i].astype(np.uint8)) for i in range(b)])
    visits = np.concatenate([np.zeros((orders.shape[0], 1), np.int64), orders], 1).reshape(-1)
    return tags[:, visits].sum(1).tolist()


def k1_cases():
    """(name, NHWC scores, labels, orders, E-step keywords, golden output
    or None) of every case K1 is held on: ``realistic_batch`` at B=6 and
    B=30, one present class, the five goldens and the edge cases."""
    rng = np.random.default_rng(1234)
    cases = [(f"random_b{b}", *realistic_batch(rng, b), dict(K1_RECIPE), None) for b in (6, 30)]
    single = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    cases.append(("single_class", single, np.full((1, 8, 8), 2.0, np.float32),
                  np.array([[2, 1]], np.int32),
                  dict(K1_RECIPE, num_iter=1, suppress_others=False), None))
    fixtures = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "estep_*.npz")))
    if len(fixtures) != 5:
        raise AssertionError(f"expected 5 estep_*.npz goldens, found {len(fixtures)}")
    for path in fixtures:
        z = np.load(path)
        kw = dict(bg_p=float(z["bg_p"]), fg_p=float(z["fg_p"]), num_iter=int(z["num_iter"]),
                  suppress_others=bool(z["suppress"]), margin_others=float(z["margin"]))
        cases.append((os.path.basename(path), z["scores"].astype(np.float32),
                      z["label"].astype(np.float32), z["orders"].astype(np.int32), kw, z["out"]))
    for name in K1_EDGE_CASES:
        for h, w in K1_EDGE_SIZES:
            cases.append((f"edge {name} {h}x{w}", *k1_edge_case(name, h, w), None))
    return cases


def check_estep(device) -> dict:
    """K1 against its plain version (and the goldens, and np.partition) on
    the card, on ``k1_cases``; times on ``realistic_batch``, with its
    fixed cost and the cost of one present visit."""
    import torch

    from em_adapt_torch.ops import estep_kernel as k1

    def both(scores, label, orders, kw):
        """Kernel and plain results for one input, NHWC numpy out."""
        args, kkw = k1_inputs(scores, label, orders, device, **kw)
        before = k1.launches
        out_k, th_k = k1.estep_kernel(*args, **kkw)
        torch.cuda.synchronize()
        if k1.launches != before + 1:
            raise AssertionError("the E-step kernel was not launched")
        out_p, th_p = k1.estep_plain(*args, **kkw)

        def nhwc(t):
            return t.reshape(scores.shape[0], scores.shape[3], *scores.shape[1:3]).permute(
                0, 2, 3, 1).cpu().numpy()

        return nhwc(out_k), th_k.cpu().numpy(), nhwc(out_p), th_p.cpu().numpy()

    max_err = 0.0
    for name, scores, label, orders, kw, golden in k1_cases():
        out_k, th_k, out_p, th_p = both(scores, label, orders, kw)
        if not np.array_equal(out_k.argmax(3), out_p.argmax(3)):
            raise AssertionError(f"{name}: kernel argmax differs from the plain version")
        err = float(np.abs(out_k - out_p).max())
        if not err <= 2e-5:
            raise AssertionError(f"{name}: kernel scores differ from plain by {err}")
        if not np.array_equal(th_k.view(np.int32), th_p.view(np.int32)):
            raise AssertionError(f"{name}: thresholds not bit-equal to the plain version")
        want_th = partition_thresholds(scores, label, orders, **kw)
        if not np.array_equal(th_k.view(np.int32), want_th.view(np.int32)):
            raise AssertionError(f"{name}: thresholds not bit-equal to np.partition")
        extra = ""
        if golden is not None:
            if not np.array_equal(out_k.argmax(3), golden.argmax(3)):
                raise AssertionError(f"{name}: kernel argmax differs from the golden")
            gerr = float(np.abs(out_k - golden).max())
            if gerr > 2e-5:
                raise AssertionError(f"{name}: kernel scores differ from the golden by {gerr}")
            extra = f", vs golden {gerr:.3e}"
        max_err = max(max_err, err)
        log(f"K1 {name} {tuple(scores.shape)}: argmax identical, thresholds bit-equal "
            f"(plain and np.partition), max|kernel-plain| {err:.3e}{extra}")

    rounds = k1.search_rounds(k1._lib().em_estep_digit_bits())
    log(f"K1 search: {k1.DIGIT_BITS} threshold bits a block round, {rounds} dependent block "
        f"rounds a present class visit (the bisection: 31)")
    timing = {}
    for b in (6, 30):
        scores, label, orders = realistic_batch(np.random.default_rng(b), b)
        args, kw = k1_inputs(scores, label, orders, device, **K1_RECIPE)
        def run():
            return k1.estep_kernel(*args, **kw)

        ms = cuda_ms_per_launch(run, launches=100, reps=20, warmup=5)
        call_ms = cuda_ms(run, reps=50, warmup=5)
        prof_ms = profiled_kernel_ms(run, "estep_kernel", launches=50)
        plain_ms = cuda_ms(lambda: k1.estep_plain(*args, **kw), reps=5, warmup=1)
        hw = 41 * 41
        present = present_visits(label, orders)
        visits = 5 * 21
        bytes_moved = 4 * (2 * b * 21 * hw + b * hw + visits + 1 + b * visits)
        ops = 31 * hw * sum(present)
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / SIMT_OPS_PER_S) * 1e3
        bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / SIMT_OPS_PER_S else "operations"
        fixed_ms, visit_us = k1_split(args, kw, prof_ms, present)
        timing[b] = dict(ms=ms, prof_ms=prof_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, present=present, fixed_ms=fixed_ms,
                         visit_us=visit_us)
        log(f"K1 time B={b}: kernel {ms:.4f} ms per launch (100 back-to-back launches "
            f"between CUDA events, median of 20), {call_ms:.4f} ms per single call "
            f"(events around each call, median of 50), profiler device time "
            f"{measured(prof_ms, 4, 'ms')} "
            f"(mean of 50); plain {plain_ms:.2f} ms (median of 5); bound {bound_ms:.6f} ms "
            f"by {bound_by} ({bytes_moved} B, {ops} compares over {sum(present)} "
            f"present visits, most in one image {max(present)})")
        log(f"K1 cost B={b}: fixed {measured(fixed_ms, 4, 'ms')} (profiler device time, "
            f"all-void labels, no visit runs), {measured(visit_us, 3, 'us')} a present visit "
            f"((profiler time - fixed) / {max(present)} visits of the busiest image), "
            f"{rounds} block rounds a visit")
    return dict(max_abs_err=max_err, timing=timing, rounds=rounds)


def k1_split(args, kw, prof_ms: float | None, present: list[int]):
    """K1's fixed cost and the cost of one present visit on ``args``: the
    profiler's device time per launch with every label void (the loads,
    suppression, sums and stores, and no class visit; back-to-back events
    would time the host's enqueue of so short a launch), and
    (``prof_ms`` - fixed) / the busiest image's present visits, in µs.
    None where the profiler records no device time."""
    import torch

    from em_adapt_torch.ops import estep_kernel as k1

    void = (args[0], torch.full_like(args[1], 255), *args[2:])
    fixed = profiled_kernel_ms(lambda: k1.estep_kernel(*void, **kw), "estep_kernel", launches=50)
    if fixed is None or prof_ms is None:
        return fixed, None
    return fixed, (prof_ms - fixed) / max(present) * 1e3


def measured(value: float | None, digits: int, unit: str) -> str:
    return "not measured" if value is None else f"{value:.{digits}f} {unit}"


def check_model_small_input(device) -> None:
    """Full-width forward at a 65x65 input: the card agrees with the CPU."""
    import torch

    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, init_params

    cfg = ModelConfig(input_size=(65, 65), init_scheme="he")
    params = init_params(torch.Generator().manual_seed(7), cfg)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 65, 65, 3)).astype(np.float32) * 40)
    with torch.no_grad():
        want = DeepLabLargeFOV(cfg).load_params(params).eval()(x)
        got = DeepLabLargeFOV(cfg).load_params(params).to(device).eval()(x.to(device)).cpu()
    if got.shape != (1, 9, 9, 21) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits {tuple(got.shape)}")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > 1e-4 * max(scale, 1.0):
        raise AssertionError(f"card logits differ from the CPU by {err} (scale {scale})")
    log(f"model 65x65 full width: card vs CPU max|diff| {err:.3e} (max|logit| {scale:.3e})")


def conv_flops(cfg, batch: int) -> int:
    """Multiply-add operations (x2) of one training step's convolutions,
    from the layer shapes: forward, input gradient (none for conv1_1,
    whose input needs none) and weight gradient."""
    from em_adapt_torch.models.deeplab import POOLS, layer_specs

    h, w = cfg.input_size
    total = 0
    for name, kh, kw, cin, cout, _ in layer_specs(cfg):
        fwd = 2 * kh * kw * cin * cout * h * w * batch
        total += fwd * (2 if name == "conv1_1" else 3)
        if POOLS.get(name) == 2:
            h, w = -(-h // 2), -(-w // 2)
    return total


def device_rows(prof, steps: int) -> list[tuple[float, int, str]]:
    """(device ms a step, launches a step, name) of each device kernel and
    copy in a torch.profiler trace of ``steps`` steps, largest first."""
    rows = []
    for e in prof.key_averages():
        kind = getattr(e, "device_type", None)
        if e.key.startswith("aten::") or (kind is not None and "CUDA" not in str(kind)):
            continue  # an operator's (or autograd Function's) row repeats its kernels' time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    return sorted(rows, reverse=True)


def profile_steps(trainer, state, batches, steps: int) -> None:
    """Device time by kernel over ``steps`` more training steps
    (torch.profiler), and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(trainer.train_step(state, next(batches))["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, steps)
    busy = sum(r[0] for r in rows) * steps
    log(f"profile: {steps} steps in {wall_ms:.2f} ms wall, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%)" if rows else "profile: no device time recorded")
    for ms, count, key in rows[:25]:
        log(f"profile: {ms:9.3f} ms/step  {count:4d}/step  {key[:110]}")


def train(device, steps: int, profile_n: int = 0, bf16: bool = False) -> dict:
    """A main path: Trainer.fit at the reference recipe, full width, in f32
    (K1) or with ``bf16`` in bf16 with the fused block 1 (K1, K2 and K3,
    each once a step); then, in bf16, one more step without and one with
    ``model.remat``, each with its own peak memory."""
    import dataclasses

    import torch

    from em_adapt_torch.config import ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.train.trainer import Trainer

    cfg = ExperimentConfig()
    # A log window a step: the card is synchronized after each, so its
    # record's wall is the step's, and on_step sees each step's params.
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every_steps=1))
    if bf16:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                                    block1_impl="pallas"))
    tag = "train bf16" if bf16 else "train f32"
    extra = 2 if bf16 else 0
    data = SyntheticVOC(cfg.train.batch_size * (steps + profile_n + extra), cfg.model.num_classes,
                        seed=0)
    trainer = Trainer(cfg, device=device, steps_per_epoch=len(data) // cfg.train.batch_size)
    state = trainer.init_state()
    params = list(state.model.parameters())
    log(f"{tag}: DeepLab-LargeFOV {sum(p.numel() for p in params)} params, input "
        f"{cfg.model.input_size}, batch {cfg.train.batch_size}, accum {cfg.optim.accum_steps}, "
        f"keep {cfg.model.dropout_keep_prob}, {cfg.model.compute_dtype}, block1 "
        f"{cfg.model.block1_impl}, init {cfg.model.init_scheme}")
    with torch.no_grad():
        l2 = float(state.model.weight_l2())
    batches = batch_iterator(data, cfg.data, batch_size=cfg.train.batch_size, seed=0)
    snapshot = [p.detach().clone() for p in params]
    moved, windows = [], []

    def on_step(record):
        windows.append(record)
        changed = any(not torch.equal(p, q) for p, q in zip(params, snapshot))
        moved.append(changed)
        if changed:
            for p, q in zip(params, snapshot):
                q.copy_(p)

    torch.cuda.reset_peak_memory_stats(device)
    k1.launches = k23.launches = k23.bwd_launches = 0
    t0 = time.perf_counter()
    records = trainer.fit(state, batches, num_steps=steps, log_fn=on_step)
    wall = time.perf_counter() - t0
    launches = dict(estep=k1.launches, block1_fwd=k23.launches, block1_bwd=k23.bwd_launches)
    peak = torch.cuda.max_memory_allocated(device)
    if profile_n:
        profile_steps(trainer, state, batches, profile_n)
    step_peaks, kept = {}, []
    if bf16:
        from em_adapt_torch.ops import estep as estep_ops

        kernel = estep_ops.estep_kernel

        def keep(*a, **kw):  # the E-step call's own arguments, kept for timing K1 on them
            kept.append((a, kw))
            return kernel(*a, **kw)

        for remat in (False, True):
            state.model.cfg = dataclasses.replace(cfg.model, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            estep_ops.estep_kernel = kernel if remat else keep
            try:
                float(trainer.train_step(state, next(batches))["loss"])
            finally:
                estep_ops.estep_kernel = kernel
            step_peaks[remat] = torch.cuda.max_memory_allocated(device)
        state.model.cfg = cfg.model
    batches.close()

    if len(records) != steps:
        raise AssertionError(f"fit ran {len(records)} of {steps} steps")
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    per_step = 1 if bf16 else 0
    for name, key in (("estep", "estep_launches"), ("block1_fwd", "block1_fwd_launches"),
                      ("block1_bwd", "block1_bwd_launches")):
        want = 1 if name == "estep" else per_step
        if launches[name] != want * steps or any(r[key] != want for r in records):
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times in {steps} "
                                 f"steps, expected {want} a step")
    accum = cfg.optim.accum_steps
    want_moved = [(i + 1) % accum == 0 for i in range(steps)]
    if moved != want_moved or [r["updated"] for r in records] != want_moved:
        raise AssertionError(f"params moved at {moved}, expected {want_moved}")
    # Reference init gives logits ~1e-11, a uniform softmax: CE = ln(C). In
    # bf16 the logits stay below 1e-3 too (f32 out of the last conv), so
    # the same 1e-3 holds.
    first = math.log(cfg.model.num_classes) + cfg.optim.weight_decay * l2
    if abs(losses[0] - first) > 1e-3:
        raise AssertionError(f"first loss {losses[0]} != ln(C) + wd*l2 = {first}")
    step_ms = statistics.median(w["window_seconds"] for w in windows[2:]) * 1e3
    launch_ms = statistics.median(r["seconds"] for r in records[2:]) * 1e3
    flops = conv_flops(cfg.model, cfg.train.batch_size)
    peak_rate = BF16_TENSOR_OPS_PER_S if bf16 else SIMT_OPS_PER_S
    log(f"{tag}: convolutions {flops} FLOP per step (forward and gradients, from shapes): "
        f"{flops / step_ms / 1e9:.2f} TFLOP/s achieved, bound "
        f"{flops / peak_rate * 1e3:.2f} ms at {peak_rate / 1e12:.1f} TFLOP/s")
    result = dict(step_ms=step_ms, images_per_s=cfg.train.batch_size / step_ms * 1e3,
                  peak_bytes=peak, launches=launches, losses=losses, wall_s=wall)
    log(f"{tag}: {steps} steps, losses {[round(v, 6) for v in losses]}, first "
        f"{losses[0]:.7f} vs ln(C) + wd*l2 {first:.7f}")
    log(f"{tag}: params moved at steps {[i for i, m in enumerate(moved) if m]}, launches "
        f"{launches}")
    log(f"{tag}: median {step_ms:.2f} ms/step over steps 2..{steps - 1} (log window wall, one "
        f"step each, synchronized; the step's launch {launch_ms:.2f} ms of it), "
        f"{result['images_per_s']:.2f} images/s, peak memory {peak} B "
        f"({peak / 2**30:.2f} GiB), fit wall {wall:.2f} s for {steps} steps "
        f"({wall / steps * 1e3:.2f} ms/step with batch fetch and warm-up)")
    if bf16:
        log(f"{tag}: one more step's peak memory: {step_peaks[False]} B "
            f"({step_peaks[False] / 2**30:.2f} GiB) plain, {step_peaks[True]} B "
            f"({step_peaks[True] / 2**30:.2f} GiB) with model.remat")
        result["step_peaks"] = step_peaks
        if len(kept) != 1:
            raise AssertionError(f"{tag}: the plain extra step called K1 {len(kept)} times")
        result["k1_in_step"] = time_k1_on(*kept[0])
    return result


def time_k1_on(args, kw) -> dict:
    """K1's time on the arguments of one training step's E-step call (the
    scores and tags of that step), as ``check_estep`` times it on
    ``realistic_batch``, with its fixed cost and the present class visits
    per image that set its length (absent classes are skipped)."""
    import torch

    from em_adapt_torch.ops import estep_kernel as k1

    scores, labels, visit = args[:3]
    c = scores.shape[1]
    tags = (labels[:, :, None] == torch.arange(c, device=labels.device)).any(1)
    present = tags[:, visit.long()].sum(1).tolist()

    def run():
        return k1.estep_kernel(*args, **kw)

    ms = cuda_ms_per_launch(run, launches=100, reps=20, warmup=5)
    prof_ms = profiled_kernel_ms(run, "estep_kernel", launches=50)
    fixed_ms, visit_us = k1_split(args, kw, prof_ms, present)
    return dict(ms=ms, prof_ms=prof_ms, present=present, shape=tuple(scores.shape),
                fixed_ms=fixed_ms, visit_us=visit_us)


#: The resume phase: run A trains RESUME_STEPS steps uninterrupted at
#: RESUME_EPOCH steps an epoch (so the LR drops at step RESUME_EPOCH) and
#: saves "norm" every RESUME_SAVE_EVERY steps; run B is sent SIGTERM by its
#: log_fn after step RESUME_SIGNAL_AFTER, saves at the next step, which is
#: mid-accumulation (7 mod 5 = 2), and a fresh Trainer resumes it.
RESUME_STEPS, RESUME_EPOCH, RESUME_SAVE_EVERY, RESUME_SIGNAL_AFTER = 12, 6, 4, 6
#: Settings tried in turn until two uninterrupted runs agree bit for bit.
DETERMINISM_LEVELS = ("default", "cudnn.deterministic", "use_deterministic_algorithms")


def set_determinism(level: str) -> None:
    import torch

    torch.backends.cudnn.deterministic = level != "default"
    torch.use_deterministic_algorithms(level == "use_deterministic_algorithms", warn_only=True)


def resume(device, card: str) -> dict:
    """Phase "resume bf16": full-state checkpoint and resume at full width
    (bf16, fused block 1: K1, K2 and K3 each once a step; batch 6,
    accumulation 5). Two uninterrupted runs A are compared under the
    default settings, then under stricter ones until two agree; run B,
    stopped by SIGTERM and resumed in a fresh Trainer, must end on run
    A's state bit for bit (params, momentum, acc, mini_step, step,
    generator) with the same losses, and a model loaded by
    ``restore_params`` must give the resumed model's logits bit for bit.
    Prints the checkpoint's bytes and the save, async-stall and restore
    times. Writes under build/ and removes what it wrote."""
    import dataclasses
    import shutil
    import signal
    import tempfile

    import torch

    from em_adapt_torch.config import CheckpointConfig, ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.models.deeplab import build_model
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.train.checkpoint import STATE_FILE, CheckpointManager, to_host
    from em_adapt_torch.train.state import bitwise_diff
    from em_adapt_torch.train.trainer import Trainer

    tag = "resume bf16"
    base = ExperimentConfig()
    cfg = base.replace(
        model=dataclasses.replace(base.model, compute_dtype="bfloat16", block1_impl="pallas"),
        optim=dataclasses.replace(base.optim, lr_schedule=((1, 1e-4),)),
        train=dataclasses.replace(base.train, log_every_steps=1))  # a log record a step
    bs = cfg.train.batch_size
    data = SyntheticVOC(bs * RESUME_EPOCH, cfg.model.num_classes, seed=0)
    stop_step = RESUME_SIGNAL_AFTER + 1
    if stop_step % cfg.optim.accum_steps == 0:
        raise AssertionError(f"{tag}: the stop step {stop_step} ends an accumulation window")
    want_a = {"norm": [8, 12], "lr": [RESUME_EPOCH]}  # "norm" at 4, 8, 12, newest two kept
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(ROOT, "build"))

    def trainer_for(name: str):
        c = cfg.replace(checkpoint=CheckpointConfig(save_dir=os.path.join(root, name),
                                                    save_every_steps=RESUME_SAVE_EVERY))
        return Trainer(c, device=device, steps_per_epoch=RESUME_EPOCH)

    windows = []  # every run's log records, one a step: the walls of median_ms

    def run(trainer, state, start: int = 0, log_fn=None) -> list[dict]:
        batches = batch_iterator(data, cfg.data, batch_size=bs, seed=0, start_step=start)

        def logged(record):
            windows.append(record)
            if log_fn is not None:
                log_fn(record)

        try:
            return trainer.fit(state, batches, num_steps=RESUME_STEPS, log_fn=logged)
        finally:
            batches.close()

    def run_a(name: str):
        trainer = trainer_for(name)
        state = trainer.init_state()
        records = run(trainer, state)
        steps = {t: trainer.checkpointer.all_steps(t) for t in want_a}
        if steps != want_a:
            raise AssertionError(f"{tag}: run A saved {steps}, expected {want_a}")
        shutil.rmtree(trainer.cfg.checkpoint.save_dir)
        return records, to_host(state.state_dict())

    def median_ms() -> float:
        """Median wall of a step (its log window, synchronized) over the
        runs since the last call (A twice, B and its resumed part), each
        fresh run's first two steps left out."""
        walls = [w["window_seconds"] for w in windows if w["step"] > 2]
        windows.clear()
        return statistics.median(walls) * 1e3

    def run_b():
        """Run B to the SIGTERM, then resumed in a fresh Trainer to the end."""
        trainer = trainer_for("b")
        state = trainer.init_state()

        def preempt(record):  # a record's step counts the steps done
            if record["step"] == RESUME_SIGNAL_AFTER + 1:
                signal.raise_signal(signal.SIGTERM)

        first = run(trainer, state, log_fn=preempt)
        ckpt = trainer.checkpointer
        steps = {t: ckpt.all_steps(t) for t in want_a}
        if state.step != stop_step or steps != {"norm": [4, stop_step], "lr": [RESUME_EPOCH]}:
            raise AssertionError(f"{tag}: SIGTERM left step {state.step} and saves {steps}")
        nbytes = os.path.getsize(os.path.join(ckpt.step_dir("norm", stop_step), STATE_FILE))

        trainer = trainer_for("b")
        resumed = trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.checkpointer.restore(resumed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if bitwise_diff(resumed.state_dict(), trainer.checkpointer.load()):
            raise AssertionError(f"{tag}: the restored state differs from the saved one")
        if resumed.step != stop_step or resumed.optimizer.mini_step != mini_step:
            raise AssertionError(f"{tag}: restored step {resumed.step}, mini_step "
                                 f"{resumed.optimizer.mini_step}")
        listed = {}

        def watch(record):
            if record["step"] == 9:  # step 8 ran; "norm" 8 was saved right after step 7
                trainer.checkpointer.wait()
                listed["norm"] = trainer.checkpointer.all_steps("norm")

        k1.launches = k23.launches = k23.bwd_launches = 0
        second = run(trainer, resumed, start=stop_step, log_fn=watch)
        launches = dict(estep=k1.launches, block1_fwd=k23.launches, block1_bwd=k23.bwd_launches)
        n = RESUME_STEPS - stop_step
        if [r["step"] for r in second] != list(range(stop_step, RESUME_STEPS)):
            raise AssertionError(f"{tag}: resumed run ran steps {[r['step'] for r in second]}")
        if launches != dict(estep=n, block1_fwd=n, block1_bwd=n) or any(
                (r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
                != (1, 1, 1) for r in second):
            raise AssertionError(f"{tag}: launches after resume {launches}, expected {n} each")
        if listed != {"norm": [stop_step, 8]} or {t: trainer.checkpointer.all_steps(t)
                                                  for t in want_a} != want_a:
            raise AssertionError(f"{tag}: 'norm' held {listed} at step 8")
        return dict(trainer=trainer, state=resumed, records=first + second, nbytes=nbytes,
                    restore_s=restore_s, launches=launches, listed=listed["norm"])

    mini_step = stop_step % cfg.optim.accum_steps
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    try:
        levels = {}
        for level in DETERMINISM_LEVELS:
            set_determinism(level)
            (rec1, a1), (rec2, a2) = run_a(f"a-{level}-1"), run_a(f"a-{level}-2")
            diff = bitwise_diff(a1, a2)
            loss_steps = [r["step"] for r, q in zip(rec1, rec2) if r["loss"] != q["loss"]]
            gap = max(float((a1["params"][k] - a2["params"][k]).abs().max()) for k in a1["params"])
            b = run_b()
            b_diff = bitwise_diff(b["state"].state_dict(), a1)
            b_loss_steps = [r["step"] for r, q in zip(b["records"], rec1) if r["loss"] != q["loss"]]
            equal = not (diff or loss_steps or b_diff or b_loss_steps)
            levels[level] = dict(equal=equal, leaves=len(diff), loss_steps=loss_steps,
                                 max_param_gap=gap, b_leaves=len(b_diff),
                                 b_loss_steps=b_loss_steps, step_ms=median_ms())
            log(f"{tag}: under {level} settings, two uninterrupted {RESUME_STEPS}-step runs A "
                f"{'agree' if not (diff or loss_steps) else 'DIFFER'} ({len(diff)} leaves of the "
                f"state differ, losses at steps {loss_steps}, max |param gap| {gap:.3e}); run B "
                f"(resumed) against A: {len(b_diff)} leaves differ, losses at steps "
                f"{b_loss_steps}; median step {levels[level]['step_ms']:.2f} ms ({card})")
            if equal:
                break
            shutil.rmtree(os.path.join(root, "b"))
        else:
            raise AssertionError(f"{tag}: runs differ under every setting: {levels}")
        if level != "default":
            log(f"{tag}: bit-exact resume needs {level}: median step "
                f"{levels[level]['step_ms']:.2f} ms against {levels['default']['step_ms']:.2f} ms "
                f"with the defaults ({card})")
        trainer_b, resumed, launches = b["trainer"], b["state"], b["launches"]
        log(f"{tag}: run B (SIGTERM after step {RESUME_SIGNAL_AFTER}, saved at step {stop_step}, "
            f"mini_step {mini_step}, resumed in a fresh Trainer) ends on run A's state bit for "
            f"bit at step {RESUME_STEPS} (params, momentum, acc, mini_step, step, generator); "
            f"losses of steps 0-{RESUME_STEPS - 1} bit-equal; launches after resume "
            f"{launches}; 'norm' held {b['listed']} at step 8, 'lr' {want_a['lr']}")

        model = build_model(cfg.model, cfg.train.seed + 1, device)
        loaded = trainer_b.checkpointer.restore_params(model)
        images = next(batch_iterator(SyntheticVOC(bs, cfg.model.num_classes, seed=1), cfg.data,
                                     batch_size=bs, epochs=1, train=False))["image"]
        x = torch.from_numpy(images).to(device)
        with torch.no_grad():
            got = model.eval().predict(x)
            want = resumed.model.eval().predict(x)
        resumed.model.train()
        if loaded != RESUME_STEPS or bitwise_diff(list(got), list(want)):
            raise AssertionError(f"{tag}: restore_params (step {loaded}) gives other logits")
        log(f"{tag}: a fresh model loaded by restore_params (step {loaded}) predicts {x.shape[0]} "
            f"images with logits bit-equal to the resumed model's")
        shutil.rmtree(os.path.join(root, "b"))

        batches = batch_iterator(data, cfg.data, batch_size=bs, seed=0, start_step=RESUME_STEPS)

        def step_s() -> float:
            batch = next(batches)
            t = time.perf_counter()
            float(trainer_b.train_step(resumed, batch)["loss"])
            return time.perf_counter() - t

        try:
            timing = {}
            for mode in ("sync", "async"):
                mgr = CheckpointManager(CheckpointConfig(save_dir=os.path.join(root, mode),
                                                         async_save=mode == "async"))
                plain = [step_s() for _ in range(3)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(resumed, "norm")
                call_s = time.perf_counter() - t0
                during = step_s()
                mgr.wait()
                timing[mode] = dict(call_s=call_s, total_s=time.perf_counter() - t0,
                                    step_ms=statistics.median(plain) * 1e3,
                                    step_during_ms=during * 1e3)
        finally:
            batches.close()
        sync, asy = timing["sync"], timing["async"]
        stall_ms = asy["call_s"] * 1e3 + max(asy["step_during_ms"] - asy["step_ms"], 0.0)
        nbytes = b["nbytes"]
        log(f"{tag}: checkpoint {nbytes} B ({nbytes / 1e9:.3f} GB) for "
            f"{sum(p.numel() for p in resumed.model.parameters())} params; sync save "
            f"{sync['call_s']:.3f} s; async save returns in {asy['call_s']:.3f} s (host copy) and "
            f"is on disk after {asy['total_s']:.3f} s, the step it overlaps takes "
            f"{asy['step_during_ms']:.2f} ms against {asy['step_ms']:.2f} ms: training stalls "
            f"{stall_ms:.1f} ms a save; restore {b['restore_s']:.3f} s ({card})")
        return dict(bytes=b["nbytes"], sync_s=sync["call_s"], async_call_s=asy["call_s"],
                    async_total_s=asy["total_s"], stall_ms=stall_ms, restore_s=b["restore_s"],
                    level=level, levels=levels, launches=launches)
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])
        shutil.rmtree(root, ignore_errors=True)


#: The input phase: fit runs of INPUT_STEPS steps with and without the
#: prefetcher, in turns (INPUT_DEPTHS), each followed by one step and then
#: INPUT_PROFILED steps under torch.profiler; the producer alone over
#: INPUT_STEPS batches.
INPUT_STEPS = 12
INPUT_PROFILED = 3
INPUT_DEPTHS = (0, 2, 2, 0)
#: The VOC-layout tree of the input phase: VOC's image size and JPEG
#: quality, split into "train" and "val".
VOC_TREE = dict(train=24, val=6, size=(500, 375), quality=90)


def producer_ms(dataset, data_cfg, batch_size: int, batches: int, train: bool = True):
    """The host producer alone: ``batch_iterator``'s ms per batch (median
    and mean over ``batches`` after one warm-up batch) and a batch's bytes."""
    from em_adapt_torch.data.pipeline import batch_iterator

    it = batch_iterator(dataset, data_cfg, batch_size=batch_size, seed=0, train=train)
    try:
        next(it)
        times = []
        for _ in range(batches):
            t = time.perf_counter()
            batch = next(it)
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        it.close()
    nbytes = sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray))
    return statistics.median(times), statistics.fmean(times), nbytes


def input_phase(device, card: str) -> dict:
    """Phase "input bf16": the host producer alone in both wire formats,
    then ``Trainer.fit`` at the reference recipe in bf16 (K1, K2, K3; the
    reference init: He init's loss turns NaN by step 15 at the reference
    LR) for INPUT_STEPS steps with ``data.prefetch=0`` and ``=2`` in
    turns, each followed by INPUT_PROFILED steps under torch.profiler (the
    HtoD copies' device time and the device's busy share). Every run must
    end on the same losses and state, bit for bit, with K1, K2 and K3 once
    a step."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from em_adapt_torch.config import CheckpointConfig, ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.train.checkpoint import to_host
    from em_adapt_torch.train.state import bitwise_diff
    from em_adapt_torch.train.trainer import Trainer

    tag = "input bf16"
    base = ExperimentConfig()
    bs = base.train.batch_size
    steps = INPUT_STEPS + 1 + INPUT_PROFILED
    data = SyntheticVOC(bs * steps, base.model.num_classes, seed=0)
    producer = {}
    for wire in ("float32", "uint8"):
        med, mean, nbytes = producer_ms(data, dataclasses.replace(base.data, wire_dtype=wire),
                                        bs, INPUT_STEPS)
        producer[wire] = dict(median_ms=med, mean_ms=mean, bytes=nbytes)
        log(f"{tag}: producer alone (batch_iterator, SyntheticVOC train, {base.data.num_workers} "
            f"workers, {wire} wire): {med:.2f} ms per batch median, {mean:.2f} mean over "
            f"{INPUT_STEPS} batches; {nbytes} B a batch ({card})")
    root = tempfile.mkdtemp(prefix="input-", dir=os.path.join(ROOT, "build"))
    runs, first = [], None
    try:
        for depth in INPUT_DEPTHS:
            cfg = base.replace(
                model=dataclasses.replace(base.model, compute_dtype="bfloat16",
                                          block1_impl="pallas"),
                data=dataclasses.replace(base.data, prefetch=depth),
                checkpoint=CheckpointConfig(save_dir=root, save_every_steps=0,
                                            snapshot_on_lr_drop=False))
            trainer = Trainer(cfg, device=device, steps_per_epoch=len(data) // bs)
            # The profiled steps' hooks need a log record a step.
            logging = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, log_every_steps=1)),
                              device=device, steps_per_epoch=len(data) // bs)
            state = trainer.init_state()
            batches = batch_iterator(data, cfg.data, batch_size=bs, seed=0)
            # Device activity only: tracing the host's operators too would slow
            # the launching thread several times over and shrink the busy share.
            prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
            window = []

            def profiled(record):  # a record's step counts the steps done
                if record["step"] == INPUT_STEPS + 1:  # the second fit's first step is cold
                    window.append(time.perf_counter())
                    prof.start()
                elif record["step"] == steps:
                    prof.stop()
                    window.append(time.perf_counter())

            try:
                k1.launches = k23.launches = k23.bwd_launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                records = trainer.fit(state, batches, num_steps=INPUT_STEPS)
                wall = time.perf_counter() - t0
                launches = (k1.launches, k23.launches, k23.bwd_launches)
                more = logging.fit(state, batches, num_steps=steps, log_fn=profiled)
            finally:
                batches.close()
            records += more
            if [r["step"] for r in records] != list(range(steps)):
                raise AssertionError(f"{tag}: prefetch={depth} ran steps "
                                     f"{[r['step'] for r in records]}")
            if launches != (INPUT_STEPS,) * 3 or any(
                    (r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
                    != (1, 1, 1) for r in records):
                raise AssertionError(f"{tag}: prefetch={depth}: K1, K2, K3 launched {launches} "
                                     f"times in {INPUT_STEPS} steps, expected 1 each a step")
            losses = [r["loss"] for r in records]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{tag}: non-finite loss: {losses}")
            host = to_host(state.state_dict())
            if first is None:
                first = dict(losses=losses, state=host)
            else:
                diff = bitwise_diff(host, first["state"])
                if losses != first["losses"] or diff:
                    at = [i for i, (a, b) in enumerate(zip(losses, first["losses"])) if a != b]
                    raise AssertionError(
                        f"{tag}: prefetch={depth} differs from prefetch={INPUT_DEPTHS[0]}: losses "
                        f"at steps {at}, {len(diff)} leaves of the state")
            del host
            rows = device_rows(prof, INPUT_PROFILED)
            busy = sum(r[0] for r in rows)
            htod = [r for r in rows if "HtoD" in r[2]]
            win_ms = (window[1] - window[0]) * 1e3 / INPUT_PROFILED
            timed = records[2:INPUT_STEPS]
            run = dict(depth=depth, wall_s=wall,
                       launch_ms=statistics.median(r["seconds"] for r in timed) * 1e3,
                       wait_ms=statistics.median(r["wait_seconds"] for r in timed) * 1e3,
                       first_ms=(records[0]["seconds"] + records[0]["wait_seconds"]) * 1e3,
                       htod_ms=sum(r[0] for r in htod), busy_ms=busy, window_ms=win_ms)
            runs.append(run)
            log(f"{tag}: prefetch={depth}: fit wall {wall:.3f} s for {INPUT_STEPS} steps "
                f"({wall / INPUT_STEPS * 1e3:.2f} ms/step; step 0's launch with its wait "
                f"{run['first_ms']:.2f} ms); over steps 2..{INPUT_STEPS - 1} median launch "
                f"{run['launch_ms']:.2f} ms, median wait for the batch {run['wait_ms']:.3f} ms; "
                f"K1, K2, K3 launches {launches}; profiled steps {INPUT_STEPS + 1}..{steps - 1}: "
                f"{win_ms:.2f} ms/step wall, device busy {busy:.2f} ms/step "
                f"({100 * busy / win_ms:.1f}%, sum of device times), HtoD "
                f"{run['htod_ms']:.3f} ms/step in "
                f"{'; '.join(f'{c}x {k} {ms:.3f} ms' for ms, c, k in htod) or 'no copy'} "
                f"({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"{tag}: all {len(INPUT_DEPTHS)} runs (prefetch {list(INPUT_DEPTHS)}) end on the same "
        f"state and {steps} losses bit for bit")
    by = {d: [r for r in runs if r["depth"] == d] for d in set(INPUT_DEPTHS)}
    summary = {d: {k: statistics.median(r[k] for r in rs) for k in rs[0] if k != "depth"}
               for d, rs in by.items()}
    for d, m in sorted(summary.items()):
        log(f"{tag}: prefetch={d}, median of {len(by[d])} runs: fit wall {m['wall_s']:.3f} s "
            f"({m['wall_s'] / INPUT_STEPS * 1e3:.2f} ms/step), launch {m['launch_ms']:.2f} ms, wait "
            f"{m['wait_ms']:.3f} ms, HtoD {m['htod_ms']:.3f} ms/step, busy "
            f"{100 * m['busy_ms'] / m['window_ms']:.1f}% ({card})")
    return dict(producer=producer, runs=runs, summary=summary)

def voc_tree_phase(device, card: str) -> dict:
    """Phase "input VOC": the reader's whole path on a VOC-layout tree
    written here (VOC_TREE: JPEGs at VOC's size and quality, RGB-coded
    masks with a void border around each object, the split lists):
    ``convert``, the producer with JPEG decode, ``train --steps 10`` and
    ``eval --fixed-size`` through the command line, at full width in
    bf16 with the fused block 1."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from PIL import Image, ImageDraw

    from em_adapt_torch.__main__ import main as cli
    from em_adapt_torch.config import ExperimentConfig
    from em_adapt_torch.data.pipeline import VOCSegmentation
    from em_adapt_torch.data.voc import VOC_PALETTE, rgb_mask_to_index
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1

    tag = "input VOC"
    base = ExperimentConfig()
    bs = base.train.batch_size
    root = tempfile.mkdtemp(prefix="voc-", dir=os.path.join(ROOT, "build"))
    main_path, list_dir = os.path.join(root, "VOCdevkit", "VOC2012"), os.path.join(root, "txt")
    seg_dir, aug_dir = (os.path.join(main_path, d) for d in ("SegmentationClass",
                                                                 "SegmentationClassAug"))
    try:
        for d in (os.path.join(main_path, "JPEGImages"), seg_dir, list_dir):
            os.makedirs(d)
        g = np.random.default_rng(0)
        w, h = VOC_TREE["size"]
        t0 = time.perf_counter()
        for split in ("train", "val"):
            ids = [f"2012_{split}{i:04d}" for i in range(VOC_TREE[split])]
            for img_id in ids:
                low = Image.fromarray(g.integers(0, 256, size=(12, 16, 3), dtype=np.uint8))
                img = np.asarray(low.resize((w, h), Image.BICUBIC), np.float32)
                img = np.clip(img + g.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(main_path, "JPEGImages", f"{img_id}.jpg"),
                                          quality=VOC_TREE["quality"])
                mask = Image.new("RGB", (w, h), VOC_PALETTE[0])
                draw = ImageDraw.Draw(mask)
                for _ in range(int(g.integers(1, 4))):  # 1-3 objects, each with a void border
                    x0, y0 = int(g.integers(0, w // 2)), int(g.integers(0, h // 2))
                    box = [x0, y0, x0 + int(g.integers(40, w // 2)),
                           y0 + int(g.integers(40, h // 2))]
                    draw.ellipse(box, fill=VOC_PALETTE[int(g.integers(1, 21))],
                                 outline=(224, 224, 192), width=5)
                mask.save(os.path.join(seg_dir, f"{img_id}.png"))
            with open(os.path.join(list_dir, f"{split}.txt"), "w") as f:
                f.write("\n".join(ids) + "\n")
        written_s = time.perf_counter() - t0
        n = VOC_TREE["train"] + VOC_TREE["val"]

        def run(*argv) -> list[str]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli(list(argv))
            if rc != 0:
                raise AssertionError(f"{tag}: {argv[0]} exited {rc}: {out.getvalue()[-2000:]}")
            return out.getvalue().splitlines()

        t0 = time.perf_counter()
        run("convert", "--voc-seg", seg_dir, "--out", aug_dir)
        convert_s = time.perf_counter() - t0
        names = sorted(os.listdir(aug_dir))
        if len(names) != n:
            raise AssertionError(f"{tag}: convert wrote {len(names)} masks of {n}")
        for name in names:
            with Image.open(os.path.join(seg_dir, name)) as src, \
                    Image.open(os.path.join(aug_dir, name)) as got:
                if not np.array_equal(np.asarray(got), rgb_mask_to_index(np.asarray(src))):
                    raise AssertionError(f"{tag}: convert's {name} is not its palette indices")
        data_cfg = dataclasses.replace(base.data, main_path=main_path, list_dir=list_dir)
        med, mean, nbytes = producer_ms(VOCSegmentation(data_cfg, "train"), data_cfg, bs,
                                        INPUT_STEPS)
        log(f"{tag}: {n} JPEGs of {w}x{h} at quality {VOC_TREE['quality']} with RGB-coded masks "
            f"written in {written_s:.2f} s; convert {convert_s:.2f} s, every index mask the "
            f"palette's; producer with JPEG decode (batch_iterator, VOCSegmentation train, "
            f"{data_cfg.num_workers} workers, float32 wire): {med:.2f} ms per batch median, "
            f"{mean:.2f} mean over {INPUT_STEPS} batches, {nbytes} B a batch ({card})")

        args = [f"data.main_path={main_path}", f"data.list_dir={list_dir}",
                "model.compute_dtype=bfloat16", "model.block1_impl=pallas",
                f"checkpoint.save_dir={os.path.join(root, 'saver')}"]
        k1.launches = k23.launches = k23.bwd_launches = 0
        jsonl = os.path.join(root, "train.jsonl")
        t0 = time.perf_counter()
        run("train", "--steps", "10", "--log-jsonl", jsonl, "train.log_every_steps=1", *args)
        train_s = time.perf_counter() - t0
        with open(jsonl) as f:
            records = [r for r in map(json.loads, f) if "loss" in r]
        losses = [r["loss"] for r in records]
        in_steps = tuple(sum(r[k] for r in records) for k in
                         ("estep_launches", "block1_fwd_launches", "block1_bwd_launches"))
        # K1 also runs in the train command's E-step calibration, before the steps.
        launches = (k1.launches, k23.launches, k23.bwd_launches)
        calib = k1.launches - in_steps[0]
        if ([r["step"] for r in records] != list(range(1, 11)) or in_steps != (10, 10, 10)
                or launches[1:] != (10, 10) or calib <= 0
                or not all(isinstance(v, float) and math.isfinite(v) for v in losses)):
            raise AssertionError(f"{tag}: train logged steps {[r['step'] for r in records]}, "
                                 f"launches {launches} ({in_steps} in the steps), losses {losses}")
        k23.launches = 0
        t0 = time.perf_counter()
        lines = run("eval", "--fixed-size", *args)
        eval_s = time.perf_counter() - t0
        miou = float(lines[-1].split("=")[1])
        want_batches = -(-VOC_TREE["val"] // base.eval.batch_size)
        if (lines[0] != "evaluating checkpoint step 10" or k23.launches != want_batches
                or not 0.0 <= miou <= 1.0 or len(lines) != 2 + base.model.num_classes):
            raise AssertionError(f"{tag}: eval printed {lines}, K2 launched {k23.launches} "
                                 f"times")
        log(f"{tag}: `train --steps 10` on the tree: {train_s:.2f} s (its checkpoint included), "
            f"losses {[round(v, 6) for v in losses]}, K1, K2, K3 launches {in_steps} in the "
            f"steps and {calib} of K1 in the E-step calibration "
            f"({records[0]['estep_us_per_image_calib']} us/image), median step (a log window "
            f"each) {statistics.median(r['window_seconds'] for r in records[2:]) * 1e3:.2f} ms, "
            f"median wait {statistics.median(r['wait_seconds'] for r in records[2:]) * 1e3:.3f} ms; "
            f"`eval --fixed-size` on its {VOC_TREE['val']} val images: {eval_s:.2f} s, K2 "
            f"launches {k23.launches}, mIoU {miou:.4f} ({card})")
        return dict(producer_ms=med, losses=losses, miou=miou)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: The loop phase: LOOP_STEPS steps on LOOP_BATCHES host batches made
#: beforehand and cycled, at each log cadence of LOOP_CADENCES, then
#: LOOP_PROFILED more steps under a device-only torch.profiler trace.
LOOP_STEPS, LOOP_BATCHES, LOOP_CADENCES, LOOP_PROFILED = 30, 6, (1, 10, 30), 6
#: Frames of ``train/trainer.py::Trainer.fit`` where the loop waits for the
#: card on purpose: the log window's sync, and a checked save's host copy.
CADENCE_FRAMES = ("full_sync", "checked_save")


class SyncCounter:
    """Counts the host syncs that ``torch.cuda.set_sync_debug_mode("warn")``
    reports inside the block, split into those at a cadence of the loop
    (a frame of CADENCE_FRAMES on the stack) and the others, each of those
    by the innermost frame of the port."""

    def __enter__(self):
        import collections
        import traceback
        import warnings

        import torch

        self.cadence, self.others = 0, collections.Counter()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" not in str(message):
                return
            stack = traceback.extract_stack()[:-1]
            if any(f.name in CADENCE_FRAMES for f in stack):
                self.cadence += 1
            else:
                ours = [f for f in stack if "em_adapt_torch" in f.filename]
                where = ours[-1] if ours else stack[-1]
                self.others[f"{os.path.relpath(where.filename, ROOT)}:{where.lineno} "
                            f"{where.name}"] += 1

        warnings.showwarning = show
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self._warnings.__exit__(*exc)
        return False


def loop_phase(device, card: str) -> dict:
    """Phase "loop bf16": ``Trainer.fit`` at the reference recipe in bf16
    (K1, K2, K3), on LOOP_BATCHES host batches made beforehand and cycled
    (the producer is out of the measurement; the prefetcher still copies
    each batch), for LOOP_STEPS steps at ``train.log_every_steps`` 1, 10
    and 30 with ``data.prefetch=2``, after a warm-up run. Reports the wall
    per step of every log window, the host syncs outside the cadences
    (``SyncCounter``), and, from LOOP_PROFILED more steps under a
    device-only trace, the device's time per step and its busy share of
    each cadence's untraced wall. Losses and state must be bit-equal
    across the cadences, with K1, K2 and K3 once a step."""
    import dataclasses
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from em_adapt_torch.config import CheckpointConfig, ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.train.checkpoint import to_host
    from em_adapt_torch.train.state import bitwise_diff
    from em_adapt_torch.train.trainer import Trainer

    tag = "loop bf16"
    base = ExperimentConfig()
    bs = base.train.batch_size
    it = batch_iterator(SyntheticVOC(bs * LOOP_BATCHES, base.model.num_classes, seed=0),
                        base.data, batch_size=bs, seed=0)
    try:
        cached = [next(it) for _ in range(LOOP_BATCHES)]
    finally:
        it.close()

    def trainer_for(log_every: int):
        cfg = base.replace(
            model=dataclasses.replace(base.model, compute_dtype="bfloat16", block1_impl="pallas"),
            data=dataclasses.replace(base.data, prefetch=2),
            train=dataclasses.replace(base.train, log_every_steps=log_every),
            checkpoint=CheckpointConfig(save_dir=os.path.join(ROOT, "build", "loop-unused"),
                                        save_every_steps=0, snapshot_on_lr_drop=False))
        return Trainer(cfg, device=device, steps_per_epoch=LOOP_BATCHES)

    def stream(n: int):
        return itertools.islice(itertools.cycle(cached), n)

    warm = trainer_for(3)
    warm.fit(warm.init_state(), stream(3), num_steps=3)
    runs, first = {}, None
    for every in LOOP_CADENCES:
        trainer = trainer_for(every)
        state = trainer.init_state()
        windows = []
        with SyncCounter() as syncs:
            t0 = time.perf_counter()
            records = trainer.fit(state, stream(LOOP_STEPS), num_steps=LOOP_STEPS,
                                  log_fn=windows.append)
            wall = time.perf_counter() - t0
        losses = [r["loss"] for r in records]
        if len(records) != LOOP_STEPS or not all(math.isfinite(v) for v in losses) or any(
                (r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
                != (1, 1, 1) for r in records):
            raise AssertionError(f"{tag}: log_every={every}: {len(records)} steps, losses "
                                 f"{losses}, launches not once a step")
        host = to_host(state.state_dict())
        if first is None:
            first = dict(losses=losses, state=host)
        elif losses != first["losses"] or bitwise_diff(host, first["state"]):
            raise AssertionError(f"{tag}: log_every={every} differs from log_every="
                                 f"{LOOP_CADENCES[0]} in losses or state")
        per_window = [w["window_seconds"] * 1e3 / w["window_steps"] for w in windows]
        runs[every] = dict(wall_ms=wall * 1e3 / LOOP_STEPS, windows_ms=per_window,
                           steady_ms=statistics.median(per_window[1:] or per_window),
                           launch_ms=statistics.median(r["seconds"] for r in records[2:]) * 1e3,
                           syncs_cadence=syncs.cadence, syncs_other=dict(syncs.others))
        del host
    trainer = trainer_for(LOOP_PROFILED)
    state = trainer.init_state()
    trainer.fit(state, stream(2), num_steps=2)
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    with prof:
        trainer.fit(state, stream(LOOP_PROFILED), num_steps=2 + LOOP_PROFILED)
    device_ms = sum(r[0] for r in device_rows(prof, LOOP_PROFILED))
    for every, r in runs.items():
        r["busy"] = device_ms / r["steady_ms"]
        log(f"{tag}: log_every_steps={every}: wall {r['wall_ms']:.2f} ms a step over the "
            f"{LOOP_STEPS} steps; per log window (ms a step) "
            f"{[round(w, 2) for w in r['windows_ms']]}; steady {r['steady_ms']:.2f} ms a step "
            f"(median of the windows after the first, or the only one); median launch "
            f"{r['launch_ms']:.2f} ms; device busy {100 * r['busy']:.1f}% of the steady wall; "
            f"host syncs {r['syncs_cadence']} at the cadence, {sum(r['syncs_other'].values())} "
            f"elsewhere ({r['syncs_other'] or 'none'}) ({card})")
    log(f"{tag}: device time {device_ms:.2f} ms a step over {LOOP_PROFILED} traced steps; all "
        f"{len(LOOP_CADENCES)} cadences end on the same state and {LOOP_STEPS} losses bit for "
        f"bit, K1, K2, K3 once a step ({card})")
    others = {k: v for r in runs.values() for k, v in r["syncs_other"].items()}
    if others:
        raise AssertionError(f"{tag}: host syncs outside the cadences: {others}")
    return dict(runs=runs, device_ms=device_ms)


#: The variants phase: VARIANT_STEPS steps of each variant through the
#: train command; the He-init runs: HE_STEPS steps in f32 and in bf16.
VARIANT_STEPS, HE_STEPS = 10, 20


def variants_phase(device, card: str) -> dict:
    """Phase "variants bf16": the train command at full width in bf16 (K1,
    K2, K3) for VARIANT_STEPS steps each, a log record a step: tag warm-up
    for 5 steps then EM (K1 only on the EM steps), ``--strong-fraction
    0.5``, ``optim.lr_multipliers=true``, ``train.eval_every_steps=10`` on
    12 synthetic val images (writes "best" and best_metric.json), and a
    warm start from that "best". Every loss must be finite. Then He init
    at the reference LR in f32 and in bf16 through ``Trainer.fit`` for
    HE_STEPS steps: the losses logged, and the step at which the watchdog
    stops a run whose loss is no longer finite (a measurement of the
    recipe: that stop is recorded, not a failure)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from em_adapt_torch.__main__ import main as cli
    from em_adapt_torch.config import CheckpointConfig, ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops import estep_kernel as k1
    from em_adapt_torch.train.trainer import Trainer

    tag = "variants bf16"
    root = tempfile.mkdtemp(prefix="variants-", dir=os.path.join(ROOT, "build"))
    bs = ExperimentConfig().train.batch_size
    options = ["--synthetic", str(bs * VARIANT_STEPS), "--steps", str(VARIANT_STEPS)]
    overrides = ["model.compute_dtype=bfloat16", "model.block1_impl=pallas",
                 "train.log_every_steps=1"]
    best_dir = os.path.join(root, "eval")
    # name: (options, overrides, warm-up steps)
    variants = {
        "warm-up": ([], ["train.tag_warmup_steps=5"], 5),
        "strong": (["--strong-fraction", "0.5"], [], 0),
        "lr-groups": ([], ["optim.lr_multipliers=true"], 0),
        "eval": (["--synthetic-val", "12"], ["train.eval_every_steps=10"], 0),
        "warm-start": (["--warm-start", best_dir, "--warm-start-tag", "best"], [], 0),
    }
    results = {}
    try:
        for name, (extra_options, extra, warmup) in variants.items():
            save_dir = best_dir if name == "eval" else os.path.join(root, name)
            jsonl = os.path.join(root, f"{name}.jsonl")
            out = io.StringIO()
            k1.launches = k23.launches = k23.bwd_launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli(["train", *options, *extra_options, "--log-jsonl", jsonl, *overrides,
                          *extra, f"checkpoint.save_dir={save_dir}"])
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{tag}: {name} exited {rc}: {out.getvalue()[-2000:]}")
            with open(jsonl) as f:
                logged = [json.loads(line) for line in f]
            train = [r for r in logged if "loss" in r]
            evals = [(r["step"], r["val_metric"]) for r in logged if "val_metric" in r]
            losses = [r["loss"] for r in train]
            per_step = [(r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
                        for r in train]
            want = [(0 if i < warmup else 1, 1, 1) for i in range(VARIANT_STEPS)]
            if (len(train) != VARIANT_STEPS or per_step != want
                    or not all(isinstance(v, float) and math.isfinite(v) for v in losses)):
                raise AssertionError(f"{tag}: {name}: losses {losses}, launches a step "
                                     f"{per_step}, expected {want}")
            if name == "eval":
                with open(os.path.join(best_dir, "best_metric.json")) as f:
                    side = json.load(f)
                best = sorted(os.listdir(os.path.join(best_dir, "best")))
                if ([s for s, _ in evals] != list(range(10, VARIANT_STEPS + 1, 10)) or not best
                        or side["metric"] != max(v for _, v in evals)):
                    raise AssertionError(f"{tag}: eval logged {evals}, best_metric.json {side}, "
                                         f"'best' steps {best}")
            if name == "warm-start" and "warm start: params from" not in out.getvalue():
                raise AssertionError(f"{tag}: warm-start printed {out.getvalue()[:500]}")
            results[name] = dict(losses=losses, evals=evals, seconds=seconds)
            log(f"{tag}: {name} ({' '.join(extra_options + extra)}): {VARIANT_STEPS} steps in "
                f"{seconds:.2f} s "
                f"(the command's own, model init and checkpoint included), losses "
                f"{[round(v, 5) for v in losses]}; K1, K2, K3 a step "
                f"{sorted(set(per_step))} (K1 0 on the {warmup} warm-up steps); all K1 launches "
                f"{k1.launches} (E-step calibration included), K2 {k23.launches} (eval "
                f"included), K3 {k23.bwd_launches}"
                + (f"; val mIoU (step, mIoU) {[(t, round(v, 6)) for t, v in evals]}, 'best' at "
                   f"{best}, best_metric.json {side}"
                   if name == "eval" else "") + f" ({card})")

        base = ExperimentConfig()
        data = SyntheticVOC(bs * HE_STEPS, base.model.num_classes, seed=0)
        for dtype in ("float32", "bfloat16"):
            cfg = base.replace(
                model=dataclasses.replace(base.model, init_scheme="he", compute_dtype=dtype,
                                          block1_impl="pallas" if dtype == "bfloat16" else "xla"),
                train=dataclasses.replace(base.train, log_every_steps=1),
                checkpoint=CheckpointConfig(save_dir=os.path.join(root, f"he-{dtype}"),
                                            save_every_steps=0, snapshot_on_lr_drop=False))
            trainer = Trainer(cfg, device=device, steps_per_epoch=HE_STEPS)
            logged, stopped = [], None
            batches = batch_iterator(data, cfg.data, batch_size=bs, seed=0)
            try:
                trainer.fit(trainer.init_state(), batches, num_steps=HE_STEPS,
                            log_fn=logged.append)
            except RuntimeError as e:
                if not str(e).startswith("training unhealthy"):
                    raise
                stopped = str(e)
            finally:
                batches.close()
            losses = [r["loss"] for r in logged]
            results[f"he-{dtype}"] = dict(losses=losses, stopped=stopped)
            log(f"{tag}: He init, {dtype}, reference LR {cfg.optim.base_lr}: losses of steps "
                f"0-{len(losses) - 1} {[round(v, 5) for v in losses]}; "
                f"{stopped or f'finite through step {HE_STEPS - 1}'} ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return results


def grads_bf16(device) -> dict:
    """One microstep at full width, bf16, He init, on one batch with the
    same dropout masks and E-step orders, through the fused block 1 (K2
    and K3) and through the cuDNN block 1. The two differ by the bias
    rounding rule (ops/block1.py) and in bf16 rounding throughout; block
    1's four leaves are held to a relative L2 difference of 0.1, above
    that noise and below what a fault of K3 gives (a position counted
    twice or never, a gradient routed to the wrong position: O(1))."""
    import dataclasses

    import torch

    from em_adapt_torch.config import ExperimentConfig
    from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model
    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops.estep import make_class_orders
    from em_adapt_torch.train.trainer import loss_fn, to_device

    base = ExperimentConfig()
    cfgs = {impl: base.replace(model=dataclasses.replace(
        base.model, init_scheme="he", compute_dtype="bfloat16", block1_impl=impl))
        for impl in ("pallas", "xla")}
    models = {"pallas": build_model(cfgs["pallas"].model, 3, device)}
    models["xla"] = DeepLabLargeFOV(cfgs["xla"].model).to(device)
    models["xla"].load_state_dict(models["pallas"].state_dict())
    data = SyntheticVOC(base.train.batch_size, base.model.num_classes, seed=2)
    it = batch_iterator(data, base.data, batch_size=base.train.batch_size, seed=0)
    batch = to_device(next(it), device)
    it.close()
    gen = torch.Generator(device).manual_seed(5)
    c = base.model.num_classes
    orders = make_class_orders(gen, base.estep.num_iter, c)
    out_hw = -(-base.model.input_size[0] // 8)
    shape = (base.train.batch_size, base.model.fc6_channels, out_hw, out_hw)
    keep = base.model.dropout_keep_prob
    masks = tuple(torch.rand(shape, generator=gen, device=device) < keep for _ in range(2))
    grads, metrics, launched = {}, {}, {}
    for impl, model in models.items():
        model.train()
        before = (k23.launches, k23.bwd_launches)
        total, metrics[impl] = loss_fn(model, batch, cfgs[impl], orders=orders, masks=masks)
        total.backward()
        torch.cuda.synchronize()
        launched[impl] = (k23.launches - before[0], k23.bwd_launches - before[1])
        grads[impl] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    if launched != {"pallas": (1, 1), "xla": (0, 0)}:
        raise AssertionError(f"K2/K3 launches {launched}, expected one each through the fused "
                             f"block and none through the conv path")
    weak_same = float((metrics["pallas"]["weak"] == metrics["xla"]["weak"]).float().mean())
    rel = {}
    for k in grads["xla"]:
        a, b = grads["pallas"][k], grads["xla"][k]
        if not torch.isfinite(a).all():
            raise AssertionError(f"grads_bf16: non-finite gradient {k}")
        rel[k] = float((a - b).norm() / b.norm())
    log(f"grads bf16: losses {float(metrics['pallas']['loss']):.6f} (K2+K3) vs "
        f"{float(metrics['xla']['loss']):.6f} (cuDNN block 1); weak labels equal at "
        f"{100 * weak_same:.4f}% of pixels")
    log("grads bf16: relative L2 difference per leaf: " + ", ".join(
        f"{k.removeprefix('layers.')} {v:.3e}" for k, v in rel.items()))
    block1 = {k: v for k, v in rel.items() if k.split(".")[1] in ("conv1_1", "conv1_2")}
    bad = {k: v for k, v in block1.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"block 1 gradients of K2+K3 and cuDNN differ by more than 0.1: "
                             f"{bad}")
    return dict(rel=rel, weak_same=weak_same)


def time_block1_train(device) -> dict:
    """Block 1's forward and backward (weight gradients, as in training)
    through K2+K3 and through the cuDNN bf16 chain, at B=6 and at the
    folded B=30, 321x321, in alternating rounds. The "auto" rule of
    models/deeplab.py::DeepLabLargeFOV._block1_mode rests on these
    numbers in training."""
    import torch
    import torch.nn.functional as F

    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.ops.conv import conv2d_same
    from em_adapt_torch.ops.pooling import max_pool_same

    out = {}
    for b in (6, 30):
        x, dy, *weights = bwd_case(np.random.default_rng(b), b, 321, "he", device)
        ws = [t.clone().requires_grad_(True) for t in weights]

        def fused():
            return torch.autograd.grad(k23.block1_fused(x, *ws), ws, dy)

        def chain():
            y = F.relu(conv2d_same(x, ws[0], ws[1], compute_dtype=torch.bfloat16))
            y = F.relu(conv2d_same(y, ws[2], ws[3], compute_dtype=torch.bfloat16))
            return torch.autograd.grad(max_pool_same(y, 3, 2), ws, dy)

        times = {"K2+K3": [], "cuDNN": []}
        for name, fn in (("K2+K3", fused), ("cuDNN", chain), ("cuDNN", chain), ("K2+K3", fused)):
            times[name].append(cuda_ms_per_launch(fn, launches=10, reps=3, warmup=2))
        ms = {k: statistics.median(v) for k, v in times.items()}
        out[b] = ms
        log(f"block1 train B={b} 321x321: forward + weight gradients K2+K3 {ms['K2+K3']:.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in times['K2+K3'])}), cuDNN bf16 chain "
            f"{ms['cuDNN']:.4f} ms ({', '.join(f'{t:.4f}' for t in times['cuDNN'])}); 10 "
            f"back-to-back calls between CUDA events, median of 3, two rounds each "
            f"(K2+K3, cuDNN, cuDNN, K2+K3)")
    faster = all(r["K2+K3"] < r["cuDNN"] for r in out.values())
    log(f"block1 train: K2+K3 faster at both batches: {faster} (block1_impl='auto' takes "
        f"them in training)")
    return out


def block1_case(rng: np.random.Generator, b: int, h: int, large_bias: bool, device):
    """K2's arguments: a normalized-range bf16 input (NCHW) and He-init
    weights (OIHW); with ``large_bias``, biases of the activations' own
    size, which would leak relu(b) into the border if the halo were not
    masked."""
    import torch

    x = torch.from_numpy((rng.uniform(0, 255, size=(b, 3, h, h)) - 117).astype(np.float32))
    w1 = torch.from_numpy((rng.normal(size=(64, 3, 3, 3)) * np.sqrt(2 / 27)).astype(np.float32))
    w2 = torch.from_numpy((rng.normal(size=(64, 64, 3, 3)) * np.sqrt(2 / 576)).astype(np.float32))
    if large_bias:
        b1, b2 = (torch.from_numpy(rng.uniform(20, 60, size=64).astype(np.float32)) for _ in "12")
    else:
        b1, b2 = (torch.from_numpy((rng.normal(size=64) * 0.1).astype(np.float32)) for _ in "12")
    return [t.to(device) for t in (x.to(torch.bfloat16), w1, b1, w2, b2)]


def explain_block1(name: str, args, got, want) -> int:
    """Logs where K2 and its plain version part, layer by layer: the y1
    values that an f32 ``F.conv2d`` (another summation order) rounds apart
    from ``conv1_plain``'s; K2 run with w2 the identity at the centre tap
    and b2 = 0 (its output is then the pool of its own y1) against the
    pool of ``conv1_plain``'s y1; and K2, the plain version and the same
    built on ``F.conv2d``'s y1 against a reference that sums conv1_2 of
    ``conv1_plain``'s y1 in f64 (then, as K2: f32, + b2, ReLU, bf16,
    pool). Returns the number of pooled y1 values where K2 and
    ``conv1_plain`` differ: 0 when conv1_1, its halo and its rounding are
    right. These launches of K2 are checks, not the main path."""
    import torch
    import torch.nn.functional as F

    from em_adapt_torch.ops import block1 as k2
    from em_adapt_torch.ops.pooling import max_pool_same

    x, w1, b1, w2, b2 = args
    bf = torch.bfloat16
    y1 = k2.conv1_plain(x, w1, b1)
    y1_conv = F.relu(F.conv2d(x.float(), w1.to(bf).float(), padding=1)
                     + b1.float()[None, :, None, None]).to(bf)
    eye = torch.zeros_like(w2)
    eye[range(64), range(64), 1, 1] = 1
    pooled_y1 = k2.block1_fused(x, w1, b1, eye, torch.zeros_like(b2))
    y1_apart = int((pooled_y1 != max_pool_same(y1, 3, 2)).sum())

    def conv2_pool(y1, dt):
        y2 = F.conv2d(y1.to(dt), w2.to(bf).to(dt), padding=1).float()
        return max_pool_same(F.relu(y2 + b2.float()[None, :, None, None]).to(bf), 3, 2)

    ref = conv2_pool(y1, torch.float64)
    parts = [f"F.conv2d rounds {int((y1_conv != y1).sum())} of {y1.numel()} y1 values apart "
             f"from conv1_plain", f"K2's pooled y1 differs from conv1_plain's at {y1_apart} of "
             f"{pooled_y1.numel()} values"]
    for who, t in (("K2", got), ("plain", want),
                   ("plain on F.conv2d's y1", conv2_pool(y1_conv, torch.float32))):
        st = k2.bf16_steps(t, ref)
        diff = (t.float() - ref.float()).abs()
        far = st > 1
        i = int(st.argmax())
        parts.append(f"{who} vs the f64 reference: {100 * float((st == 0).float().mean()):.4f}% "
                     f"bit-equal, {int(far.sum())} elements > 1 step (largest |reference| "
                     f"{float(ref.float().abs()[far].max()) if far.any() else 0:.4g}, max|diff| "
                     f"{float(diff[far].max()) if far.any() else 0:.3e}), max {int(st.max())} "
                     f"steps ({float(t.flatten()[i]):.6g} vs {float(ref.flatten()[i]):.6g}), "
                     f"max|diff| {float(diff.max()):.3e}")
    log(f"K2 {name}: " + "; ".join(parts))
    return y1_apart


def check_block1(device, timed: bool) -> dict:
    """K2 against its plain version on the card: within one bf16 step per
    element (an f32 sum of 576 products in another order may round to the
    neighbouring bf16 value), the step taken at no less than 2^-12 of the
    largest output (``ops/block1.py::bf16_close`` says why), at least
    99.9% of the elements bit-equal, and its y1 exactly ``conv1_plain``'s
    (:func:`explain_block1`, which logs where the two part), on every case
    of :data:`K2_CASES`; its build spills nothing and its shared memory fits
    a block. With ``timed``, its times at the main path's shape (B=6,
    321x321) beside the plain version, the cuDNN chain of the conv path, the
    bound and the time of the K2 whose phases ran one after another."""
    import torch
    import torch.nn.functional as F

    from em_adapt_torch.ops import block1 as k2
    from em_adapt_torch.ops.conv import conv2d_same
    from em_adapt_torch.ops.pooling import max_pool_same
    from em_adapt_torch.tools.bench_block1_bwd_parts import ptxas_report
    from em_adapt_torch.utils import build

    build.build("block1_fwd")
    report = ptxas_report(build.build_logs[("block1_fwd", ())], "block1_fwd_kernel")
    smem = k2._lib("block1_fwd").em_block1_fwd_smem_bytes()
    log(f"K2 build: ptxas {report['registers']} registers, {report['spill_stores']} B spill "
        f"stores, {report['spill_loads']} B spill loads; {smem} B of dynamic shared memory "
        f"per CTA of the 232,448 B a block can use")
    if report["spill_stores"] or report["spill_loads"] or smem > 232448:
        raise AssertionError(f"K2 spills registers or takes too much shared memory: {report}, "
                             f"{smem} B")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_err, failed = 0.0, []
    for name, b, h, large in K2_CASES:
        args = block1_case(np.random.default_rng(10 * h + b), b, h, large, device)
        before = k2.launches
        got = k2.block1_fused(*args)
        torch.cuda.synchronize()
        if k2.launches != before + 1:
            raise AssertionError(f"K2 {name}: the block1 kernel was not launched")
        want = k2.block1_plain(*args)
        if got.shape != want.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"K2 {name}: {got.dtype} {tuple(got.shape)} != {tuple(want.shape)}")
        steps = k2.bf16_steps(got, want)
        diff = (got.float() - want.float()).abs()
        err, scale = float(diff.max()), float(want.float().abs().max())
        worst = int(steps.max())
        far = steps > 1
        extra = ""
        if far.any():
            extra = (f"; {int(far.sum())} elements > 1 step, the largest |plain| among them "
                     f"{float(want.float().abs()[far].max()):.3e}, their max|diff| "
                     f"{float(diff[far].max()):.3e}")
        equal = float((steps == 0).float().mean())
        y1_apart = explain_block1(name, args, got, want)
        if not bool(k2.bf16_close(got, want).all()) or equal < 0.999 or y1_apart:
            failed.append(name)
        max_err = max(max_err, err)
        oh = (h + 1) // 2
        tiles = b * -(-oh // 7) * -(-oh // 8)
        log(f"K2 {name}: {tiles} tiles on {min(tiles, sms)} CTAs; {100 * equal:.4f}% bit-equal "
            f"to plain, {100 * float((steps <= 1).float().mean()):.4f}% within 1 bf16 step, max "
            f"{worst} steps, max|kernel-plain| {err:.3e} (max|plain| {scale:.3e}, "
            f"min {float(want.float().min()):.3e}){extra}")
    if failed:
        raise AssertionError(f"K2 more than one bf16 step (floored) from plain, under 99.9% "
                             f"bit-equal, or its y1 not conv1_plain's, in {failed}")
    if not timed:
        return dict(max_abs_err=max_err)

    b, h = 6, 321
    args = block1_case(np.random.default_rng(6), b, h, False, device)
    x, w1, b1, w2, b2 = args

    def run():
        return k2.block1_fused(*args)

    def library():
        """The conv path's cuDNN bf16 chain for the same function (its
        bias in bf16 after the rounding)."""
        y = F.relu(conv2d_same(x, w1, b1, compute_dtype=torch.bfloat16))
        y = F.relu(conv2d_same(y, w2, b2, compute_dtype=torch.bfloat16))
        return max_pool_same(y, 3, 2)

    ms = cuda_ms_per_launch(run, launches=100, reps=5, warmup=3)
    prof_ms = profiled_kernel_ms(run, "block1_fwd_kernel", launches=20)
    library_ms = cuda_ms_per_launch(library, launches=100, reps=5, warmup=3)
    plain_ms = cuda_ms(lambda: k2.block1_plain(*args), reps=5, warmup=1)
    oh = (h + 1) // 2
    ops = 2 * 27 * 64 * h * h * b + 2 * 576 * 64 * h * h * b
    bytes_moved = 2 * (b * 3 * h * h + b * 64 * oh * oh + 64 * 27 + 64 * 576) + 4 * 2 * 64
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    prof_text = f"{prof_ms:.4f} ms" if prof_ms is not None else "not measured"
    log(f"K2 time B={b} {h}x{h}: kernel {ms:.4f} ms per launch (device time: 100 back-to-back "
        f"launches between CUDA events, median of 5), profiler device time {prof_text} (mean "
        f"of 20); cuDNN bf16 chain (library call) {library_ms:.4f} ms per call, back-to-back "
        f"the same way; plain {plain_ms:.2f} ms (median of 5 single calls); bound "
        f"{bound_ms:.6f} ms by {bound_by} ({ops} FLOP at "
        f"{BF16_TENSOR_OPS_PER_S / 1e12:.1f} TFLOP/s, {bytes_moved} B at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); {ops / ms / 1e9:.1f} TFLOP/s achieved")
    log(f"K2 {ms:.4f} ms per launch against {K2_SERIAL_MS:.4f} ms for the K2 whose phases ran "
        f"one after another (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and {library_ms:.4f} ms for "
        f"the cuDNN chain in this run: {ms / library_ms:.3f} of the chain's time")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k3_flops(b: int, h: int) -> tuple[int, int]:
    """K3's operations at batch b, h x h: (with the forward recomputed, as
    the TPU kernel and K3 do it; without it). The recompute belongs to the
    function: from x, dy and the weights, the routing and the masks need
    y1 and y2."""
    per = 2 * h * h * b * 64
    fwd = per * (27 + 576)
    return fwd + per * (576 + 576 + 27), per * (576 + 576 + 27)


def k3_bound(b: int, h: int) -> dict:
    """K3's bound at batch b, h x h: the larger of its operations (with the
    recompute) at the dense bf16 peak and the bytes of x, dy, the weights
    and the f32 gradients at the HBM rate."""
    ops, ops_no_recompute = k3_flops(b, h)
    oh = (h + 1) // 2
    bytes_moved = (2 * (b * 3 * h * h + b * 64 * oh * oh + 64 * 27 + 64 * 576) + 4 * 2 * 64
                   + 4 * (64 * 27 + 64 + 64 * 576 + 64))
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes", ops=ops,
                ops_no_recompute=ops_no_recompute, bytes=bytes_moved, bytes_ms=t_bytes * 1e3)


def chain_backward(x, dy, w1, b1, w2, b2):
    """The library call for K3's function: ``torch.autograd.grad`` through
    the conv path's cuDNN bf16 chain (conv, bias, ReLU, conv, bias, ReLU,
    pool), backward only (its graph kept); returns the call."""
    import torch
    import torch.nn.functional as F

    from em_adapt_torch.ops.conv import conv2d_same
    from em_adapt_torch.ops.pooling import max_pool_same

    ws = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    y = F.relu(conv2d_same(x, ws[0], ws[1], compute_dtype=torch.bfloat16))
    y = F.relu(conv2d_same(y, ws[2], ws[3], compute_dtype=torch.bfloat16))
    out = max_pool_same(y, 3, 2)
    return lambda: torch.autograd.grad(out, ws, dy, retain_graph=True)


def bwd_case(rng: np.random.Generator, b: int, h: int, kind: str, device):
    """K3's arguments: x, dy and the weights. ``kind`` "he": a normalized-
    range input, He-init weights, small biases; "large bias": biases
    U(20, 60) (the halo must stay masked); "ties": integer-valued x with a
    flat patch and integer weights, so that windows tie exactly (the case
    of tests/test_block1_pallas.py:125-147)."""
    import torch

    if kind == "ties":
        xi = rng.integers(0, 3, size=(b, 3, h, h)).astype(np.float32)
        xi[:, :, :6, :6] = 1.0
        x = torch.from_numpy(xi)
        w1 = torch.from_numpy(rng.integers(-2, 3, size=(64, 3, 3, 3)).astype(np.float32))
        w2 = torch.from_numpy(rng.integers(-2, 3, size=(64, 64, 3, 3)).astype(np.float32))
        b1, b2 = torch.zeros(64), torch.zeros(64)
        args = [x.to(torch.bfloat16), w1, b1, w2, b2]
    else:
        args = block1_case(rng, b, h, kind == "large bias", "cpu")
    oh = (h + 1) // 2
    dy = torch.from_numpy(rng.normal(size=(b, 64, oh, oh)).astype(np.float32)).to(torch.bfloat16)
    x, w1, b1, w2, b2 = (t.to(device) for t in args)
    return x, dy.to(device), w1, b1, w2, b2


def check_block1_bwd(device, timed: bool) -> dict:
    """K3 against its plain version on the card, per leaf (dw1, db1, dw2,
    db2): max|diff| / max|plain| and the relative L2 difference. Both
    recompute y1 bit for bit and route, mask and round at the same points,
    and K3 owns each y1 and y2 position in one tile (it rounds the whole
    dz1, as the plain version does). What is left: the order of f32 sums
    (conv1_2's 576 products, dy1's, the dW sums over the image); and where
    that order rounds a y2 value to the neighbouring bf16 step (0.0075% of
    the pooled outputs in K2's check at B=6), a window near a tie routes
    its whole gradient to another position, or a y2 near 0 flips its ReLU
    mask. So: on integer-valued inputs ("ties": every y2 an exact f32 sum,
    rounded alike on both sides) 1e-4 of each leaf's scale in both
    measures; on real-valued ones 1e-2 (max) and 2e-3 (L2), which a few
    thousand rerouted windows stay under at B=6 (first measured: 4.2e-3
    and 7.8e-4) and a fault of the tiling (a position counted twice or
    never: O(1)) does not. Two runs of K3 give the same bits. With
    ``timed``, its times at the main path's shape (B=6, 321x321) beside
    the plain version, the cuDNN bf16 chain's backward, the bound and
    the read-add-write K3's recorded time; untimed too, its shared
    memory per CTA and the reductions in its SASS."""
    import torch

    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.utils import build

    cases = [("B=6 321x321", 6, 321, "he"), ("B=6 321x321 ties", 6, 321, "ties"),
             ("B=1 33x33", 1, 33, "he"), ("B=2 41x41 large bias", 2, 41, "large bias"),
             ("B=2 33x33 ties", 2, 33, "ties"), ("B=1 65x65", 1, 65, "he")]
    names = ("dw1", "db1", "dw2", "db2")
    max_err, failed = 0.0, []
    for name, b, h, kind in cases:
        x, dy, w1, b1, w2, b2 = bwd_case(np.random.default_rng(10 * h + b), b, h, kind, device)
        before = k23.bwd_launches
        got = k23.block1_bwd(x, dy, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if k23.bwd_launches != before + 1:
            raise AssertionError(f"K3 {name}: the block1 backward kernel was not launched")
        want = k23.block1_bwd_plain(x, w1, b1, w2, b2, dy)
        parts = []
        for leaf, g, wnt in zip(names, got, want):
            if g.shape != wnt.shape or g.dtype != torch.float32 or not torch.isfinite(g).all():
                raise AssertionError(f"K3 {name} {leaf}: {g.dtype} {tuple(g.shape)}, finite "
                                     f"{bool(torch.isfinite(g).all())}")
            scale = float(wnt.abs().max())
            err = float((g - wnt).abs().max())
            rel = float((g - wnt).norm() / wnt.norm()) if scale > 0 else err
            tol_max, tol_l2 = (1e-4, 1e-4) if kind == "ties" else (1e-2, 2e-3)
            if err > tol_max * scale or rel > tol_l2:
                failed.append(f"{name} {leaf}")
            max_err = max(max_err, err)
            parts.append(f"{leaf} max|diff|/max|plain| {err / max(scale, 1e-30):.3e} (max|plain| "
                         f"{scale:.3e}), rel L2 {rel:.3e}")
        if kind == "he" and b == 6:
            apart = int((k23.block1_fused(x, w1, b1, w2, b2)
                         != k23.block1_plain(x, w1, b1, w2, b2)).sum())
            parts.append(f"K2 and block1_plain differ at {apart} pooled outputs (their y2 "
                         f"sums in another order)")
        log(f"K3 {name}: " + "; ".join(parts))
        if b == 6:
            again = k23.block1_bwd(x, dy, w1, b1, w2, b2)
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            log(f"K3 {name}: a second run gives the same bits: {same}")
            if not same:
                failed.append(f"{name} rerun")
    if failed:
        raise AssertionError(f"K3 outside its bound of the plain version, or not reproducible, "
                             f"in {failed}")
    log(f"K3 dynamic shared memory per CTA: "
        f"{k23._lib('block1_bwd').em_block1_bwd_smem_bytes()} B of the 232,448 B a block can use")
    library = build.build("block1_bwd")
    ftz = {t: build.sass_count(library, f"REDG.E.ADD.{t}.FTZ") for t in ("F32", "F32x2", "F32x4")}
    log(f"K3's SASS: {build.sass_count(library, 'REDG')} REDG reductions into the partial row, "
        f"f32 adds that flush subnormals (.FTZ) among them: {ftz}")
    if not timed:
        return dict(max_abs_err=max_err)

    b, h = 6, 321
    x, dy, w1, b1, w2, b2 = bwd_case(np.random.default_rng(6), b, h, "he", device)

    def run():
        return k23.block1_bwd(x, dy, w1, b1, w2, b2)

    ms = cuda_ms_per_launch(run, launches=100, reps=5, warmup=3)
    prof_ms = profiled_kernel_ms(run, "block1_bwd_kernel", launches=20)
    red_ms = profiled_kernel_ms(run, "block1_bwd_reduce", launches=20)
    library_ms = cuda_ms_per_launch(chain_backward(x, dy, w1, b1, w2, b2), launches=100, reps=5,
                                    warmup=3)
    plain_ms = cuda_ms(lambda: k23.block1_bwd_plain(x, w1, b1, w2, b2, dy), reps=5, warmup=1)
    bound = k3_bound(b, h)
    ops = bound["ops"]

    def text(v):
        return f"{v:.4f} ms" if v is not None else "not measured"

    log(f"K3 time B={b} {h}x{h}: kernel {ms:.4f} ms per launch (device time: 100 back-to-back "
        f"launches between CUDA events, the partial-sum reduction included, median of 5), "
        f"profiler device time {text(prof_ms)} for the main kernel and {text(red_ms)} for "
        f"the reduction (mean of 20); cuDNN bf16 chain backward (library call) "
        f"{library_ms:.4f} ms per call, back-to-back the same way; plain {plain_ms:.2f} ms "
        f"(median of 5 single calls); bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
        f"({ops} FLOP with the recompute at {BF16_TENSOR_OPS_PER_S / 1e12:.1f} TFLOP/s; "
        f"{bound['ops_no_recompute'] / BF16_TENSOR_OPS_PER_S * 1e3:.6f} ms for the "
        f"{bound['ops_no_recompute']} FLOP without it; {bound['bytes']} B at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s give {bound['bytes_ms']:.6f} ms); "
        f"{ops / ms / 1e9:.1f} TFLOP/s achieved")
    log(f"K3 {ms:.4f} ms per launch against {K3_READ_ADD_WRITE_MS:.4f} ms for the read-add-write "
        f"K3 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and {library_ms:.4f} ms for the cuDNN "
        f"chain's backward in this run: {ms / library_ms:.3f} of the chain's time")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def check_block1_bwd_parts(device, timed: bool) -> dict:
    """K3's per-part builds (``em_adapt_torch/tools/bench_block1_bwd_parts.py``,
    the port of the probe ``tools/bench_block1_bwd_parts.py:169``): every
    variant built with no spills, its ptxas report and the HMMA
    instructions of its SASS printed, ``skip_update`` with as many as
    ``full`` (no product dropped with the updates); ``full`` on K3's own
    library and bit-equal to K3; every variant but ``skip_update``
    against its plain version per leaf: on integer-valued inputs at B=6,
    321^2 within 1e-4 of the leaf's scale in max and L2 (a leaf the variant
    zeroes must be exactly 0), on one real-valued case (B=1, 33^2) within
    K3's bounds (max 1e-2, L2 2e-3; ``check_block1_bwd`` says why); its
    ``max_abs_err`` is the worst variant's at B=6, 321^2. With ``timed``,
    the probe's own path: every variant's time at B=6, 321^2 on the
    probe's inputs as the tool times it, its variant launches counted from
    0 and held to the count the timing makes; beside ``full`` its plain
    version, the cuDNN chain's backward and K3's bound."""
    import torch

    from em_adapt_torch.ops import block1 as k23
    from em_adapt_torch.tools import bench_block1_bwd_parts as parts
    from em_adapt_torch.utils import build

    paths = parts.build_variants()
    if paths["full"] != build.build("block1_bwd"):
        raise AssertionError(f"K3 parts: full's library {paths['full'].name} is not K3's own")
    reports = parts.variant_reports(paths)
    for name, r in reports.items():
        log(f"K3 parts {name} ({' '.join(parts.VARIANTS[name].defines) or 'no macro'}): ptxas "
            f"{r['registers']} registers, {r['spill_stores']} B spill stores, "
            f"{r['spill_loads']} B spill loads, {r['static_smem']} B static smem; "
            f"{r['hmma']} HMMA in its SASS; {r['library']}")
    spilled = [n for n, r in reports.items() if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"K3 parts: {spilled} spill registers")
    if reports["skip_update"]["hmma"] != reports["full"]["hmma"]:
        raise AssertionError(f"K3 parts: skip_update has {reports['skip_update']['hmma']} HMMA "
                             f"against full's {reports['full']['hmma']}: products were dropped")

    args = bwd_case(np.random.default_rng(66), 6, 321, "he", device)
    got = parts.block1_bwd_parts(*args, "full")
    want = k23.block1_bwd(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"K3 parts: full differs from K3 by "
                             f"{max(float((g - w).abs().max()) for g, w in zip(got, want))}")
    log(f"K3 parts full: K3's own library ({paths['full'].name}), bit-equal to K3 at B=6 "
        f"321x321")

    failed, max_err = [], 0.0  # max_err: the worst variant's max|diff| at B=6, 321^2
    for case, b, h, kind, tol_max, tol_l2 in (("B=6 321x321 ties", 6, 321, "ties", 1e-4, 1e-4),
                                              ("B=1 33x33", 1, 33, "he", 1e-2, 2e-3)):
        x, dy, w1, b1, w2, b2 = bwd_case(np.random.default_rng(10 * h + b), b, h, kind, device)
        for name in parts.VARIANTS:
            if name == "skip_update":
                continue
            before = parts.launches
            got = parts.block1_bwd_parts(x, dy, w1, b1, w2, b2, name)
            torch.cuda.synchronize()
            if parts.launches != before + 1:
                raise AssertionError(f"K3 parts {name}: the variant was not launched")
            want = parts.block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, name)
            texts = []
            for leaf, g, w in zip(("dw1", "db1", "dw2", "db2"), got, want):
                if g.shape != w.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"K3 parts {name} {case} {leaf}: {tuple(g.shape)}, "
                                         f"finite {bool(torch.isfinite(g).all())}")
                scale = float(w.abs().max())
                err = float((g - w).abs().max())
                if b == 6:
                    max_err = max(max_err, err)
                rel = float((g - w).norm() / w.norm()) if scale > 0 else err
                if err > tol_max * scale or rel > tol_l2:
                    failed.append(f"{name} {case} {leaf}")
                texts.append(f"{leaf} max|diff|/max|plain| {err / max(scale, 1e-30):.3e} "
                             f"(max|plain| {scale:.3e}), rel L2 {rel:.3e}")
            log(f"K3 parts {name} {case}: " + "; ".join(texts))
    if failed:
        raise AssertionError(f"K3 parts outside their bound of the plain versions: {failed}")
    if not timed:
        return dict(max_abs_err=max_err)

    b, h, iters, reps, warmup = 6, 321, 100, 5, 3
    parts.launches = 0  # the probe's path: the timing run below
    ms = parts.time_variants(device, b, iters=iters, reps=reps, warmup=warmup)
    launches = parts.launches
    if launches != len(parts.VARIANTS) * (warmup + reps * iters):
        raise AssertionError(f"K3 parts: {launches} variant launches in the timing run, expected "
                             f"{len(parts.VARIANTS)} x ({warmup} + {reps} x {iters})")
    for record in parts.records(reports, ms, b, h):
        log("K3 parts " + json.dumps(record))
    log(f"K3 parts: {parts.NOTE} Times: {iters} back-to-back launches between CUDA events, the "
        f"partial-sum reduction included, median of {reps} rounds that take the variants in "
        f"turn; {launches} variant launches in all.")
    x, dy, w1, b1, w2, b2 = parts.probe_inputs(b, h, device)
    plain_ms = cuda_ms(lambda: parts.block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, "full"),
                       reps=5, warmup=1)
    library_ms = cuda_ms_per_launch(chain_backward(x, dy, w1, b1, w2, b2), launches=100, reps=5,
                                    warmup=3)
    bound = k3_bound(b, h)
    log(f"K3 parts full B={b} {h}x{h} on the probe's inputs: {ms['full']:.4f} ms per launch; "
        f"plain {plain_ms:.2f} ms (median of 5 single calls); cuDNN bf16 chain backward "
        f"(library call) {library_ms:.4f} ms; bound {bound['bound_ms']:.6f} ms by "
        f"{bound['bound_by']}")
    return dict(max_abs_err=max_err, ms=ms["full"], plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], launches=launches)


def evaluate(device) -> dict:
    """The evaluation path: ``Evaluator`` at full width, bf16, 321x321,
    eval batch 6, He init, over ``EVAL_IMAGES`` synthetic val images, once
    with the fused block1 (K2) and once with the cuDNN conv path."""
    import dataclasses

    import torch

    from em_adapt_torch.config import ExperimentConfig
    from em_adapt_torch.data.pipeline import DevicePrefetcher, SyntheticVOC, batch_iterator
    from em_adapt_torch.eval.miou import miou_from_confusion
    from em_adapt_torch.eval.predict import Evaluator
    from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model
    from em_adapt_torch.ops import block1 as k2

    base = ExperimentConfig()
    cfgs = {impl: base.replace(model=dataclasses.replace(
        base.model, init_scheme="he", compute_dtype="bfloat16", block1_impl=impl))
        for impl in ("pallas", "xla")}
    c = base.model.num_classes
    model = build_model(cfgs["pallas"].model, 0, device)
    conv_model = DeepLabLargeFOV(cfgs["xla"].model).to(device)
    conv_model.load_state_dict(model.state_dict())
    evs = {"pallas": Evaluator(cfgs["pallas"], model), "xla": Evaluator(cfgs["xla"], conv_model)}
    data = SyntheticVOC(EVAL_IMAGES, c, seed=1)
    bs = base.eval.batch_size
    log(f"eval: DeepLab-LargeFOV {sum(p.numel() for p in model.parameters())} params, input "
        f"{base.model.input_size}, eval batch {bs}, bf16, init he, {EVAL_IMAGES} images")
    warm = np.zeros((bs, *base.model.input_size, 3), np.float32)
    for ev in evs.values():
        ev.predict_batch(warm)
    torch.cuda.synchronize()

    out = {}
    for impl, ev in evs.items():
        kept, pixels, fetch_s = [], [0], [0.0]

        def batches():
            it = batch_iterator(data, base.data, batch_size=bs, seed=0, epochs=1, train=False)
            while True:
                t = time.perf_counter()
                batch = next(it, None)
                fetch_s[0] += time.perf_counter() - t
                if batch is None:
                    return
                pixels[0] += int((batch["label"] < c).sum())
                kept.append(batch)
                yield batch

        k2.launches = 0
        t0 = time.perf_counter()
        cm = ev.confusion_fixed(batches())  # ends in a device-to-host copy
        wall = time.perf_counter() - t0
        miou, _ = miou_from_confusion(cm)
        out[impl] = dict(cm=cm, wall=wall, pixels=pixels[0], launches=k2.launches,
                         batches=kept, miou=miou)
        log(f"eval {impl}: {len(kept)} batches, K2 launches {k2.launches}, confusion total "
            f"{int(cm.sum())} of {pixels[0]} non-void pixels, mIoU {miou:.6f}, wall "
            f"{wall:.3f} s, {EVAL_IMAGES / wall:.2f} images/s (whole window, batch fetch "
            f"included); the host's batch fetch took {fetch_s[0]:.3f} s of it")
    k2.launches = 0
    t0 = time.perf_counter()
    with DevicePrefetcher(batch_iterator(data, base.data, batch_size=bs, seed=0, epochs=1,
                                         train=False), device, depth=base.data.prefetch) as pf:
        cm = evs["pallas"].confusion_fixed(pf)
    wall = time.perf_counter() - t0
    if not np.array_equal(cm, out["pallas"]["cm"]) or k2.launches != len(out["pallas"]["batches"]):
        raise AssertionError(f"eval pallas through the prefetcher: K2 launched {k2.launches} "
                             "times, or its confusion matrix differs from the unprefetched one")
    prefetched_wall = wall
    log(f"eval pallas through DevicePrefetcher (depth {base.data.prefetch}): K2 launches "
        f"{k2.launches}, confusion matrix equal to the unprefetched pass's, wall {wall:.3f} s, "
        f"{EVAL_IMAGES / wall:.2f} images/s (whole window)")
    x_dev = torch.from_numpy(out["pallas"]["batches"][0]["image"]).to(device)
    fwd = {impl: [] for impl in evs}
    for _ in range(3):  # rounds that alternate the modes, so both see the card alike
        for impl, ev in evs.items():
            fwd[impl].append(cuda_ms_per_launch(lambda: ev.predict_batch(x_dev), launches=20,
                                                reps=3, warmup=1))
    for impl, times in fwd.items():
        fwd_ms = statistics.median(times)
        log(f"eval {impl}: predict_batch of a device-resident batch of {bs}: {fwd_ms:.3f} ms "
            f"(20 back-to-back calls between CUDA events, median of 3 alternating rounds of 3: "
            f"{', '.join(f'{t:.3f}' for t in times)}), {bs / fwd_ms * 1e3:.1f} images/s")
    p, x = out["pallas"], out["xla"]
    want_batches = -(-EVAL_IMAGES // bs)
    if len(p["batches"]) != want_batches or p["launches"] != want_batches:
        raise AssertionError(f"K2 launched {p['launches']} times in {len(p['batches'])} "
                             f"batches, expected {want_batches}")
    if x["launches"] != 0:
        raise AssertionError(f"the conv path launched K2 {x['launches']} times")
    for impl, r in out.items():
        if int(r["cm"].sum()) != r["pixels"]:
            raise AssertionError(f"{impl}: confusion total {int(r['cm'].sum())} != "
                                 f"{r['pixels']} non-void pixels")
        if not (math.isfinite(r["miou"]) and 0.0 <= r["miou"] <= 1.0):
            raise AssertionError(f"{impl}: mIoU {r['miou']}")
    if x["pixels"] != p["pixels"]:
        raise AssertionError(f"pixel totals differ: {p['pixels']} vs {x['pixels']}")
    same = total = 0
    for batch in p["batches"]:
        real = torch.tensor([i != "__pad__" for i in batch["id"]], device=device)
        a, b = evs["pallas"].predict_batch(batch["image"]), evs["xla"].predict_batch(batch["image"])
        same += int(((a == b) & real[:, None, None]).sum())
        total += int(real.sum()) * a.shape[1] * a.shape[2]
    agree = same / total
    log(f"eval: K2 and cuDNN block1 predict the same class at {100 * agree:.4f}% of "
        f"{total} pixels; mIoU {p['miou']:.6f} vs {x['miou']:.6f}")
    if agree < 0.99:
        raise AssertionError(f"K2 and cuDNN block1 agree at only {100 * agree:.4f}% of pixels")
    return dict(launches=p["launches"], images_per_s=EVAL_IMAGES / p["wall"],
                conv_images_per_s=EVAL_IMAGES / x["wall"],
                prefetched_images_per_s=EVAL_IMAGES / prefetched_wall, agree=agree)


def phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, with its seconds logged after it."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="stop after the kernel checks")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="after the checks, profile N more training steps")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if PORT_MISSING is not None:
        print(f"chip_smoke: the em_adapt_torch package is missing: {PORT_MISSING}",
              file=sys.stderr)
        return 2
    from em_adapt_torch.device import set_precision
    from em_adapt_torch.tools import bench_block1_bwd_parts as parts
    from em_adapt_torch.utils import build

    device = torch.device("cuda", 0)
    card = card_info()
    log(card)
    set_precision("float32")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    sources = ("estep", "block1_fwd", "block1_bwd")
    variants = [v.defines for v in parts.VARIANTS.values() if v.defines]
    jobs = [(name, ()) for name in sources] + [("block1_bwd", d) for d in variants]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per source and variant, together
        list(pool.map(lambda job: build.build(*job), jobs))
    log(f"build: csrc/{{{','.join(sources)}}}.cu and {len(variants)} variants of block1_bwd.cu "
        f"in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in build.build_logs.get((name, ()), "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    k1_result = phase("K1 check", check_estep, device)
    k2_result = phase("K2 check", check_block1, device, timed=not args.quick)
    k3_result = phase("K3 check", check_block1_bwd, device, timed=not args.quick)
    parts_result = phase("K3 parts", check_block1_bwd_parts, device, timed=not args.quick)
    if args.quick:
        return 0
    check_model_small_input(device)
    train_result = phase("train f32", train, device, STEPS, args.profile)
    parts.launches = 0
    bf16_result = phase("train bf16", train, device, STEPS, args.profile, bf16=True)
    if parts.launches:
        raise AssertionError(f"the bf16 training run launched {parts.launches} K3 variants")
    in_step, t6 = bf16_result["k1_in_step"], k1_result["timing"][6]
    log(f"K1 on one bf16 training step's own E-step inputs {in_step['shape']}: "
        f"{in_step['ms']:.4f} ms per launch (100 back-to-back launches between CUDA events, "
        f"median of 20), profiler device time {measured(in_step['prof_ms'], 4, 'ms')}, fixed "
        f"cost {measured(in_step['fixed_ms'], 4, 'ms')}, {measured(in_step['visit_us'], 3, 'us')} "
        f"a present visit ({k1_result['rounds']} block rounds each); present class visits per "
        f"image {in_step['present']}. On realistic_batch B=6: {t6['ms']:.4f} ms, profiler "
        f"{measured(t6['prof_ms'], 4, 'ms')}, fixed {measured(t6['fixed_ms'], 4, 'ms')}, "
        f"{measured(t6['visit_us'], 3, 'us')} a visit, present visits per image {t6['present']}")
    phase("resume bf16", resume, device, card)
    phase("input bf16", input_phase, device, card)
    phase("input VOC", voc_tree_phase, device, card)
    phase("loop bf16", loop_phase, device, card)
    phase("variants bf16", variants_phase, device, card)
    phase("grads bf16", grads_bf16, device)
    phase("block1 timing", time_block1_train, device)
    eval_result = phase("eval", evaluate, device)
    kernels = [{
        "name": "estep",
        "route": "cuda",
        "source": "em_adapt_torch/csrc/estep.cu",
        "replaces": "em_adapt_tpu/ops/estep_pallas.py:52",
        "launches": train_result["launches"]["estep"],
        "max_abs_err": k1_result["max_abs_err"],
        "ms": t6["ms"],
        "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"],
        "bound_by": t6["bound_by"],
        "library_ms": None,
    }, {
        "name": "block1_fwd",
        "route": "cuda",
        "source": "em_adapt_torch/csrc/block1_fwd.cu",
        "replaces": "em_adapt_tpu/ops/block1_pallas.py:352",
        "launches": eval_result["launches"],
        "max_abs_err": k2_result["max_abs_err"],
        "ms": k2_result["ms"],
        "plain_ms": k2_result["plain_ms"],
        "bound_ms": k2_result["bound_ms"],
        "bound_by": k2_result["bound_by"],
        "library_ms": k2_result["library_ms"],
    }, {
        "name": "block1_bwd",
        "route": "cuda",
        "source": "em_adapt_torch/csrc/block1_bwd.cu",
        "replaces": "em_adapt_tpu/ops/block1_pallas.py:363",
        "launches": bf16_result["launches"]["block1_bwd"],
        "max_abs_err": k3_result["max_abs_err"],
        "ms": k3_result["ms"],
        "plain_ms": k3_result["plain_ms"],
        "bound_ms": k3_result["bound_ms"],
        "bound_by": k3_result["bound_by"],
        "library_ms": k3_result["library_ms"],
    }, {
        "name": "block1_bwd_parts",
        "route": "cuda",
        "source": "em_adapt_torch/csrc/block1_bwd.cu",
        "replaces": "tools/bench_block1_bwd_parts.py:169",
        "launches": parts_result["launches"],
        "max_abs_err": parts_result["max_abs_err"],
        "ms": parts_result["ms"],
        "plain_ms": parts_result["plain_ms"],
        "bound_ms": parts_result["bound_ms"],
        "bound_by": parts_result["bound_by"],
        "library_ms": parts_result["library_ms"],
    }]
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s from its imports to the results")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
