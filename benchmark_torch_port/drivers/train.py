"""The training window: ``Trainer.fit`` on device-resident batches.

Set-up makes the weights on the card from the seed, builds the train
state (the port's model, ``AccumulatingSGD`` and dropout generator, as
``Trainer.init_state`` builds them) and a pool of batches, and drives that
state through ``fit`` for the traffic's ``warmup_steps`` steps on the
window's own feed: the first of them are the ones the comparison reads.
The window is one ``fit`` call on the same state and feed until
``--seconds`` have passed, ended by a synchronize. With ``--trace 1`` the
same ``fit`` call runs on past the deadline under ``torch.profiler``: one
step to settle it, then a span of ``trace_steps`` steps between two
synchronizes, which the trace's readings take (``fit``'s own start and end
stay out of it).
After that the reference follows the first steps from the same weights,
batches and draws, and the comparison reads:

* ``loss_gap``: the worst of the first steps' relative loss gaps;
* ``grad_gap``: the first microbatch's gradient as the optimizer holds it
  after one step (SGD's momentum buffer, or the accumulator), by the worst
  leaf (``harness.leaf_gap``);
* ``data_grad_gap``: the first microbatch's gradient of the cross-entropy
  alone, by the worst leaf, as the backward pass hands it to each
  parameter (cuDNN's and K3's weight gradients, in float32), read by hooks
  on the autograd graph before it is summed with the weight decay's
  ``wd * w``. Under the reference init ``wd * w`` is most of a weight's
  gradient (its norm about 1.5e-4 against 2-8e-5 for the cross-entropy's
  at 321x321), so a wrong weight gradient moves the sum that the
  optimizer holds by a few percent only; this number reads it whole;
* ``change_gap``: each parameter's change over the first steps (through
  the first update), by the worst leaf, leaving out the leaves whose
  reference gradient (weight decay's term in) is under a thousandth of the
  median leaf's; ``change_gap_median`` the same gaps' median over the
  leaves;
* ``logits_gap``: the first step's logits, ||program - reference|| over
  ||reference||.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import harness
import weights as weights_mod
import work
from reference import model as ref

#: What makes a training window: batches already on the card (no
#: prefetcher), no save and no LR-drop snapshot inside it.
FIXED = ("data.prefetch=0", "checkpoint.save_every_steps=0",
         "checkpoint.snapshot_on_lr_drop=false")
#: VOC 2012 train_aug: the LR schedule counts epochs of these images.
TRAIN_IMAGES = 10582


def _norms(tensors) -> list[float]:
    """Each tensor's L2 norm in float64 (0 for a buffer the optimizer never
    made)."""
    import torch

    made = [t for t in tensors if t is not None]
    norms = iter(torch.stack([t.detach().double().norm() for t in made]).tolist() if made else [])
    return [next(norms) if t is not None else 0.0 for t in tensors]


def data_grads(logits, params: dict) -> tuple[dict, list]:
    """Hooks that sum, for each parameter of ``params`` (name: leaf), the
    gradient that the backward pass from ``logits`` hands it (the nodes
    whose inputs are the leaves' own ``AccumulateGrad``); the sums, filled
    in by the backward, and the hooks' handles."""
    names = {id(p): n for n, p in params.items()}
    sums, handles, seen, todo = {}, [], set(), [logits.grad_fn]

    def keep(node, slots):
        def hook(grad_inputs, grad_outputs):
            for i, name in slots:
                g = grad_inputs[i].detach().float()
                sums[name] = g.clone() if name not in sums else sums[name] + g
        handles.append(node.register_hook(hook))

    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        slots = []
        for i, (child, _) in enumerate(node.next_functions):
            leaf = getattr(child, "variable", None)
            if leaf is not None and id(leaf) in names:
                slots.append((i, names[id(leaf)]))
            else:
                todo.append(child)
        if slots:
            keep(node, slots)
    return sums, handles


def build(ctx, cfg, params):
    """The port's trainer and train state on ``params`` (OIHW)."""
    import torch

    from em_adapt_torch.models.registry import get_model
    from em_adapt_torch.train.optim import AccumulatingSGD
    from em_adapt_torch.train.state import TrainState
    from em_adapt_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=ctx.device,
                      steps_per_epoch=max(TRAIN_IMAGES // cfg.train.batch_size, 1))
    ctx.mark("trainer", sync=True)
    model = get_model(cfg.model.name)(cfg.model).to(ctx.device)
    ctx.mark("model on the card", sync=True)
    model.load_params(weights_mod.hwio(params))
    ctx.mark("weights loaded", sync=True)
    model.train()
    names, leaves = zip(*model.named_parameters())
    optimizer = AccumulatingSGD(leaves, cfg.optim, trainer.steps_per_epoch, names=names)
    generator = torch.Generator(ctx.device).manual_seed(ctx.seed + 1)
    return trainer, TrainState(model, optimizer, generator), names


def inputs(ctx):
    """The run's configuration, weights (OIHW), pool of batches and the
    number of first steps the comparison follows: three, or through the
    first update where the gradient is accumulated."""
    import traffic as traffic_mod

    cfg = ctx.experiment_config(FIXED + (f"checkpoint.save_dir={harness.CACHE / 'saver'}",))
    tr = ctx.traffic
    widths = dict(num_classes=cfg.model.num_classes, fc6_channels=cfg.model.fc6_channels,
                  width=cfg.model.width_multiplier)
    params = weights_mod.make(tr["weights"], ctx.seed, ctx.device, **widths)
    pool = traffic_mod.train_pool(tr, input_size=cfg.model.input_size,
                                  label_size=cfg.data.train_label_size,
                                  batch=cfg.train.batch_size, num_classes=cfg.model.num_classes,
                                  seed=ctx.seed, device=ctx.device)
    accum = cfg.optim.accum_steps
    return cfg, widths, params, pool, (3 if accum == 1 else accum)


def run(ctx) -> dict:
    import torch

    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    ctx.mark("imports")
    cfg, widths, params, pool, n_check = inputs(ctx)
    ctx.mark("weights and batches")
    tr = ctx.traffic
    trainer, state, names = build(ctx, cfg, params)
    ctx.mark("train state")
    batch = cfg.train.batch_size
    warmup = max(tr["warmup_steps"], n_check)

    # The first step: its logits, and the cross-entropy's gradient as the
    # backward pass hands it to each parameter.
    seen = {}
    leaves = dict(state.model.named_parameters())

    def keep_logits(module, inputs, out):
        if "logits" not in seen:
            seen["logits"] = out.detach().clone()
            seen["grads"], seen["hooks"] = data_grads(out, leaves)

    hook = state.model.register_forward_hook(keep_logits)
    records = trainer.fit(state, harness.Feed(pool, 0, limit=1), num_steps=1)
    hook.remove()
    for handle in seen.pop("hooks"):
        handle.remove()
    ctx.mark("first step", sync=True)
    grads = seen.pop("grads")
    data_prog = dict(zip(names, _norms([grads.get(n) for n in names])))
    del grads
    opt = state.optimizer.state_dict()
    held = opt["acc"] if opt["acc"] is not None else opt["momentum"]
    grad_prog = dict(zip(names, _norms(held)))
    records += trainer.fit(state, harness.Feed(pool, 1, limit=n_check - 1), num_steps=n_check)
    w0 = {leaf_name(n, k): v for n, p in params.items() for k, v in p.items()}
    change_prog = dict(zip(names, _norms([leaves[n] - w0[n] for n in names])))
    loss_prog = [r["loss"] for r in records]
    ctx.mark(f"{n_check} first steps")
    trainer.fit(state, harness.Feed(pool, n_check, limit=warmup - n_check), num_steps=warmup)
    sync()
    ctx.mark("warm-up")

    # The window. With --trace 1 it ends at the deadline, after a
    # synchronize, and the same fit call runs on under torch.profiler: one
    # step to settle the profiler, then ``trace_steps`` steps in the span.
    events, t, span = [], {}, {}
    k = tr["trace_steps"] if ctx.trace and cuda else 0

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)

    def first():
        t["setup_s"] = harness.seconds_since_process_start()
        t["start"] = time.perf_counter()
        mark()

    def deadline(given):
        from torch.profiler import ProfilerActivity, profile

        sync()
        t["end"], t["steps"] = time.perf_counter(), given
        span["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        span["prof"].start()

    def trace_step():
        mark()
        if span and "fn" not in span:  # the settling step is launched
            from torch.profiler import record_function

            sync()
            span["t0"], span["fn"] = time.perf_counter(), record_function("bench.window")
            span["fn"].__enter__()

    def trace_end():
        sync()
        span["t1"] = time.perf_counter()
        span["fn"].__exit__(None, None, None)
        span["prof"].stop()

    traced = dict(extra=k + 1, on_deadline=deadline, on_end=trace_end) if k else {}
    window = trainer.fit(state, harness.Feed(pool, warmup, seconds=ctx.seconds, on_first=first,
                                             **traced),
                         num_steps=10 ** 12, step_hook=trace_step if k else mark)
    sync()
    if not k:
        t["end"], t["steps"] = time.perf_counter(), len(window)
    wall = t["end"] - t["start"]
    steps = t["steps"]
    intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:steps + 1])] if cuda else []
    h, w = cfg.model.input_size
    flops = work.train_flops(h, w, batch, **widths) * steps
    e2e = {"setup_s": t["setup_s"], "train_images_per_s": steps * batch / wall}
    if intervals:
        e2e["train_step_ms_p95"] = harness.p95(intervals)
    records_out = {"kind": "train", "window_s": wall, "steps": steps, "images": steps * batch,
                   "flops": flops, "launch_s": [r["seconds"] for r in window[:steps]],
                   "batch": batch, "input_size": (h, w), "num_classes": cfg.model.num_classes,
                   "trace": None}
    ctx.log(f"window: {steps} steps of {batch} in {wall:.3f} s; launch mean "
            f"{1e3 * statistics.fmean(records_out['launch_s']):.3f} ms; K1/K2/K3 launches "
            f"{sum(r['estep_launches'] for r in window[:steps])}/"
            f"{sum(r['block1_fwd_launches'] for r in window[:steps])}/"
            f"{sum(r['block1_bwd_launches'] for r in window[:steps])}")
    if k:
        records_out["trace"] = harness.read_trace(span["prof"], "bench.window")
        records_out["trace_steps"] = k
        ctx.log(f"traced span: {k} steps in {span['t1'] - span['t0']:.3f} s, "
                f"{1e3 * (span['t1'] - span['t0']) / k:.3f} ms a step against "
                f"{1e3 * wall / steps:.3f} ms in the window untraced")
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    # The comparison, after the program's state is freed.
    first_logits = seen["logits"]
    del trainer, state, leaves, hook, records, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(ctx, cfg, params, pool[:n_check], loss_prog, grad_prog, data_prog,
                       change_prog, first_logits)
    ctx.log(f"comparison: {time.perf_counter() - t_ref:.2f} s for {n_check} reference steps")
    checks = [(name, readings[name], ctx.limits.get(name)) for name in ctx.limits]
    return {"e2e": e2e, "attempted": steps, "failed": 0, "records": records_out,
            "checks": checks, "readings": readings, "memory_peak_bytes": peak}


def reference_steps(cfg, params, batches, generator, quant: bool = False):
    """The reference's losses, first gradient and parameters after
    ``len(batches)`` steps, and its first logits."""
    trainer = ref.Trainer(params, lr=cfg.optim.base_lr, momentum=cfg.optim.momentum,
                          weight_decay=cfg.optim.weight_decay, accum=cfg.optim.accum_steps,
                          keep=cfg.model.dropout_keep_prob, generator=generator,
                          num_classes=cfg.model.num_classes, rounds=cfg.estep.num_iter,
                          quant=quant)
    losses, first = [], None
    for b in batches:
        loss, logits, _ = trainer.step(b)
        losses.append(float(loss))
        if first is None:
            first = logits
    return trainer, losses, first


def leaf_name(layer: str, key: str) -> str:
    """The port's name of a parameter (``named_parameters``)."""
    return f"layers.{layer}.{'weight' if key == 'w' else 'bias'}"


def reference_norms(params, trainer) -> tuple[dict, dict, dict]:
    """(first gradient's cross-entropy term, first gradient, change from
    ``params``) norms of each leaf of a reference trainer, by the port's
    names."""
    names = [leaf_name(n, k) for n, p in params.items() for k in p]
    start = [v for p in params.values() for v in p.values()]
    data = dict(zip(names, _norms(trainer.first_data_grad)))
    grad = dict(zip(names, _norms(trainer.first_grad)))
    change = dict(zip(names, _norms([v - s for (_, v), s in zip(trainer.leaves, start)])))
    return data, grad, change


def readings_of(params, trainer, losses, logits, loss_p, grad_p, data_p, change_p, logits_p):
    """The comparison's numbers of one side (the program or the control)
    against the reference (``trainer``, ``losses``, ``logits``)."""
    data_r, grad_r, change_r = reference_norms(params, trainer)
    med = statistics.median(grad_r.values())
    moved = {n for n, g in grad_r.items() if g >= 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss_p, losses))
    grad_gap, grad_leaf = harness.leaf_gap(grad_p, grad_r)
    data_gap, data_leaf = harness.leaf_gap(data_p, data_r)
    change_gap, change_leaf = harness.leaf_gap(change_p, change_r, keep=moved)
    change_median = harness.leaf_gap(change_p, change_r, keep=moved, worst=False)[0]
    if logits_p.shape != logits.shape:  # logits of other images than the reference's
        logits_gap = math.inf
    else:
        logits_gap = float((logits_p.float() - logits).norm() / logits.norm())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "change_gap_median": change_median, "logits_gap": logits_gap,
            "data_grad_gap": data_gap, "grad_leaf": grad_leaf, "data_grad_leaf": data_leaf,
            "change_leaf": change_leaf, "data_grad_gaps": harness.leaf_gaps(data_p, data_r),
            "left_out": sorted(set(grad_r) - moved), "losses_ref": losses,
            "losses": list(loss_p)}


def compare(ctx, cfg, params, batches, loss_p, grad_p, data_p, change_p, logits_p) -> dict:
    import torch

    ref.exact_float32()
    gen = torch.Generator(ctx.device).manual_seed(ctx.seed + 1)
    trainer, losses, logits = reference_steps(cfg, params, batches, gen)
    return readings_of(params, trainer, losses, logits, loss_p, grad_p, data_p, change_p,
                       logits_p)


def control_readings(ctx) -> dict:
    """The control's readings: the reference in fp8 put in the program's
    place, against the reference in float32, on the run's first steps."""
    import torch

    cfg, _, params, pool, n_check = inputs(ctx)
    ref.exact_float32()
    runs = [reference_steps(cfg, params, pool[:n_check],
                            torch.Generator(ctx.device).manual_seed(ctx.seed + 1), quant=q)
            for q in (False, True)]
    (trainer, losses, logits), (low, low_losses, low_logits) = runs
    data_q, grad_q, change_q = reference_norms(params, low)
    return readings_of(params, trainer, losses, logits, low_losses, grad_q, data_q, change_q,
                       low_logits)
