"""The EM training step and the durable training loop.

One microbatch step (reference deeplab.py:242-280): forward with dropout
-> TF1 nearest shrink of the label to the score map -> E-step weak labels
(no gradient) -> mean cross-entropy over all pixels + wd * L2(weights)
-> backward -> accumulated SGD with momentum (with the Caffe LR groups
on ``optim.lr_multipliers``). ``loss_fn`` is
``em_adapt_tpu/train/trainer.py::loss_fn`` (trainer.py:138-230) with its
variants: semi-supervision and the tag warm-up.
``Trainer.fit`` is the loop of ``em_adapt_tpu/train/trainer.py::fit``
(l.612-884) on one process: the batches arrive through a
``DevicePrefetcher`` (``data.prefetch`` deep), each loss is checked one
step late, and the card is waited for only at the log, eval and save
cadences; "norm" saves, "lr" snapshots, "best" on periodic eval, the
preemption save and the loss watchdog. ``Trainer.warm_start`` takes a
checkpoint's parameters only.

Randomness: one ``torch.Generator`` on the training device draws the
dropout masks and the E-step's class orders. It gives other draws than
the JAX package's keys; tests inject the same orders and masks instead.

Several processes (``Trainer(world=...)``, ``parallel/mesh.py``) are laid
out as the mesh ``data × space × model`` of ``cfg.mesh``
(:class:`~em_adapt_torch.parallel.mesh.MeshPlan`). Each holds its data
index's images of the global batch, its rows of them on a space axis
(``parallel/spatial.py``) and its part of fc6/fc7 on a model axis
(``parallel/tensor.py``). Its model is wrapped in
``DistributedDataParallel`` over the data × space ranks of its model
index, which averages every microbatch's gradients in the backward pass
(the JAX package's psum of each microbatch), so ``AccumulatingSGD`` folds
in the world's mean gradient. Every process seeds the same generator,
draws the world batch's dropout masks and keeps its slices, then the same
class orders; the E-step's batch max, the loss's pixel counts and the
logged loss are the world's. Rank 0 writes the checkpoints (the whole
model, gathered over the model axis) and ``best_metric.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import warnings
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from em_adapt_torch.config import ExperimentConfig, check_supported
from em_adapt_torch.data.pipeline import DevicePrefetcher
from em_adapt_torch.device import resolve_device, set_precision
from em_adapt_torch.models.deeplab import build_model
from em_adapt_torch.ops import block1 as k23
from em_adapt_torch.ops import estep_kernel as k1
from em_adapt_torch.ops.estep import estep_labels, make_class_orders
from em_adapt_torch.ops.resize import resize_nearest_tf
from em_adapt_torch.parallel.mesh import MeshPlan, World, all_sum, make_plan, mesh_layout
from em_adapt_torch.parallel.spatial import check_image_rows, gather_rows, my_rows
from em_adapt_torch.train.checkpoint import CheckpointManager
from em_adapt_torch.train.optim import AccumulatingSGD, lr_at
from em_adapt_torch.train.state import TrainState
from em_adapt_torch.utils import tracing
from em_adapt_torch.utils.failure import GracefulShutdown, LossWatchdog


def config_hints(cfg: ExperimentConfig, plan: MeshPlan | None = None) -> list[str]:
    """The measured-knowledge hints that ``Trainer`` emits as
    ``UserWarning``s at construction: the EM-Fixed ones of
    ``em_adapt_tpu/train/trainer.py::config_hints``, word for word, and
    its spatial-mesh hint (an input of 513² or more on a mesh of several
    processes with space = 1) with the H100's own figures."""
    hints = []
    n = 1 if plan is None else plan.ddp_size * plan.num_model_shards
    if cfg.model.input_size[0] >= 513 and n > 1 and plan.num_space_shards == 1:
        hints.append(SPATIAL_HINT.format(h=cfg.model.input_size[0], n=n))
    if cfg.estep.method == "fixed" and cfg.estep.fixed_bias_units == "logit":
        hints.append(
            "estep.method='fixed' with logit-unit biases: every "
            "end-to-end run of this variant on the rehearsal task "
            "degraded the model (cold start: trivial at every bias; "
            "warm start from a 0.32 prior: erodes to all-foreground — "
            "CONVERGENCE_FIXED.json). The constant bias loses "
            "calibration as the logit spread grows; "
            "estep.fixed_bias_units='spread' with SYMMETRIC biases "
            "retained the prior (warm_spread arms), and "
            "estep.method='adaptive' is the reference algorithm"
        )
    if (cfg.estep.method == "fixed"
            and cfg.estep.fixed_bias_units == "spread"
            and cfg.estep.fixed_bg_bias != cfg.estep.fixed_fg_bias):
        hints.append(
            "estep.method='fixed' with ASYMMETRIC spread-unit biases "
            f"(bg {cfg.estep.fixed_bg_bias} != fg "
            f"{cfg.estep.fixed_fg_bias}): both asymmetric arms of the "
            "warm-start probe eroded the prior — the larger-biased side "
            "floods the other's pixels with nothing to stop it "
            "(CONVERGENCE_FIXED.json warm_spread_sweep; symmetric "
            "biases retained 0.3055 of a 0.3202 prior). Prefer equal "
            "bg/fg biases in spread units"
        )
    return hints


#: The spatial-mesh hint of :func:`config_hints`, with the range that
#: chip_smoke.py's "mesh" read over its runs (NVIDIA H100 80GB HBM3 at
#: 700 W; PERF.md §5 and §6).
SPATIAL_HINT = (
    "input {h}² with space=1 on a {n}-process mesh: spatial partitioning "
    "(mesh.axes=((\"data\",-1),(\"space\",3))) cut each rank's peak memory at 513² to "
    "1.65 GiB from 2.27-2.29 GiB in one process (bf16, batch 6, remat) on an H100, and "
    "the step ran 7-27 times slower than in one process (three ranks on one card over "
    "gloo, the halos through the host; chip_smoke.py \"mesh\"); one card holds this "
    "input whole, so keep space=1 unless a card's memory runs out")


def tag_classification_loss(
    logits: torch.Tensor,
    shrunk: torch.Tensor,
    num_classes: int,
    smoothing: float = 0.05,
    pool_r: float = 1.0,
) -> torch.Tensor:
    """The weak-tag classification loss of the tag warm-up
    (``em_adapt_tpu/train/trainer.py::tag_classification_loss``): each
    class's scores LSE-pooled over positions, ``(1/r)(logsumexp(r·x) −
    log HW)`` (the smooth max of Pinheiro & Collobert, arXiv:1411.6228
    §3.1), scored with sigmoid BCE against the image-level tags smoothed
    to [eps, 1-eps]. A class is present iff it occurs in the mask and is
    below ``num_classes`` (255, the ignore label, drops out).

    logits [B,h,w,C] f32, shrunk [B,h,w] (the mask at the score map's
    size). Returns the scalar mean over [B, C].
    """
    b, h, w, c = logits.shape
    classes = torch.arange(num_classes, device=logits.device)
    lab = shrunk.to(torch.int64).reshape(b, h * w, 1)
    tags = (lab == classes).any(1).to(logits.dtype)  # [B,C]
    tags = tags * (1.0 - 2.0 * smoothing) + smoothing
    pooled = (torch.logsumexp(pool_r * logits.reshape(b, h * w, c), 1)
              - math.log(float(h * w))) / pool_r
    return F.binary_cross_entropy_with_logits(pooled, tags, reduction="none").mean()


def loss_fn(
    model: torch.nn.Module,
    batch: dict,
    cfg: ExperimentConfig,
    *,
    generator: torch.Generator | None = None,
    orders: torch.Tensor | None = None,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
    step: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Total loss = CE(logits, targets) + wd * L2(weights).

    batch: {"image" [B,H,W,3], "label" [B,H,W,1] (255 = ignore), and with
    ``cfg.semi_supervised`` optionally "is_strong" [B] bool} tensors on
    the model's device. ``model`` is a registered architecture
    (``models/registry.py``) or the ``DistributedDataParallel`` wrapper of
    one. ``orders`` and ``masks`` replace the draws from
    ``generator``. Returns (total, {"loss", "loss_norm", "loss_l2",
    "weak"}); "weak" is None on a tag warm-up step.

    Targets: the E-step's weak labels, over every pixel (reference
    deeplab.py:182). With ``cfg.semi_supervised`` and "is_strong" in the
    batch, strong images train on their shrunk true masks instead, void
    pixels masked out, and the sum is divided by max(valid pixels, 1)
    (``em_adapt_tpu/train/trainer.py:196-208``). While ``step`` is below
    ``train.tag_warmup_steps`` the loss is
    :func:`tag_classification_loss` instead. The JAX package computes the
    E-step there too and discards it; here it does not run (K1 is not
    launched), but its class orders are still drawn, so the generator
    advances as on an EM step and a run resumed inside or across the
    warm-up draws what the uninterrupted run draws.

    On a mesh (the model's ``plan``) each rank holds its data index's
    images, and DDP averages the gradients over the data × space ranks of
    its model index. Each rank's ``ce`` is scaled so that that average is
    the global one: the weak CE over its images is their mean; on a space
    axis the rank holds its rows of the score map, gathers the whole map
    over the space group for the E-step (each space rank runs it on the
    same map, so all get the same weak labels), and its CE is the sum over
    its rows of the labels over the global pixel count, times data × space;
    the semi-supervised CE is divided by the global valid-pixel count
    (summed over data × space) and scaled by data × space. The tag loss
    LSE-pools over every position, so a space rank takes it on the whole
    map gathered with its gradient, of which each rank keeps its rows'
    share; scaled by the space axis, the ranks' shares add up to the loss's
    gradient. The logged values are the unscaled losses.
    """
    c = cfg.model.num_classes
    net = getattr(model, "module", model)
    plan = net.plan
    strip = plan.num_space_shards > 1
    with tracing.span("step.forward", stage=True):
        logits = model(batch["image"], train=True, generator=generator, masks=masks,
                       shard=(plan.data_index, plan.num_data_shards), strip=strip)
        rows = logits.shape[1]  # the score map's rows: the whole map's on a space axis
        if strip:  # the whole image's ceil(H / output stride)
            height = batch["image"].shape[1] * plan.num_space_shards
            rows = -(-height // net.output_stride)
        out_hw = (rows, logits.shape[2])
        label = batch["label"]
        if tuple(label.shape[1:3]) == out_hw:
            shrunk = label[..., 0]
        else:
            shrunk = resize_nearest_tf(label, out_hw)[..., 0]  # reference deeplab.py:110
    with tracing.span("step.estep", stage=True):
        if orders is None:
            orders = make_class_orders(generator, cfg.estep.num_iter, c)
        weak = None
        # NCHW view of the logits (this rank's rows of them on a space axis).
        nchw = logits.permute(0, 3, 1, 2)
        warmup = step is not None and step < cfg.train.tag_warmup_steps
        whole = gather_rows(nchw if warmup else nchw.detach(), plan, rows) if strip else nchw
        if not warmup:
            weak = estep_labels(whole.detach().permute(0, 2, 3, 1), shrunk, orders, cfg.estep,
                                plan)
    with tracing.span("step.loss", stage=True):
        n = plan.ddp_size
        if warmup:
            ce = logged = tag_classification_loss(whole.permute(0, 2, 3, 1), shrunk, c,
                                                  cfg.train.tag_warmup_smoothing,
                                                  cfg.train.tag_warmup_pool_r)
            if strip:
                ce = logged * plan.num_space_shards
        else:
            target, mine = my_rows(weak, plan, 1), my_rows(shrunk, plan, 1)
            # Every reduction below is a sum over the per-pixel losses:
            # cross_entropy's own mean adds them with atomics on a CUDA card,
            # so its value (not its gradient) would vary in the last bits from
            # run to run, and a resumed run's losses must equal the
            # uninterrupted run's.
            if cfg.semi_supervised and "is_strong" in batch:
                strong = batch["is_strong"].to(torch.bool)[:, None, None]
                true_lab = mine.to(torch.int64)
                target = torch.where(strong, true_lab, target)
                valid = torch.where(strong, true_lab < c, True)
                ce_map = F.cross_entropy(nchw, target.clamp(0, c - 1), reduction="none")
                count = all_sum(valid.sum(), plan).clamp(min=1)
                ce = (ce_map * valid).sum() / count
                if n > 1:
                    ce = ce * n
            elif strip:
                ce_map = F.cross_entropy(nchw, target, reduction="none")
                pixels = nchw.shape[0] * rows * nchw.shape[3]
                ce = ce_map.sum() * (plan.num_space_shards / pixels)
            else:
                ce = F.cross_entropy(nchw, target, reduction="none").mean()
            logged = ce
        l2 = net.weight_l2()
        total = ce + cfg.optim.weight_decay * l2
        loss = total if logged is ce else logged + cfg.optim.weight_decay * l2
        return total, {"loss": loss.detach(), "loss_norm": logged.detach(),
                       "loss_l2": l2.detach(), "weak": weak}


def train_step(
    state: TrainState,
    batch: dict,
    cfg: ExperimentConfig,
    *,
    orders: torch.Tensor | None = None,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> dict:
    """One microbatch step in place on ``state``. Returns the metrics and
    ``"updated"``: whether this step applied an accumulated update. In a
    world of processes the forward goes through ``state.ddp``, ``masks``
    are this rank's slices, and "loss", "loss_norm" and
    "loss_l2" are the world's: the means over the data × space ranks of
    this rank's model index. Its stages are the spans :data:`STAGES` of
    ``utils/tracing.py`` (the first three in :func:`loss_fn`)."""
    for p in state.optimizer.params:
        p.grad = None
    total, metrics = loss_fn(
        state.ddp if state.ddp is not None else state.model, batch, cfg,
        generator=state.generator, orders=orders, masks=masks, step=state.step,
    )
    with tracing.span("step.backward", stage=True):
        total.backward()
    plan = state.model.plan
    n = plan.ddp_size
    if n > 1:
        means = all_sum(torch.stack([metrics[k] for k in ("loss", "loss_norm", "loss_l2")]),
                        plan) / n
        metrics.update(loss=means[0], loss_norm=means[1], loss_l2=means[2])
    with tracing.span("step.optim", stage=True):
        metrics["updated"] = state.optimizer.step(state.step)
    state.step += 1
    return metrics


#: The stage spans of a training step, in order (``utils/tracing.py``).
STAGES = ("step.forward", "step.estep", "step.loss", "step.backward", "step.optim")


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch with its numpy arrays copied to ``device`` (from pageable
    memory: ``Trainer.fit`` copies through ``DevicePrefetcher``'s pinned
    ring instead). Tensors, and leaves that are not arrays, pass as they
    are."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        if isinstance(v, np.ndarray) else v
        for k, v in batch.items()
    }


def full_sync(device: torch.device) -> None:
    """Wait until ``device`` has run everything queued on it: the loop's
    sync at a log window (a no-op on the CPU): the span ``fit.sync``,
    counted as a wait (``utils/tracing.py``)."""
    if device.type == "cuda":
        with tracing.span("fit.sync") as sync:
            torch.cuda.synchronize(device)
        tracing.waited(sync.ns)


class LateLossReader:
    """Each step's (loss, loss_norm, loss_l2), read one step late without
    draining the device's queue.

    :meth:`push` right after a step's launch copies the three scalars
    (``non_blocking``) into a slot of a small ring of pinned host memory
    and records a CUDA event behind the copy; :meth:`read` of that slot
    after the next step's launch waits on the event, i.e. for that step
    alone, not for the step queued behind it (a ``float()`` of the loss
    tensor would go onto the stream behind it and wait for both). A slot
    is reused after ``slots`` pushes; the loop reads each before pushing
    two more. On the CPU the values are copied as they are.
    """

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = torch.empty(slots, 3, dtype=torch.float32, pin_memory=self.cuda)
        self.events: list = [None] * slots
        self.pushed = 0

    def push(self, metrics: dict) -> int:
        """Queue the copy of one step's metrics; returns its slot."""
        slot = self.pushed % len(self.events)
        self.pushed += 1
        vals = torch.stack([metrics["loss"], metrics["loss_norm"], metrics["loss_l2"]])
        self.host[slot].copy_(vals.to(torch.float32), non_blocking=self.cuda)
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.events[slot] = event
        return slot

    def read(self, slot: int) -> tuple[float, float, float]:
        """The slot's values, once the card has copied them (a wait,
        counted in ``utils/tracing.py``'s ``host_waits``)."""
        t0 = time.perf_counter_ns()
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        loss, norm, l2 = self.host[slot].tolist()
        tracing.waited(time.perf_counter_ns() - t0)
        return loss, norm, l2


class Trainer:
    """Owns the model, optimizer, generator and checkpoints of one training run."""

    def __init__(self, cfg: ExperimentConfig, *, device=None, steps_per_epoch: int | None = None,
                 world: World | None = None):
        """``world`` (``parallel/mesh.py::init_world``): train as one rank of
        several processes on ``world.device``, laid out by ``cfg.mesh``,
        whose axes must use exactly the world; ``cfg.train.batch_size`` is
        then the global batch and must divide over the data axis, and the
        input's height over the space axis. The process groups of the
        layout are made here (every rank constructs its Trainer alike)."""
        check_supported(cfg)
        self.cfg = cfg
        self.world = world
        self.plan = MeshPlan()
        if world is not None:
            sizes, _ = mesh_layout(cfg.mesh, world.size, world.rank)
            check_image_rows(cfg.model.input_size[0], sizes["space"])
            if cfg.train.batch_size % sizes["data"]:
                raise ValueError(f"global train.batch_size {cfg.train.batch_size} not divisible "
                                 f"by the data axis ({sizes['data']} of {world.size} processes)")
            device = world.device
            self.plan = make_plan(cfg.mesh, world)
        for hint in config_hints(cfg, self.plan):
            warnings.warn(hint, UserWarning, stacklevel=2)
        self.device = resolve_device(device)
        set_precision(cfg.model.compute_dtype)
        self.steps_per_epoch = steps_per_epoch or 1
        self.checkpointer = CheckpointManager(cfg.checkpoint, world=world)
        # The best periodic-eval score of this lineage; fit() sets it (see there).
        self._best_metric = float("-inf")

    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh parameters (drawn on the CPU from ``seed``, so a seed gives
        the same weights on every device; on a model axis this rank's part
        of them), zeroed optimizer, step 0; in a world, the model's DDP
        wrapper over the data × space ranks of its model index (a
        collective: every rank makes it)."""
        seed = self.cfg.train.seed if seed is None else seed
        model = build_model(self.cfg.model, seed, self.device, plan=self.plan)
        model.train()
        names, params = zip(*model.named_parameters())
        optimizer = AccumulatingSGD(params, self.cfg.optim, self.steps_per_epoch, names=names,
                                    head=model.HEAD)
        generator = torch.Generator(self.device).manual_seed(seed + 1)
        ddp = None
        if self.world is not None:
            from torch.nn.parallel import DistributedDataParallel

            ddp = DistributedDataParallel(
                model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                find_unused_parameters=False, process_group=self.plan.ddp_group)
        return TrainState(model, optimizer, generator, ddp=ddp)

    def restore_state(self, tag: str = "norm", step: int | None = None) -> TrainState:
        """The full state saved under ``tag`` at ``step`` (default: the
        latest), on this trainer's device."""
        return self.checkpointer.restore(self.init_state(), tag, step)

    def warm_start(self, state: TrainState, save_dir: str, tag: str = "norm",
                   step: int | None = None) -> TrainState:
        """Params-only warm start (reference ``model_path`` semantics,
        deeplab.py:229-234): the parameters of the checkpoint ``tag`` at
        ``step`` (default: the latest) under ``save_dir`` are copied into
        ``state``, a fresh state whose zeroed optimizer, step 0 and
        generator stay as they are, so the LR schedule starts from the top.
        A checkpoint saved under another optimizer layout (another
        ``accum_steps``, say) loads too. ``--resume`` is the opposite
        contract: the whole state, continued bit for bit."""
        mgr = CheckpointManager(dataclasses.replace(self.cfg.checkpoint, save_dir=save_dir))
        mgr.restore_params(state.model, tag, step)
        return state

    def _best_metric_path(self) -> str:
        return os.path.join(os.path.abspath(self.cfg.checkpoint.save_dir), "best_metric.json")

    def _load_best_metric(self) -> float:
        """The best score stored beside the checkpoints, -inf when there is
        none (or it is unreadable): a resumed run's first eval must not
        replace a better "best" saved before the preemption. In a world,
        rank 0's reading on every rank."""
        try:
            with open(self._best_metric_path()) as f:
                best = float(json.load(f)["metric"])
        except (OSError, ValueError, KeyError, TypeError):
            best = float("-inf")
        return best if self.world is None else self.world.broadcast(best)

    def _store_best_metric(self, score: float, step: int) -> None:
        """Write ``best_metric.json`` atomically (a temporary file renamed
        into place)."""
        path = self._best_metric_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"metric": float(score), "step": int(step)}, f)
        os.replace(tmp, path)

    def train_step(self, state: TrainState, batch: dict, **kw) -> dict:
        return train_step(state, to_device(batch, self.device), self.cfg, **kw)

    def fit(
        self,
        state: TrainState,
        batches: Iterable[dict],
        *,
        num_steps: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
        eval_fn: Callable[[TrainState], float] | None = None,
        step_hook: Callable[[], None] | None = None,
    ) -> list[dict]:
        """Train until ``state.step`` reaches ``num_steps`` (an absolute
        budget: a resumed state runs only the rest; default epochs *
        steps_per_epoch), the batches end, or SIGTERM/SIGINT arrives.

        With ``data.prefetch`` > 0 the batches go through a
        ``DevicePrefetcher`` (unless they already do), which pulls no more
        than the budget's rest and is closed on every way out; batches it
        read ahead and that were not used are dropped.

        The host does not wait for a step before launching the next: each
        step's loss is read one step late (:class:`LateLossReader`), after
        the next step has been launched, and goes through the watchdog
        then, in order; a non-finite or frozen loss raises "training
        unhealthy at step N" and nothing more is saved. Before any save
        the loss of the step being saved is checked, and after the last
        step the last loss. The loop waits for the whole device only at
        its cadences (``em_adapt_tpu/train/trainer.py::Trainer.fit``,
        l.612-884):

        * a log window, where ``state.step`` crosses a multiple of
          ``train.log_every_steps`` (0: never): after the sync the last
          step's loss is checked, then ``log_fn`` gets {step (steps
          done), epoch, lr (of the last step run), images_per_sec, loss,
          loss_norm, loss_l2 (of the last step), window_seconds (wall
          since the previous window's end, or since the loop started, or
          since the last eval ended), window_steps, the sums over the
          window's steps of wait_seconds and of estep_launches,
          block1_fwd_launches and block1_bwd_launches (K1, K2 and K3),
          host_waits and host_wait_seconds (the explicit waits on the
          card in the window: how often and how long the loop blocked on
          the card at its loss reads and syncs) and
          stage_seconds (each of :data:`STAGES` to its host seconds
          over the window's steps)};
        * periodic eval, where it crosses a multiple of
          ``train.eval_every_steps`` (None: never) and ``eval_fn`` is
          given: ``eval_fn(state)`` (higher is better), logged as {step,
          val_metric}; an improvement on the best so far saves "best"
          and writes ``save_dir/best_metric.json``. The best so far starts
          at -inf for a state at step 0 (a fresh or warm-started run) and
          at the stored one for a resumed state. The model's train/eval
          mode is put back after ``eval_fn``, and eval draws nothing from
          the training generator;
        * "norm" where it crosses a multiple of
          ``checkpoint.save_every_steps`` (0: never), "lr" right before
          the first step of each LR drop, and on a signal "norm" at the
          step reached, then return.

        The budget and the signal are checked before a batch is pulled.

        ``step_hook``, if given, is called after each step's launch (the
        ``train`` command's profiler schedule, ``utils/profiling.py::trace_steps``).

        Each step is an entry of ``utils/tracing.py`` (the root span
        ``fit.step``, id the step), with the spans ``fit.next_batch``
        (whose ns is the record's ``wait_seconds``), ``fit.loss_check``,
        ``fit.sync``, ``fit.save``, ``fit.eval`` and the stages of
        :func:`train_step`; a pull that finds no batch makes none.

        Returns one record per step: step, loss (filled in when the check
        reads it), lr, whether the params moved, ``wait_seconds`` (host
        clock in ``next()`` on the batches), ``seconds`` (host clock from
        the batch in hand to the step's launch returning, its loss copy
        queued; the device may still be running it) and the launches it
        made of the E-step kernel K1 and of the fused block1's forward K2
        and backward K3.
        """
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.train.epochs * self.steps_per_epoch
        lr_drops = ({epoch * self.steps_per_epoch for epoch, _ in cfg.optim.lr_schedule}
                    if cfg.checkpoint.snapshot_on_lr_drop else set())
        save_every = cfg.checkpoint.save_every_steps
        log_every = cfg.train.log_every_steps
        eval_every = cfg.train.eval_every_steps if eval_fn is not None else None
        if state.step > 0 and self._best_metric == float("-inf"):
            self._best_metric = self._load_best_metric()  # a resumed lineage
        elif state.step == 0:
            self._best_metric = float("-inf")  # a new lineage
        watchdog = LossWatchdog()
        reader = LateLossReader(self.device)
        records: list[dict] = []
        unread: list[tuple[dict, int]] = []  # (record, reader slot) in step order

        def check(upto: int) -> None:
            """Read and check every unread loss of a step below ``upto``."""
            with tracing.span("fit.loss_check"):
                while unread and unread[0][0]["step"] < upto:
                    record, slot = unread.pop(0)
                    record["loss"] = reader.read(slot)[0]
                    reason = watchdog.check(record["loss"])
                    if reason is not None:
                        raise RuntimeError(
                            f"training unhealthy at step {record['step']}: {reason}")

        def checked_save(tag: str) -> None:
            with tracing.span("fit.save"):
                check(state.step)
                self.checkpointer.save(state, tag)

        def crossed(every: int | None, before: int) -> bool:
            return bool(every) and before // every < state.step // every

        def window_start() -> tuple[float, int, int, dict]:
            """(clock, records, next entry, wait counters) at a window's start."""
            return time.perf_counter(), len(records), tracing.next_seq(), tracing.counters()

        stop_step = None
        t_window, n_window, seq_window, waits_window = window_start()
        with GracefulShutdown() as shutdown, contextlib.ExitStack() as stack:
            if cfg.data.prefetch > 0 and not isinstance(batches, DevicePrefetcher):
                batches = DevicePrefetcher(batches, self.device, depth=cfg.data.prefetch,
                                           limit=max(total - state.step, 0))
                stack.callback(batches.close)
            stack.callback(self.checkpointer.wait)
            it = iter(batches)
            while state.step < total:
                if stop_step is None and shutdown.requested_uniform():
                    stop_step = shutdown.agreed_stop_step(state.step)
                if stop_step is not None and state.step >= stop_step:
                    checked_save("norm")
                    break
                with tracing.root("fit.step", "train", state.step) as entry:
                    with tracing.span("fit.next_batch") as pull:
                        batch = next(it, None)
                    if batch is None:
                        entry.drop()
                        break
                    entry.images = len(batch["image"])
                    if state.step in lr_drops:
                        checked_save("lr")
                    step = state.step
                    launches = (k1.launches, k23.launches, k23.bwd_launches)
                    t0 = time.perf_counter()
                    metrics = self.train_step(state, batch)
                    slot = reader.push(metrics)
                    record = {
                        "step": step,
                        "loss": None,
                        "lr": lr_at(cfg.optim, self.steps_per_epoch, step),
                        "updated": metrics["updated"],
                        "wait_seconds": pull.ns / 1e9,
                        "seconds": time.perf_counter() - t0,
                        "estep_launches": k1.launches - launches[0],
                        "block1_fwd_launches": k23.launches - launches[1],
                        "block1_bwd_launches": k23.bwd_launches - launches[2],
                    }
                    records.append(record)
                    unread.append((record, slot))
                    if step_hook is not None:
                        step_hook()
                    check(step)  # the previous step's loss, one step late
                    if crossed(log_every, step):
                        full_sync(self.device)
                        check(state.step)
                        now, waits = time.perf_counter(), tracing.counters()
                        window = records[n_window:]
                        if log_fn is not None:
                            _, loss_norm, loss_l2 = reader.read(slot)
                            log_fn({
                                "step": state.step,
                                "epoch": state.step / self.steps_per_epoch,
                                "lr": record["lr"],
                                "images_per_sec": len(window) * cfg.train.batch_size
                                / (now - t_window),
                                "loss": record["loss"],
                                "loss_norm": loss_norm,
                                "loss_l2": loss_l2,
                                "window_seconds": now - t_window,
                                "window_steps": len(window),
                                **{k: sum(r[k] for r in window) for k in
                                   ("wait_seconds", "estep_launches", "block1_fwd_launches",
                                    "block1_bwd_launches")},
                                "host_waits": waits["host_waits"] - waits_window["host_waits"],
                                "host_wait_seconds":
                                    (waits["host_wait_ns"] - waits_window["host_wait_ns"]) / 1e9,
                                "stage_seconds": tracing.host_seconds(seq_window, STAGES),
                            })
                        t_window, n_window, seq_window, waits_window = window_start()
                    if crossed(eval_every, step):
                        training = state.model.training
                        try:
                            with tracing.span("fit.eval"):
                                score = float(eval_fn(state))
                        finally:
                            state.model.train(training)
                        if log_fn is not None:
                            log_fn({"step": state.step, "val_metric": score})
                        if score > self._best_metric:
                            self._best_metric = score
                            checked_save("best")
                            if self.world is None or self.world.is_main:
                                self._store_best_metric(score, state.step)
                        # Eval is synchronous host work: the next window's
                        # throughput counts steps only.
                        t_window, n_window, seq_window, waits_window = window_start()
                    if crossed(save_every, step):
                        checked_save("norm")
            check(state.step)  # the last step's loss
        return records
