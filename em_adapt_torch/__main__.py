"""Command line of the port: ``python -m em_adapt_torch
convert|train|eval|predict|export|import-tf|info ...`` (installed as
``em-adapt-torch``).

    python -m em_adapt_torch convert --voc-seg DIR [--sbd-cls DIR] --out DIR
    python -m em_adapt_torch train [--synthetic N [--synthetic-learnable]] [--steps N]
        [--preset reference|gpu-perf|gpu-perf-fold|gpu-highres] [--profile-dir DIR]
        [--resume | --warm-start DIR[:STEP]] [--log-jsonl PATH] [--deterministic]
        [--strong-list PATH | --strong-fraction F] [--synthetic-val N]
        [--multihost [--coordinator HOST:PORT --num-processes N --process-id I]
         [--dist-backend auto|gloo] [--dist-timeout S]] [key=value ...]
    python -m em_adapt_torch eval [--checkpoint DIR[:TAG]] [--synthetic N] [--fixed-size]
        [--crf] [--int8] [key=value ...]
    python -m em_adapt_torch predict IMG... --out DIR [--checkpoint DIR[:TAG]] [--crf]
        [--overlay] [--int8] [key=value ...]
    python -m em_adapt_torch export --out PATH [--checkpoint DIR[:TAG]] [--batch-size N]
        [--format pt2|npy] [--int8 [--calib-images IMG...]] [key=value ...]
    python -m em_adapt_torch import-tf PREFIX --out DIR [key=value ...]
    python -m em_adapt_torch info

``convert`` writes the index-PNG masks of ``SegmentationClassAug`` from
VOC's RGB masks and SBD's .mat files. ``train`` trains on the VOC split
"train" under ``data.main_path`` and ``data.list_dir`` (or on
``SyntheticVOC`` with ``--synthetic``, on ``LearnableSyntheticVOC``'s
color blobs of ``data.input_size`` with ``--synthetic-learnable`` too)
with the reference recipe (or the dotted config overrides given), logs a record every
``train.log_every_steps`` steps through ``MetricLogger`` (stdout, and
``--log-jsonl``), and saves full-state checkpoints under
``checkpoint.save_dir`` ("norm" on its cadence, at a SIGTERM and at the
end; "lr" before each LR drop; "best" on an improved periodic eval, with
``train.eval_every_steps``). ``--resume`` continues from the latest "norm"
checkpoint, on the batches the run would have seen next; ``--warm-start``
takes only the parameters of a checkpoint. ``--strong-list`` (or
``--strong-fraction`` on synthetic data) turns on semi-supervision.
``--preset`` applies one of :func:`train_presets`' override bundles before
the dotted overrides (which win over it); ``--profile-dir`` writes a
torch.profiler trace of the first ``utils/profiling.py::TRACE_STEPS``
steps there (``trace_steps``).
``eval`` loads the latest "norm" parameters
(a fresh init, with a warning, when there are none) and scores them on the
split "val" (or a synthetic one) by the VOC protocol (each image at its
original resolution; ``--crf`` or ``eval.use_crf`` adds the dense CRF, on
the host or, with ``eval.crf_impl=tpu``, on the card), or at the training
resolution with ``--fixed-size``: per-class IoU and mIoU. Both run on
the CUDA card (``--device cpu`` runs on the CPU); training and the fixed
protocol copy their batches there through ``DevicePrefetcher`` unless
``data.prefetch=0``. ``train --deterministic`` makes cuDNN choose
deterministic algorithms before the model is built
(``device.py::set_deterministic``), so that runs in separate processes
sum alike. ``train --multihost`` trains as one process of several, one a
card (``parallel/mesh.py``): the process group is joined from
``--coordinator HOST:PORT --num-processes N --process-id I`` (or from
torchrun's environment) and laid out by ``mesh.axes`` as data × space ×
model (``MeshPlan``); ``train.batch_size`` is the global batch, each data
index takes its images of it, each space rank its rows of them (sliced on
the host), each model rank its part of fc6/fc7; the periodic eval scores
each data × space block of the val set and sums the confusion matrices;
rank 0 prints, logs and writes the checkpoints (the whole model), and
every rank prints its kernel launches a step and its peak device memory
at the end (``em_adapt_tpu/cli.py:99-110, 308-320``).

The serving commands (``em_adapt_tpu/cli.py:639-919``): ``predict``
writes a VOC-palette PNG mask per image at the image's own size (the
network in chunks of ``eval.batch_size``, the tail padded; the logits
upsampled to the original size, the optional CRF, the argmax; RGB
overlays with ``--overlay``) and prints ``IMG -> MASK`` per image in input
order. ``export`` writes the predict program (``torch.export``, ``pt2``,
the port's word for the JAX package's "stablehlo") or the reference's
``init.npy`` (``npy``). ``import-tf`` turns a reference TF1 Saver
checkpoint into a port checkpoint (tag "norm", step 0, fresh optimizer)
under ``--out``, which ``train --warm-start``, ``eval`` and ``predict``
load. ``eval``, ``predict`` and ``export`` load the parameters only of the
latest "norm" checkpoint under ``checkpoint.save_dir``, or of the latest
TAG checkpoint under DIR with ``--checkpoint DIR[:TAG]`` (TAG "norm" by
default); with none they warn and use a fresh init. ``--int8`` serves the int8
post-training quantization of those parameters (``eval/quantize.py``):
``eval`` calibrates on its first batch, ``predict`` on its first 8
images, ``export`` on ``--calib-images`` (else on 8 random uint8 images,
with a warning). ``predict``, ``export`` and ``import-tf`` run on the
card unless ``--device cpu`` is given. ``info`` prints the versions, the
card and the config's defaults.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import re
import sys

import torch

from em_adapt_torch.config import ExperimentConfig, apply_overrides, check_supported, flatten
from em_adapt_torch.data.pipeline import (
    DatasetShard, DevicePrefetcher, LearnableSyntheticVOC, SyntheticVOC, VOCSegmentation,
    batch_iterator,
)
from em_adapt_torch.data.voc import VOC_CLASS_NAMES, convert_dataset
from em_adapt_torch.device import card_info, resolve_device, set_deterministic
from em_adapt_torch.eval.miou import miou_from_confusion
from em_adapt_torch.eval.predict import Evaluator
from em_adapt_torch.models.deeplab import build_model
from em_adapt_torch.parallel.mesh import DEFAULT_TIMEOUT, MeshPlan, World, init_world, make_plan
from em_adapt_torch.train.checkpoint import CheckpointManager, split_checkpoint
from em_adapt_torch.train.trainer import Trainer
from em_adapt_torch.utils.logging import MetricLogger
from em_adapt_torch.utils.profiling import measure_estep_us_per_image, trace_steps


def _inference_config(args) -> tuple[ExperimentConfig, str]:
    """The overrides, then ``--checkpoint DIR[:TAG]``'s DIR as
    ``checkpoint.save_dir``; (the config, TAG, "norm" by default)."""
    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    tag = "norm"
    if getattr(args, "checkpoint", None):
        save_dir, tag = split_checkpoint(args.checkpoint, "norm")
        cfg = cfg.replace(checkpoint=dataclasses.replace(cfg.checkpoint, save_dir=save_dir))
    check_supported(cfg, "eval")
    return cfg, tag


def load_inference_model(cfg: ExperimentConfig, device, verb: str, tag: str = "norm"):
    """The model with the parameters only of the latest ``tag`` checkpoint
    under ``checkpoint.save_dir`` (a checkpoint of another optimizer
    config loads too, ``em_adapt_tpu/cli.py:232-246``), or a fresh init
    with a warning when there is none."""
    model = build_model(cfg.model, cfg.train.seed, device)
    checkpoints = CheckpointManager(cfg.checkpoint)
    if checkpoints.latest_step(tag) is None:
        print(f"warning: no checkpoint found; {verb} fresh init")
    else:
        print(f"{verb} checkpoint step {checkpoints.restore_params(model, tag)}")
    return model


def _load_image(path: str, input_size: tuple[int, int]):
    """(decoded RGB uint8, the preprocessed network input) of one image file."""
    import numpy as np
    from PIL import Image

    from em_adapt_torch.data.augment import preprocess_eval

    with Image.open(path) as im:
        raw = np.asarray(im.convert("RGB"))
    return raw, preprocess_eval(raw, None, input_size=input_size)[0]


def cmd_eval(args) -> int:
    cfg, tag = _inference_config(args)
    device = resolve_device(args.device)
    model = load_inference_model(cfg, device, "evaluating", tag)
    if args.synthetic:
        ds = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed + 1)
    else:
        ds = VOCSegmentation(cfg.data, "val")
    if args.int8:
        from em_adapt_torch.eval.quantize import quantize_model

        calib = batch_iterator(ds, cfg.data, batch_size=cfg.eval.batch_size, seed=0, epochs=1,
                               train=False)
        first = next(calib)["image"]
        calib.close()
        model = quantize_model(cfg.model, model, [first])
        print(f"int8 PTQ: calibrated on {first.shape[0]} images")
    evaluator = Evaluator(cfg, model)
    crf_applied = False
    if args.fixed_size:
        if args.crf:
            print("warning: --crf is ignored with --fixed-size (the CRF runs only in the "
                  "original-resolution VOC protocol)", file=sys.stderr)
        batches = batch_iterator(ds, cfg.data, batch_size=cfg.eval.batch_size, seed=0, epochs=1,
                                 train=False)
        with (DevicePrefetcher(batches, device, depth=cfg.data.prefetch)
              if cfg.data.prefetch > 0 else contextlib.nullcontext(batches)) as batches:
            miou, iou = evaluator.evaluate_fixed(batches)
    else:
        # --crf turns the CRF on; without it eval.use_crf decides.
        crf_applied = True if args.crf else cfg.eval.use_crf
        miou, iou = evaluator.evaluate_voc(ds, use_crf=crf_applied)
    for i, v in enumerate(iou):
        name = VOC_CLASS_NAMES[i] if i < len(VOC_CLASS_NAMES) else str(i)
        print(f"  IoU[{name}] = {v:.4f}")
    print(f"mIoU = {miou:.4f}" + (" (with CRF)" if crf_applied else ""))
    return 0


def cmd_predict(args) -> int:
    """Decode, preprocess as ``eval``, run the network in chunks of
    ``eval.batch_size`` (the tail padded with zeros), upsample each
    image's logits to its own size, refine with the CRF if ``--crf``
    (``eval.crf_impl``: on the host or on the card), take the argmax and
    write palette PNGs (``em_adapt_tpu/cli.py::cmd_predict``). With
    ``--int8`` the network is the int8 model, calibrated on the first 8
    inputs themselves (PTQ needs ranges, not labels), whose decoded and
    preprocessed pairs are kept for the first chunk."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from em_adapt_torch.data.augment import resize_bilinear_np
    from em_adapt_torch.data.voc import VOC_PALETTE, index_to_rgb
    from em_adapt_torch.eval.predict import crf_buckets, route

    cfg, tag = _inference_config(args)
    device = resolve_device(args.device)
    model = load_inference_model(cfg, device, "predicting with", tag)
    cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}  # the calibration's, used once

    def load_pair(path: str) -> tuple[np.ndarray, np.ndarray]:
        return cache.pop(path) if path in cache else _load_image(path, cfg.model.input_size)

    if args.int8:
        from em_adapt_torch.eval.quantize import quantize_model

        for path in args.inputs[:8]:
            cache[path] = load_pair(path)
        model = quantize_model(cfg.model, model, [np.stack([c[1] for c in cache.values()])])
        print(f"int8 PTQ: calibrated on {len(cache)} input images")
    evaluator = Evaluator(cfg, model)
    os.makedirs(args.out, exist_ok=True)
    palette = [c for rgb in VOC_PALETTE for c in rgb]
    palette += [224, 224, 192] * (256 - len(VOC_PALETTE))
    on_card_crf = args.crf and cfg.eval.crf_impl == "tpu"
    ceiling, buckets = crf_buckets(cfg.eval)

    def write(pred: np.ndarray, raw: np.ndarray, path: str) -> str:
        stem = os.path.splitext(os.path.basename(path))[0]
        mask = Image.fromarray(pred.astype(np.uint8))
        mask.putpalette(palette)  # "L" -> "P", the indices kept
        mask_path = os.path.join(args.out, f"{stem}.png")
        mask.save(mask_path)
        msg = mask_path
        if args.overlay:
            overlay = (0.5 * raw + 0.5 * index_to_rgb(pred)).astype(np.uint8)
            ov_path = os.path.join(args.out, f"{stem}_overlay.png")
            Image.fromarray(overlay).save(ov_path)
            msg += f" (+ {os.path.basename(ov_path)})"
        return f"{path} -> {msg}  classes={[int(c) for c in np.unique(pred)]}"

    def post_host(lg: np.ndarray, raw: np.ndarray, path: str) -> str:
        up = resize_bilinear_np(lg, raw.shape[:2])
        if args.crf:
            from em_adapt_torch.eval.crf import dense_crf

            e = np.exp(up - up.max(axis=-1, keepdims=True))
            up = dense_crf(e / e.sum(axis=-1, keepdims=True), raw, cfg.eval)
        return write(up.argmax(-1), raw, path)

    bs = max(1, min(cfg.eval.batch_size, len(args.inputs)))
    workers = max(1, cfg.eval.crf_workers if args.crf and not on_card_crf else 2)
    futures = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for start in range(0, len(args.inputs), bs):
            chunk = args.inputs[start:start + bs]
            raws, imgs = zip(*(load_pair(p) for p in chunk))
            imgs = np.stack(imgs)
            imgs = np.concatenate([imgs, np.zeros((bs - len(chunk),) + imgs.shape[1:],
                                                  imgs.dtype)])
            logits = evaluator.logits(imgs)
            for i, (raw, path) in enumerate(zip(raws, chunk)):
                if on_card_crf:
                    oh, ow = raw.shape[:2]
                    pred = evaluator.voc_post_device(logits[i:i + 1], [raw],
                                                     route(oh, ow, ceiling, buckets))[0, :oh, :ow]
                    futures.append(pool.submit(write, pred, raw, path))
                else:
                    futures.append(pool.submit(post_host, logits[i].cpu().numpy(), raw, path))
            while len(futures) > 4 * workers:
                print(futures.pop(0).result())
        for fut in futures:
            print(fut.result())
    return 0


#: A dotted config override, ``section.field=value``.
_OVERRIDE = re.compile(r"[A-Za-z_]\w*(\.\w+)+=")


def split_predict_positionals(args, extras: list[str]) -> None:
    """``predict``'s images and overrides are both positional, and options
    may stand between them. Some Python versions' argparse fill both lists
    from the first run of positionals and leave a later run unrecognized
    (``extras``), others give a later run to the overrides: so every
    positional token that reads ``dotted.key=value`` is an override, and
    every other one an image, in the order given."""
    tokens = [*args.inputs, *args.overrides, *extras]
    args.inputs = [t for t in tokens if not _OVERRIDE.match(t)]
    args.overrides = [t for t in tokens if _OVERRIDE.match(t)]
    if not args.inputs:
        raise SystemExit("predict: no image given")


def cmd_export(args) -> int:
    """The predict program (``pt2``: ``eval/export.py::export_predict_fn``)
    or the reference's init.npy (``npy``) of the latest checkpoint. With
    ``--int8`` the program is the int8 model's, calibrated on
    ``--calib-images`` or, without them, on 8 random uint8 images
    (``em_adapt_tpu/cli.py::cmd_export``)."""
    if args.format == "npy" and (args.int8 or args.calib_images):
        print("error: --int8/--calib-images apply only to --format pt2 (the npy interchange "
              "format is the reference's f32 init.npy contract)", file=sys.stderr)
        return 2
    import numpy as np

    from em_adapt_torch.eval.export import export_params_npy, export_predict_fn

    cfg, tag = _inference_config(args)
    device = resolve_device(args.device)
    model = load_inference_model(cfg, device, "exporting", tag)
    if args.format == "npy":
        export_params_npy(model, args.out)
    else:
        if args.int8:
            from em_adapt_torch.eval.quantize import quantize_model

            if args.calib_images:
                calib = np.stack([_load_image(p, cfg.model.input_size)[1]
                                  for p in args.calib_images])
            else:
                # Ranges only: adequate for the first layer, looser than
                # real images deeper down.
                h, w = cfg.model.input_size
                calib = np.random.default_rng(0).integers(0, 256, size=(8, h, w, 3),
                                                          dtype=np.uint8)
                print("warning: --int8 without --calib-images calibrates on synthetic data; "
                      "pass representative images for production artifacts")
            model = quantize_model(cfg.model, model, [calib])
            print(f"int8 PTQ applied (s8 x s8 -> s32 convolutions), calibrated on "
                  f"{len(calib)} images")
        with open(args.out, "wb") as f:
            f.write(export_predict_fn(cfg, model, args.batch_size))
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return 0


def cmd_import_tf(args) -> int:
    """A reference TF1 Saver checkpoint -> a port checkpoint under
    ``--out``: a fresh state (zeroed optimizer, step 0) whose parameters
    are the checkpoint's, saved as "norm" (``em_adapt_tpu/cli.py::cmd_import_tf``)."""
    from em_adapt_torch.models.convert import to_jax_params
    from em_adapt_torch.models.tf_import import load_tf_checkpoint_params, params_l2

    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    cfg = cfg.replace(checkpoint=dataclasses.replace(cfg.checkpoint, save_dir=args.out,
                                                     async_save=False))
    imported = load_tf_checkpoint_params(args.prefix, cfg.model)
    trainer = Trainer(cfg, device=args.device, steps_per_epoch=1)
    state = trainer.init_state()
    print(f"weight L2 before the import (fresh init): {params_l2(to_jax_params(state.model)):.6f}")
    state.model.load_params(imported)
    print(f"weight L2 after the import: {params_l2(to_jax_params(state.model)):.6f}")
    trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
    n_params = sum(v.size for layer in imported.values() for v in layer.values())
    print(f"imported {args.prefix} -> {args.out} ({len(imported)} layers, {n_params:,} params); "
          f"use with 'train --warm-start {args.out}', 'eval checkpoint.save_dir={args.out}' or "
          f"'predict --checkpoint {args.out}'")
    return 0


def cmd_info(_args) -> int:
    import torch

    from em_adapt_torch import __version__

    print(f"em-adapt-torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card_info() if torch.cuda.is_available() else 'no CUDA device'}")
    for k, v in flatten(ExperimentConfig()).items():
        print(f"  {k} = {v}")
    return 0


def cmd_convert(args) -> int:
    if not args.voc_seg and not args.sbd_cls:
        print("error: need at least one of --voc-seg / --sbd-cls", file=sys.stderr)
        return 2
    convert_dataset(args.voc_seg, args.sbd_cls, args.out)
    return 0


def parse_warm_start(spec: str) -> tuple[str, int | None]:
    """Split 'DIR[:STEP]': a trailing ':<int>' is a step, anything else
    (a path holding ':' included) is the directory."""
    wdir, sep, suffix = spec.rpartition(":")
    if sep and wdir and suffix.isdigit():
        return wdir, int(suffix)
    return spec, None


def make_eval_fn(cfg: ExperimentConfig, args, device, world: World | None = None,
                 plan: MeshPlan | None = None):
    """The periodic eval of ``train``: the mIoU of the training model on
    the split "val" (or ``--synthetic-val`` synthetic images, default a
    quarter of ``--synthetic``, at least 2; with ``--synthetic-learnable``
    the learnable task's "val" category at the training seed, whose own
    offset keeps it apart from the training images), at the fixed
    resolution (``Evaluator.confusion_fixed``) or, with ``train.eval_protocol=voc``,
    by the VOC protocol (``Evaluator.confusion_voc``), so that "best"
    follows the headline number's protocol.

    In a ``world`` laid out by ``plan`` the val set is split over the
    data × space ranks (``DatasetShard`` number ``data index · space +
    space index``), each image evaluated whole; the model ranks of one
    data and space index evaluate the same images together, since their
    forward holds the model axis's collectives. The integer [C, C]
    matrices are summed by one all-reduce over the data × space ranks of
    each model index (``em_adapt_tpu/cli.py:413-500``), so each image
    counts once: the sum is the whole set's matrix bit for bit, the same
    on every rank, and so is "best"."""
    if args.synthetic:
        n_val = args.synthetic_val if args.synthetic_val is not None else max(args.synthetic // 4, 2)
        if args.synthetic_learnable:
            val = LearnableSyntheticVOC(n_val, cfg.model.num_classes, seed=cfg.train.seed,
                                        category="val", image_size=cfg.data.input_size[0])
        else:
            val = SyntheticVOC(n_val, cfg.model.num_classes, seed=cfg.train.seed + 1)
    else:
        val = VOCSegmentation(cfg.data, "val")
    if world is not None:
        plan = plan or make_plan(cfg.mesh, world)
        val = DatasetShard(val, plan.data_index * plan.num_space_shards + plan.space_index,
                           plan.ddp_size)

    def eval_fn(state) -> float:
        if cfg.train.eval_protocol == "voc":
            confusion = Evaluator(cfg, state.model).confusion_voc(val)
        else:
            batches = batch_iterator(val, cfg.data, batch_size=cfg.eval.batch_size, seed=0,
                                     epochs=1, train=False)
            with (DevicePrefetcher(batches, device, depth=cfg.data.prefetch)
                  if cfg.data.prefetch > 0 else contextlib.nullcontext(batches)) as batches:
                confusion = Evaluator(cfg, state.model).confusion_fixed(batches)
        if world is not None:
            confusion = world.sum_host(confusion, plan)
        return miou_from_confusion(confusion)[0]

    return eval_fn


#: The "gpu-perf" levers: bf16 compute with block 1 on K2 and K3, the uint8
#: wire, labels shrunk to the 41x41 score map on the host.
_GPU_PERF = ("model.compute_dtype=bfloat16", "model.block1_impl=pallas",
             "data.wire_dtype=uint8", "data.train_label_size=(41,41)")


def train_presets() -> dict[str, tuple[str, ...]]:
    """Named override bundles that ``train --preset`` applies before the
    dotted overrides (``em_adapt_tpu/cli.py:249-286``, named for the card):

    * "reference": the reference's recipe (f32, batch 6 x accumulation 5);
    * "gpu-perf": the same update with the card's levers (:data:`_GPU_PERF`);
    * "gpu-perf-fold": "gpu-perf" with the effective batch 30 folded into
      one batch-30 step, accumulation 1 (the same update for weak
      supervision; not under semi-supervision, where the strong images'
      masked cross-entropy normalizes per batch, and ``train`` warns);
    * "gpu-highres": 513x513, bf16, per-block remat, the uint8 wire (the
      65x65 score map: K1 over a cluster of CTAs an image). The JAX
      preset also sets ``mesh.axes=(("data",-1),("space",3))``, which
      fails on one device (1 is not divisible by 3); one H100 holds the
      513² step whole, so this preset leaves the mesh alone and runs on
      one card. ``--multihost`` with ``mesh.axes=(("data",-1),("space",3))``
      gives the JAX layout: the image's rows over three processes
      (``parallel/spatial.py``).

    The JAX presets' ``train.macro_steps`` and ``train.rng_impl`` are left
    out: the port accepts them and does not use them (``config.py``)."""
    return {
        "reference": (),
        "gpu-perf": _GPU_PERF,
        "gpu-perf-fold": _GPU_PERF + ("train.batch_size=30", "optim.accum_steps=1"),
        "gpu-highres": ("model.compute_dtype=bfloat16", "data.wire_dtype=uint8",
                        "model.input_size=(513,513)", "model.remat=true"),
    }


#: ``train``'s warning for "gpu-perf-fold" under semi-supervision
#: (``em_adapt_tpu/cli.py:347-353``).
FOLD_SEMI_WARNING = (
    "WARNING: gpu-perf-fold with semi-supervised training is NOT update-identical to the "
    "batch-6 x accum-5 recipe: the strong-path CE normalizes by each batch's valid (non-255) "
    "pixel count, so the batch-30 mean differs from the mean of five batch-6 means whenever "
    "microbatches carry different numbers of void pixels. Use --preset gpu-perf for exact "
    "accumulation semantics.")


def train_config(args) -> ExperimentConfig:
    """``train``'s config: the preset's overrides, then the user's
    (``--strong-list``/``--strong-fraction`` turn on semi-supervision)."""
    cfg = apply_overrides(ExperimentConfig(), [*train_presets()[args.preset], *args.overrides])
    if args.strong_list or args.strong_fraction > 0:
        cfg = cfg.replace(semi_supervised=True)
    if args.preset == "gpu-perf-fold" and cfg.semi_supervised:
        print(FOLD_SEMI_WARNING, file=sys.stderr)
    return cfg


def cmd_train(args) -> int:
    if args.warm_start and args.resume:
        print("error: --warm-start and --resume are mutually exclusive", file=sys.stderr)
        return 2
    if args.synthetic_val is not None and args.synthetic_val <= 0:
        print(f"error: --synthetic-val must be positive, got {args.synthetic_val} (omit the "
              "flag for the size/4 default, or drop train.eval_every_steps to disable eval)",
              file=sys.stderr)
        return 2
    if args.synthetic_learnable and not args.synthetic:
        print("error: --synthetic-learnable needs --synthetic N", file=sys.stderr)
        return 2
    if not args.multihost and (args.coordinator or args.num_processes is not None
                               or args.process_id is not None):
        print("error: --coordinator, --num-processes and --process-id need --multihost",
              file=sys.stderr)
        return 2
    cfg = train_config(args)
    world = None
    if args.multihost:
        world = init_world(args.device, coordinator=args.coordinator,
                           num_processes=args.num_processes, process_id=args.process_id,
                           backend=args.dist_backend, timeout=args.dist_timeout)
    try:
        return _train(args, cfg, world)
    finally:
        if world is not None:
            world.close()


def _train(args, cfg: ExperimentConfig, world: World | None) -> int:
    """``train`` once the process group, if any, is joined: rank 0 prints,
    logs and writes; the other ranks stay quiet."""
    main_rank = world is None or world.is_main
    say = print if main_rank else (lambda *a, **k: None)
    if args.deterministic:
        set_deterministic()
    if args.synthetic_learnable:
        data = LearnableSyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed,
                                     image_size=cfg.data.input_size[0],
                                     strong_fraction=args.strong_fraction)
    elif args.synthetic:
        data = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed,
                            strong_fraction=args.strong_fraction)
    else:
        data = VOCSegmentation(cfg.data, "train", strong_list=args.strong_list)
    # The LR schedule counts epochs of len(data) // batch microbatch steps.
    trainer = Trainer(cfg, device=args.device,
                      steps_per_epoch=max(len(data) // cfg.train.batch_size, 1), world=world)
    plan = trainer.plan
    if world is not None:
        say(f"world: {world.size} processes as data {plan.num_data_shards} x space "
            f"{plan.num_space_shards} x model {plan.num_model_shards}, rank 0 on {world.device}, "
            f"global batch {cfg.train.batch_size} ({cfg.train.batch_size // plan.num_data_shards} "
            f"a data index)")
    state = trainer.init_state()
    if args.warm_start:
        wdir, wstep = parse_warm_start(args.warm_start)
        trainer.warm_start(state, wdir, args.warm_start_tag, wstep)
        say(f"warm start: params from {wdir} (tag={args.warm_start_tag}, step="
            f"{wstep if wstep is not None else 'latest'}); optimizer/step/LR fresh")
    latest = trainer.checkpointer.latest_step("norm") if args.resume else None
    if args.resume and world is not None:
        # Rank 0's view decides, so that every rank restores the same step.
        latest = int(world.broadcast(-1 if latest is None else latest))
        latest = None if latest < 0 else latest
    if args.resume and latest is None:
        say("--resume: no checkpoint found, starting fresh")
    elif latest is not None:
        state = trainer.restore_state("norm", latest)
        say(f"resumed from step {latest}")
    eval_fn = (make_eval_fn(cfg, args, trainer.device, world, plan)
               if cfg.train.eval_every_steps else None)
    logger = MetricLogger(args.log_jsonl) if main_rank else None
    log_fn = logger
    if cfg.train.calibrate_estep:
        local_batch = cfg.train.batch_size // plan.num_data_shards
        estep_us = round(measure_estep_us_per_image(cfg.model, cfg.estep, local_batch,
                                                    trainer.device), 1)
        say(f"estep calibration: {estep_us} us/image (impl={cfg.estep.impl}, "
            f"batch={local_batch})")
        if logger is not None:
            def log_fn(m, _v=estep_us):
                logger({**m, "estep_us_per_image_calib": _v} if "loss" in m else m)

    # One batch a microbatch step: the restored step is the stream position.
    batches = batch_iterator(data, cfg.data, batch_size=cfg.train.batch_size, seed=cfg.train.seed,
                             start_step=state.step,
                             process_shard=None if world is None else (plan.data_index,
                                                                       plan.num_data_shards),
                             row_shard=(plan.space_index, plan.num_space_shards))
    profile_dir = args.profile_dir
    if profile_dir is not None and world is not None and world.size > 1:
        profile_dir = os.path.join(profile_dir, f"rank{world.rank}")
    try:
        with trace_steps(profile_dir, trainer.device) as step_hook:
            records = trainer.fit(state, batches, num_steps=args.steps, log_fn=log_fn,
                                  eval_fn=eval_fn, step_hook=step_hook)
    finally:
        batches.close()  # fit has closed its prefetcher, so no thread is inside the generator
        if logger is not None:
            logger.close()
    if trainer.checkpointer.last_saved.get("norm") != state.step:  # not saved at a SIGTERM
        trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
    if world is not None:
        world.check_same(state.step, "the step training ended at")
        launches = [(r["estep_launches"], r["block1_fwd_launches"], r["block1_bwd_launches"])
                    for r in records]
        peak = (f"{torch.cuda.max_memory_allocated(trainer.device)} B"
                if trainer.device.type == "cuda" else "not measured (no card)")
        print(f"rank {world.rank}: K1/K2/K3 launches a step {launches}; peak device memory {peak}",
              flush=True)
    say(f"done at step {state.step}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m em_adapt_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    conv = sub.add_parser("convert", help="build the SegmentationClassAug index masks")
    conv.add_argument("--voc-seg", default=None, help="VOC SegmentationClass directory")
    conv.add_argument("--sbd-cls", default=None, help="SBD benchmark cls directory")
    conv.add_argument("--out", required=True, help="output SegmentationClassAug directory")
    train = sub.add_parser("train", help="train on the VOC split 'train' or on synthetic data")
    train.add_argument("--synthetic", type=int, default=None, metavar="N",
                       help="train on N synthetic images instead of the VOC tree")
    train.add_argument("--synthetic-learnable", action="store_true",
                       help="with --synthetic: the learnable color-blob task "
                            "(LearnableSyntheticVOC, blobs of data.input_size) instead of noise")
    train.add_argument("--steps", type=int, default=None,
                       help="cap on the total microbatch steps (default: train.epochs epochs)")
    train.add_argument("--resume", action="store_true",
                       help="continue from the latest 'norm' checkpoint")
    train.add_argument("--device", default=None, help="default: the CUDA card")
    train.add_argument("--log-jsonl", default=None, metavar="PATH",
                       help="also append every log record to this JSONL file")
    train.add_argument("--warm-start", default=None, metavar="DIR[:STEP]",
                       help="params-only init from the checkpoints under DIR (latest step "
                            "unless :STEP); optimizer, step and LR schedule start fresh")
    train.add_argument("--warm-start-tag", default="norm",
                       help="checkpoint tag to warm-start from (e.g. best)")
    train.add_argument("--strong-list", default=None, metavar="PATH",
                       help="ids whose masks are pixel annotations (semi-supervised EM)")
    train.add_argument("--strong-fraction", type=float, default=0.0,
                       help="synthetic data: the fraction of images flagged strong")
    train.add_argument("--synthetic-val", type=int, default=None, metavar="N",
                       help="periodic eval on N synthetic images (default: --synthetic / 4)")
    train.add_argument("--preset", choices=tuple(train_presets()), default="reference",
                       help="override bundle applied before the dotted overrides: 'reference' "
                            "(the reference's recipe), 'gpu-perf' (bf16, block 1 on K2/K3, "
                            "uint8 wire, 41x41 labels), 'gpu-perf-fold' (gpu-perf folded into "
                            "one batch-30 step; not update-identical under semi-supervision), "
                            "'gpu-highres' (513x513, bf16, remat, uint8 wire)")
    train.add_argument("--profile-dir", default=None, metavar="DIR",
                       help="write a torch.profiler trace of the first steps to DIR (in a "
                            "world of several processes, rank R's to DIR/rankR)")
    train.add_argument("--deterministic", action="store_true",
                       help="cuDNN's deterministic algorithms, no autotuning (before the model "
                            "is built): runs in separate processes then sum alike")
    train.add_argument("--multihost", action="store_true",
                       help="train as one process of several, one a card (torch.distributed; "
                            "without --coordinator, torchrun's environment)")
    train.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                       help="with --multihost: rank 0's address for the rendezvous (or a "
                            "file:// path on a filesystem that every process sees)")
    train.add_argument("--num-processes", type=int, default=None,
                       help="with --coordinator: the number of processes")
    train.add_argument("--process-id", type=int, default=None,
                       help="with --coordinator: this process's rank")
    train.add_argument("--dist-backend", choices=("auto", "gloo"), default="auto",
                       help="with --multihost: 'auto' (NCCL between cards, gloo on the CPU) or "
                            "'gloo' (also for CUDA tensors: several processes on one card)")
    train.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT, metavar="S",
                       help="with --multihost: seconds the rendezvous and each collective may "
                            "wait for the other processes before the run fails")
    train.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    ev = sub.add_parser("eval", help="mIoU of the latest checkpoint on the VOC split 'val'")
    ev.add_argument("--checkpoint", default=None, metavar="DIR[:TAG]",
                    help="checkpoint directory and tag (default: checkpoint.save_dir, 'norm')")
    ev.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="evaluate on N synthetic images instead of the VOC tree")
    ev.add_argument("--fixed-size", action="store_true",
                    help="evaluate at the training resolution instead of the VOC protocol")
    ev.add_argument("--crf", action="store_true",
                    help="refine with the dense CRF (VOC protocol; where: eval.crf_impl)")
    ev.add_argument("--int8", action="store_true",
                    help="evaluate the int8 PTQ model (calibrated on the first eval batch)")
    ev.add_argument("--device", default=None, help="default: the CUDA card")
    ev.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    pr = sub.add_parser("predict", help="segment images into palette PNG masks")
    pr.add_argument("inputs", nargs="+", metavar="IMG", help="image files (jpg/png)")
    pr.add_argument("--out", required=True, help="output directory for the masks")
    pr.add_argument("--checkpoint", default=None, metavar="DIR[:TAG]",
                    help="checkpoint directory and tag (default: checkpoint.save_dir, 'norm')")
    pr.add_argument("--crf", action="store_true",
                    help="refine with the dense CRF (where: eval.crf_impl)")
    pr.add_argument("--overlay", action="store_true",
                    help="also write RGB overlays beside the masks")
    pr.add_argument("--int8", action="store_true",
                    help="predict with the int8 PTQ model (calibrated on the inputs themselves)")
    pr.add_argument("--device", default=None, help="default: the CUDA card")
    pr.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    ex = sub.add_parser("export", help="the predict program (torch.export) or the weights as "
                                       "the reference's init.npy")
    ex.add_argument("--out", required=True, help="output path (.pt2 or .npy)")
    ex.add_argument("--checkpoint", default=None, metavar="DIR[:TAG]",
                    help="checkpoint directory and tag (default: checkpoint.save_dir, 'norm')")
    ex.add_argument("--batch-size", type=int, default=None,
                    help="the program's batch (default: eval.batch_size)")
    ex.add_argument("--format", choices=("pt2", "npy"), default="pt2",
                    help="'pt2': torch.export of predict; 'npy': the reference's init.npy "
                         "({layer: {w: HWIO, b}}, reference deeplab.py:126-129)")
    ex.add_argument("--int8", action="store_true",
                    help="export the int8 PTQ model (calibrated on --calib-images, else on "
                         "random uint8 images)")
    ex.add_argument("--calib-images", nargs="*", default=None, metavar="IMG",
                    help="calibration images for --int8")
    ex.add_argument("--device", default=None, help="default: the CUDA card")
    ex.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    it = sub.add_parser("import-tf", help="a reference tf.train.Saver checkpoint -> a port "
                                          "checkpoint (train --warm-start, eval, predict)")
    it.add_argument("prefix", help="Saver prefix, e.g. saver/norm-24000 (no .index/.data suffix)")
    it.add_argument("--out", required=True,
                    help="checkpoint directory to write (tag 'norm', step 0)")
    it.add_argument("--device", default=None, help="default: the CUDA card")
    it.add_argument("overrides", nargs="*",
                    help="dotted config overrides, key=value (the checkpoint's architecture)")
    sub.add_parser("info", help="versions, the card and the config's defaults")
    args, extras = parser.parse_known_args(argv)
    if args.command == "predict":
        split_predict_positionals(args, extras)
    elif args.command == "export" and args.calib_images:
        # --calib-images takes the overrides after it: they read dotted.key=value.
        args.overrides += [t for t in args.calib_images if _OVERRIDE.match(t)]
        args.calib_images = [t for t in args.calib_images if not _OVERRIDE.match(t)]
    if args.command != "predict" and extras:
        parser.error(f"unrecognized arguments: {' '.join(extras)}")
    return {"convert": cmd_convert, "train": cmd_train, "eval": cmd_eval,
            "predict": cmd_predict, "export": cmd_export, "import-tf": cmd_import_tf,
            "info": cmd_info}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
