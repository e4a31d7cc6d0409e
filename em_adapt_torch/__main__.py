"""Command line of the port: ``python -m em_adapt_torch convert|train|eval ...``.

    python -m em_adapt_torch convert --voc-seg DIR [--sbd-cls DIR] --out DIR
    python -m em_adapt_torch train [--synthetic N [--synthetic-learnable]] [--steps N]
        [--resume | --warm-start DIR[:STEP]] [--log-jsonl PATH]
        [--strong-list PATH | --strong-fraction F] [--synthetic-val N] [key=value ...]
    python -m em_adapt_torch eval [--synthetic N] [--fixed-size] [--crf] [key=value ...]

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
``eval`` loads the latest "norm" parameters
(a fresh init, with a warning, when there are none) and scores them on the
split "val" (or a synthetic one) by the VOC protocol (each image at its
original resolution; ``--crf`` or ``eval.use_crf`` adds the dense CRF, on
the host or, with ``eval.crf_impl=tpu``, on the card), or at the training
resolution with ``--fixed-size``: per-class IoU and mIoU. Both run on
the CUDA card (``--device cpu`` runs on the CPU); training and the fixed
protocol copy their batches there through ``DevicePrefetcher`` unless
``data.prefetch=0``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from em_adapt_torch.config import ExperimentConfig, apply_overrides, check_supported
from em_adapt_torch.data.pipeline import (
    DevicePrefetcher, LearnableSyntheticVOC, SyntheticVOC, VOCSegmentation, batch_iterator,
)
from em_adapt_torch.data.voc import VOC_CLASS_NAMES, convert_dataset
from em_adapt_torch.device import resolve_device
from em_adapt_torch.eval.miou import miou_from_confusion
from em_adapt_torch.eval.predict import Evaluator
from em_adapt_torch.models.deeplab import build_model
from em_adapt_torch.train.checkpoint import CheckpointManager
from em_adapt_torch.train.trainer import Trainer
from em_adapt_torch.utils.logging import MetricLogger
from em_adapt_torch.utils.profiling import measure_estep_us_per_image


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item} brings it")


def cmd_eval(args) -> int:
    if args.int8:
        raise _not_ported("--int8", "Queue 1 item 9 (int8 PTQ)")
    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    check_supported(cfg, "eval")
    device = resolve_device(args.device)
    model = build_model(cfg.model, cfg.train.seed, device)
    checkpoints = CheckpointManager(cfg.checkpoint)
    if checkpoints.latest_step("norm") is None:
        print("warning: no checkpoint found; evaluating fresh init")
    else:
        print(f"evaluating checkpoint step {checkpoints.restore_params(model, 'norm')}")
    if args.synthetic:
        ds = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed + 1)
    else:
        ds = VOCSegmentation(cfg.data, "val")
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


def make_eval_fn(cfg: ExperimentConfig, args, device):
    """The periodic eval of ``train``: the mIoU of the training model on
    the split "val" (or ``--synthetic-val`` synthetic images, default a
    quarter of ``--synthetic``, at least 2; with ``--synthetic-learnable``
    the learnable task's "val" category at the training seed, whose own
    offset keeps it apart from the training images), at the fixed
    resolution (``Evaluator.confusion_fixed``) or, with ``train.eval_protocol=voc``,
    by the VOC protocol (``Evaluator.confusion_voc``), so that "best"
    follows the headline number's protocol."""
    if args.synthetic:
        n_val = args.synthetic_val if args.synthetic_val is not None else max(args.synthetic // 4, 2)
        if args.synthetic_learnable:
            val = LearnableSyntheticVOC(n_val, cfg.model.num_classes, seed=cfg.train.seed,
                                        category="val", image_size=cfg.data.input_size[0])
        else:
            val = SyntheticVOC(n_val, cfg.model.num_classes, seed=cfg.train.seed + 1)
    else:
        val = VOCSegmentation(cfg.data, "val")

    def eval_fn(state) -> float:
        if cfg.train.eval_protocol == "voc":
            return miou_from_confusion(Evaluator(cfg, state.model).confusion_voc(val))[0]
        batches = batch_iterator(val, cfg.data, batch_size=cfg.eval.batch_size, seed=0,
                                 epochs=1, train=False)
        with (DevicePrefetcher(batches, device, depth=cfg.data.prefetch)
              if cfg.data.prefetch > 0 else contextlib.nullcontext(batches)) as batches:
            confusion = Evaluator(cfg, state.model).confusion_fixed(batches)
        return miou_from_confusion(confusion)[0]

    return eval_fn


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
    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    if args.strong_list or args.strong_fraction > 0:
        cfg = cfg.replace(semi_supervised=True)
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
                      steps_per_epoch=max(len(data) // cfg.train.batch_size, 1))
    state = trainer.init_state()
    if args.warm_start:
        wdir, wstep = parse_warm_start(args.warm_start)
        trainer.warm_start(state, wdir, args.warm_start_tag, wstep)
        print(f"warm start: params from {wdir} (tag={args.warm_start_tag}, step="
              f"{wstep if wstep is not None else 'latest'}); optimizer/step/LR fresh")
    latest = trainer.checkpointer.latest_step("norm") if args.resume else None
    if args.resume and latest is None:
        print("--resume: no checkpoint found, starting fresh")
    elif latest is not None:
        state = trainer.restore_state("norm", latest)
        print(f"resumed from step {latest}")
    eval_fn = make_eval_fn(cfg, args, trainer.device) if cfg.train.eval_every_steps else None
    logger = MetricLogger(args.log_jsonl)
    log_fn = logger
    if cfg.train.calibrate_estep:
        estep_us = round(measure_estep_us_per_image(cfg.model, cfg.estep, cfg.train.batch_size,
                                                    trainer.device), 1)
        print(f"estep calibration: {estep_us} us/image (impl={cfg.estep.impl}, "
              f"batch={cfg.train.batch_size})")

        def log_fn(m, _v=estep_us):
            logger({**m, "estep_us_per_image_calib": _v} if "loss" in m else m)

    # One batch a microbatch step: the restored step is the stream position.
    batches = batch_iterator(data, cfg.data, batch_size=cfg.train.batch_size, seed=cfg.train.seed,
                             start_step=state.step)
    try:
        trainer.fit(state, batches, num_steps=args.steps, log_fn=log_fn, eval_fn=eval_fn)
    finally:
        batches.close()  # fit has closed its prefetcher, so no thread is inside the generator
        logger.close()
    trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
    print(f"done at step {state.step}")
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
    train.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    ev = sub.add_parser("eval", help="mIoU of the latest checkpoint on the VOC split 'val'")
    ev.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="evaluate on N synthetic images instead of the VOC tree")
    ev.add_argument("--fixed-size", action="store_true",
                    help="evaluate at the training resolution instead of the VOC protocol")
    ev.add_argument("--crf", action="store_true",
                    help="refine with the dense CRF (VOC protocol; where: eval.crf_impl)")
    ev.add_argument("--int8", action="store_true", help="int8 PTQ (not ported yet)")
    ev.add_argument("--device", default=None, help="default: the CUDA card")
    ev.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    args = parser.parse_args(argv)
    return {"convert": cmd_convert, "train": cmd_train, "eval": cmd_eval}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
