"""Command line of the port: ``python -m em_adapt_torch convert|train|eval ...``.

    python -m em_adapt_torch convert --voc-seg DIR [--sbd-cls DIR] --out DIR
    python -m em_adapt_torch train [--synthetic N] [--steps N] [--resume] [key=value ...]
    python -m em_adapt_torch eval [--synthetic N] --fixed-size [key=value ...]

``convert`` writes the index-PNG masks of ``SegmentationClassAug`` from
VOC's RGB masks and SBD's .mat files. ``train`` trains on the VOC split
"train" under ``data.main_path`` and ``data.list_dir`` (or on
``SyntheticVOC`` with ``--synthetic``) with the reference recipe (or the
dotted config overrides given), prints one JSON record per step and saves
full-state checkpoints under ``checkpoint.save_dir`` ("norm" on its
cadence, at a SIGTERM and at the end; "lr" before each LR drop).
``--resume`` continues from the latest "norm" checkpoint, on the batches
the run would have seen next. ``eval`` loads the latest "norm" parameters
(a fresh init, with a warning, when there are none) and scores them on the
split "val" (or a synthetic one) at the training resolution: per-class IoU
and mIoU. Both run on the CUDA card (``--device cpu`` runs on the CPU)
and copy their batches there through ``DevicePrefetcher`` unless
``data.prefetch=0``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from em_adapt_torch.config import ExperimentConfig, apply_overrides, check_supported
from em_adapt_torch.data.pipeline import (
    DevicePrefetcher, SyntheticVOC, VOCSegmentation, batch_iterator,
)
from em_adapt_torch.data.voc import VOC_CLASS_NAMES, convert_dataset
from em_adapt_torch.device import resolve_device
from em_adapt_torch.eval.predict import Evaluator
from em_adapt_torch.models.deeplab import build_model
from em_adapt_torch.train.checkpoint import CheckpointManager
from em_adapt_torch.train.trainer import Trainer


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item} brings it")


def cmd_eval(args) -> int:
    if args.crf:
        raise _not_ported("--crf", "Queue 1 item 7 (the VOC protocol and the CRF)")
    if args.int8:
        raise _not_ported("--int8", "Queue 1 item 9 (int8 PTQ)")
    if not args.fixed_size:
        raise _not_ported("the VOC protocol (eval without --fixed-size)",
                          "Queue 1 item 7 (the VOC protocol and the CRF)")
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
    batches = batch_iterator(ds, cfg.data, batch_size=cfg.eval.batch_size, seed=0, epochs=1,
                             train=False)
    with (DevicePrefetcher(batches, device, depth=cfg.data.prefetch) if cfg.data.prefetch > 0
          else contextlib.nullcontext(batches)) as batches:
        miou, iou = Evaluator(cfg, model).evaluate_fixed(batches)
    for i, v in enumerate(iou):
        name = VOC_CLASS_NAMES[i] if i < len(VOC_CLASS_NAMES) else str(i)
        print(f"  IoU[{name}] = {v:.4f}")
    print(f"mIoU = {miou:.4f}")
    return 0


def cmd_convert(args) -> int:
    if not args.voc_seg and not args.sbd_cls:
        print("error: need at least one of --voc-seg / --sbd-cls", file=sys.stderr)
        return 2
    convert_dataset(args.voc_seg, args.sbd_cls, args.out)
    return 0


def cmd_train(args) -> int:
    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    if args.synthetic:
        data = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed)
    else:
        data = VOCSegmentation(cfg.data, "train")
    # The LR schedule counts epochs of len(data) // batch microbatch steps.
    trainer = Trainer(cfg, device=args.device,
                      steps_per_epoch=max(len(data) // cfg.train.batch_size, 1))
    latest = trainer.checkpointer.latest_step("norm") if args.resume else None
    if latest is None:
        if args.resume:
            print("--resume: no checkpoint found, starting fresh")
        state = trainer.init_state()
    else:
        state = trainer.restore_state("norm", latest)
        print(f"resumed from step {latest}")
    # One batch a microbatch step: the restored step is the stream position.
    batches = batch_iterator(data, cfg.data, batch_size=cfg.train.batch_size, seed=cfg.train.seed,
                             start_step=state.step)
    try:
        trainer.fit(state, batches, num_steps=args.steps,
                    log_fn=lambda r: print(json.dumps(r), flush=True))
    finally:
        batches.close()  # fit has closed its prefetcher, so no thread is inside the generator
    trainer.checkpointer.save(state, "norm")
    trainer.checkpointer.close()
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
    train.add_argument("--steps", type=int, default=None,
                       help="cap on the total microbatch steps (default: train.epochs epochs)")
    train.add_argument("--resume", action="store_true",
                       help="continue from the latest 'norm' checkpoint")
    train.add_argument("--device", default=None, help="default: the CUDA card")
    train.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    ev = sub.add_parser("eval", help="mIoU of the latest checkpoint on the VOC split 'val'")
    ev.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="evaluate on N synthetic images instead of the VOC tree")
    ev.add_argument("--fixed-size", action="store_true",
                    help="evaluate at the training resolution (the protocol ported)")
    ev.add_argument("--crf", action="store_true", help="denseCRF (not ported yet)")
    ev.add_argument("--int8", action="store_true", help="int8 PTQ (not ported yet)")
    ev.add_argument("--device", default=None, help="default: the CUDA card")
    ev.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    args = parser.parse_args(argv)
    return {"convert": cmd_convert, "train": cmd_train, "eval": cmd_eval}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
