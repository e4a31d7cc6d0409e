"""Command line of the port: ``python -m em_adapt_torch train|eval ...``.

    python -m em_adapt_torch train --synthetic 64 --steps 10 [key=value ...]
    python -m em_adapt_torch eval --synthetic 62 --fixed-size [key=value ...]

``train`` trains on ``SyntheticVOC`` with the reference recipe (or the
dotted config overrides given) and prints one JSON record per step.
``eval`` scores a fresh init (checkpoints are ROADMAP.md Queue 1 item 2)
on a synthetic val split at the training resolution and prints the
per-class IoU and the mIoU. Both run on the CUDA card; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from em_adapt_torch.config import ExperimentConfig, apply_overrides, check_supported
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
from em_adapt_torch.device import resolve_device
from em_adapt_torch.eval.miou import VOC_CLASS_NAMES
from em_adapt_torch.eval.predict import Evaluator
from em_adapt_torch.models.deeplab import build_model
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
    print("warning: no checkpoint found; evaluating fresh init")
    model = build_model(cfg.model, cfg.train.seed, device)
    ds = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed + 1)
    batches = batch_iterator(ds, cfg.data, batch_size=cfg.eval.batch_size, seed=0, epochs=1,
                             train=False)
    miou, iou = Evaluator(cfg, model).evaluate_fixed(batches)
    for i, v in enumerate(iou):
        name = VOC_CLASS_NAMES[i] if i < len(VOC_CLASS_NAMES) else str(i)
        print(f"  IoU[{name}] = {v:.4f}")
    print(f"mIoU = {miou:.4f}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m em_adapt_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    train = sub.add_parser("train", help="train on synthetic VOC-shaped data")
    train.add_argument("--synthetic", type=int, required=True, metavar="N",
                       help="number of synthetic images")
    train.add_argument("--steps", type=int, required=True, help="microbatch steps")
    train.add_argument("--device", default=None, help="default: the CUDA card")
    train.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    ev = sub.add_parser("eval", help="mIoU of a fresh init on a synthetic val split")
    ev.add_argument("--synthetic", type=int, required=True, metavar="N",
                    help="number of synthetic images")
    ev.add_argument("--fixed-size", action="store_true",
                    help="evaluate at the training resolution (the protocol ported)")
    ev.add_argument("--crf", action="store_true", help="denseCRF (not ported yet)")
    ev.add_argument("--int8", action="store_true", help="int8 PTQ (not ported yet)")
    ev.add_argument("--device", default=None, help="default: the CUDA card")
    ev.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    args = parser.parse_args(argv)
    if args.command == "eval":
        return cmd_eval(args)

    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    data = SyntheticVOC(args.synthetic, cfg.model.num_classes, seed=cfg.train.seed)
    # The LR schedule counts epochs of len(data) // batch microbatch steps.
    trainer = Trainer(cfg, device=args.device,
                      steps_per_epoch=max(len(data) // cfg.train.batch_size, 1))
    batches = batch_iterator(data, cfg.data, batch_size=cfg.train.batch_size, seed=cfg.train.seed)
    state = trainer.init_state()
    trainer.fit(state, batches, num_steps=args.steps,
                log_fn=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
