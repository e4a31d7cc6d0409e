"""Command line of the port: ``python -m em_adapt_torch train ...``.

    python -m em_adapt_torch train --synthetic 64 --steps 10 [key=value ...]

trains on ``SyntheticVOC`` with the reference recipe (or the dotted
config overrides given) and prints one JSON record per step. It runs on
the CUDA card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from em_adapt_torch.config import ExperimentConfig, apply_overrides
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator
from em_adapt_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m em_adapt_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    train = sub.add_parser("train", help="train on synthetic VOC-shaped data")
    train.add_argument("--synthetic", type=int, required=True, metavar="N",
                       help="number of synthetic images")
    train.add_argument("--steps", type=int, required=True, help="microbatch steps")
    train.add_argument("--device", default=None, help="default: the CUDA card")
    train.add_argument("overrides", nargs="*", help="dotted config overrides, key=value")
    args = parser.parse_args(argv)

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
