"""The whole training step's share of the card's bf16 peak, in %: the
model's FLOP an image (forward and both gradients, no recompute;
``work.train_flops``) times the window's images over the window's wall."""

import work


def read(r: dict):
    if r.get("kind") != "train" or not r.get("window_s"):
        return None
    return work.mfu_percent(r["flops"], r["window_s"])
