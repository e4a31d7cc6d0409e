"""The whole evaluation's share of the card's bf16 peak, in %: the
network's forward FLOP an image at its input size (``work.forward_flops``)
times the window's images over the window's wall. The upsample and the CRF
are not counted as FLOP."""

import work


def read(r: dict):
    if r.get("kind") != "eval" or not r.get("window_s"):
        return None
    h, w = r["input_size"]
    flops = work.forward_flops(h, w, 1, num_classes=r["num_classes"]) * r["images"]
    return work.mfu_percent(flops, r["window_s"])
