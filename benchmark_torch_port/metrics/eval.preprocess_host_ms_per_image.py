"""The host's ms an image in an evaluation pass's ``eval.load`` and
``eval.preprocess`` spans (the image handed over, resized to the network's
input in numpy, routed to its bucket), over the untraced window's passes."""

import spans


def read(r: dict):
    return spans.host_ms(spans.eval_window(r), "eval.load", "eval.preprocess", per_image=True)
