"""The host's ms an image in an evaluation pass's ``eval.forward`` span
(the batch stacked and padded, uploaded, the network launched), over the
untraced window's passes."""

import spans


def read(r: dict):
    return spans.host_ms(spans.eval_window(r), "eval.forward", per_image=True)
