"""The card's ms an image between the CUDA events at the bounds of each
``crf.refine`` span (the mean field of a chunk of a bucket batch), over the
traced pass's images."""

import spans


def read(r: dict):
    return spans.device_ms(spans.eval_traced(r), "crf.refine", per_image=True)
