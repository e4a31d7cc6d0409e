"""The card's ms a step between the CUDA events at the bounds of the
training step's ``step.forward`` span, over the traced span's steps (the
events are recorded only while the profiler records). Where the card paces
the traced span (``train-321-fold30``, which idles 1-3% there) this is the
stage's device time; where the profiled host paces it (513's traced span
idles 10-28%, b6x5's 64%) the pair also counts the card's idle inside the
stage, so only fold30 lists it."""

import spans


def read(r: dict):
    return spans.device_ms(spans.train_traced(r), "step.forward")
