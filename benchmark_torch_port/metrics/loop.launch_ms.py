"""The host's time to launch one step, in ms: the mean over the window's
steps of ``Trainer.fit``'s per-step ``seconds`` (the host clock from the
batch in hand to the step's launch returning). Where the card paces the
loop, the launch waits on the card and this reads the step's pace; it
reads the launch's own cost only where the host paces it."""

import statistics


def read(r: dict):
    launches = r.get("launch_s")
    if r.get("kind") != "train" or not launches:
        return None
    return 1e3 * statistics.fmean(launches)
