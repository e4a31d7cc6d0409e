"""The device's idle share of the window, in %: 1 - the device's busy
seconds a step (the union of its kernels', copies' and memsets' intervals
over the traced span's steps) over the window's wall seconds a step. The
span runs inside the window's own ``fit`` call, but the profiler's
recording of every operator slows the host's launch (by about half in the
host-paced cell), so the span's own idle share would read that cost; the
device's work a step is the same traced or not."""


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "train" or not trace or not trace.get("busy_s") or not r.get("steps"):
        return None
    return 100.0 * (1.0 - (trace["busy_s"] / r["trace_steps"]) / (r["window_s"] / r["steps"]))
