"""The device's idle share of the traced span, in %: 1 - the union of its
kernels', copies' and memsets' intervals over the span's length."""


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "eval" or not trace or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
