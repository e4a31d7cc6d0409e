"""The host's ms a step in the program's explicit waits on the card
(``LateLossReader.read``, ``full_sync``; the counter ``host_wait_ns`` of
``em_adapt_torch/utils/tracing.py``), over the untraced window's steps."""

import spans


def read(r: dict):
    return spans.counter_ms(spans.train_window(r), "host_wait_ns")
