"""The host's ms a step in the training step's ``step.optim`` span (its
launch, and any wait on the card inside it), over the untraced window's
steps (``em_adapt_torch/utils/tracing.py``'s entries)."""

import spans


def read(r: dict):
    return spans.host_ms(spans.train_window(r), "step.optim")
