"""Measurement tools of the port, run as ``python -m em_adapt_torch.tools.<name>``."""
