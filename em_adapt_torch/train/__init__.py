"""EM training step, optimizer and training loop."""
