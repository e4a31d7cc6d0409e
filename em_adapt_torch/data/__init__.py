"""Host input pipeline (numpy): augmentation and synthetic data."""
