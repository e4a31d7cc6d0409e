"""Evaluation: confusion matrix, mIoU and the fixed-resolution protocol."""
