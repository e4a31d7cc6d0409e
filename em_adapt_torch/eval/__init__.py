"""Evaluation: confusion matrix and mIoU, the fixed-resolution and VOC protocols, the dense CRF on the host and on a device."""
