"""PyTorch + CUDA port of em_adapt_tpu for NVIDIA Hopper (H100).

The JAX package ``em_adapt_tpu`` is the reference this package is held
against; nothing here imports it or JAX. It trains DeepLab-LargeFOV by
EM-Adapt (the adaptive E-step K1 ``csrc/estep.cu``, block 1's fused
forward and backward K2 ``csrc/block1_fwd.cu`` and K3
``csrc/block1_bwd.cu``), evaluates it by the fixed and the VOC protocol
(with the dense CRF on the host or the card), and serves it: predicted
masks, an exported predict program, and weights in and out of the
reference's formats (``python -m em_adapt_torch --help``).
"""

__version__ = "0.1.0"
