"""PyTorch + CUDA port of em_adapt_tpu for NVIDIA Hopper (H100).

The JAX package ``em_adapt_tpu`` is the reference this package is held
against; nothing here imports it or JAX. This slice runs one EM-Adapt
training step of DeepLab-LargeFOV, with the adaptive E-step as a
hand-written CUDA kernel (``csrc/estep.cu``).
"""
