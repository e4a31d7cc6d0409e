"""DeepLab-LargeFOV and parameter interchange with the JAX package."""
