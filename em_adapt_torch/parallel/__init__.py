"""Training over several processes (``parallel/mesh.py``)."""
