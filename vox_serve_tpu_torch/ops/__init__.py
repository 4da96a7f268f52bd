"""Tensor ops of the port: norms, rope, the paged KV pool, attention, and the
hand-written CUDA kernels (``kernels.py``)."""
