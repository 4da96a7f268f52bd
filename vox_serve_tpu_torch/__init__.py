"""vox_serve_tpu_torch — the PyTorch/CUDA port of vox_serve_tpu.

Same module layout as ``vox_serve_tpu`` (each module here mirrors the JAX
module of the same path), written for one NVIDIA H100: plain tensor code is
PyTorch, and each Pallas kernel on the served path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/`` (built with ``nvcc`` at first use, see
``ops/kernels.py``). The package never imports ``jax``; from
``vox_serve_tpu`` it reuses only the jax-free host modules ``utils``,
``native``, ``server.api`` and ``server.app``.
"""

__version__ = "0.1.0"
