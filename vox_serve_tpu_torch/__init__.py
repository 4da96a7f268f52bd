"""vox_serve_tpu_torch — the PyTorch/CUDA port of vox_serve_tpu.

Same module layout as ``vox_serve_tpu`` (each module here mirrors the JAX
module of the same path), written for one NVIDIA H100: plain tensor code is
PyTorch, and each Pallas kernel on the served path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/`` (built with ``nvcc`` at first use, see
``ops/kernels.py``). The package imports neither ``jax`` nor anything of
``vox_serve_tpu``: the host modules it shares with the JAX package
(``utils``, ``native``, ``server.api``, ``server.app``) are copies.
"""

__version__ = "0.1.0"
