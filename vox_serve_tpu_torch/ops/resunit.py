"""K2: the codec decoder's stack of three chained residual units as a
hand-written kernel (port of vox_serve_tpu/ops/pallas_resunit.py).

Each unit is ``x + conv1x1(snake(conv_k7,dil(snake(x))))`` with dilations
1, 3, 9 (codecs/qwen3_codec.py ``_residual_unit``). On the card
``fused_resunit_stack`` launches ``csrc/resunit.cu`` once per unit; on the
CPU it runs the plain version, three ``_residual_unit`` calls. The 128-lane
channel pad of the TPU kernel's parameter packing is a TPU artefact and is
not carried over.

Opt-in, as in the JAX package: ``VOX_FUSED_RESUNIT=1`` routes the codec's
blocks whose chunk is longer than the widest halo (54 samples) here.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import kernels

KERNEL_SIZE = 7  # all codec residual units use k=7


def use_fused_resunit() -> bool:
    """Gate: off by default; ``VOX_FUSED_RESUNIT=1`` opts in (the JAX
    package's switch, read the same way)."""
    return os.environ.get("VOX_FUSED_RESUNIT", "0") != "0"


def snake_constants(alpha: torch.Tensor, beta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """snake(x) = x + binv * sin(af * x)^2 with af = exp(alpha) and
    binv = 1 / (exp(beta) + 1e-9), both float32 (C,) rows."""
    af = torch.exp(alpha.float())
    binv = 1.0 / (torch.exp(beta.float()) + 1e-9)
    return af.contiguous(), binv.contiguous()


def fused_resunit_stack_plain(x: torch.Tensor, units: list, caches,
                              dilations=(1, 3, 9)):
    """Plain PyTorch version: the three ``_residual_unit`` calls of the
    codec's unfused path, with the same cache semantics."""
    from ..codecs.qwen3_codec import _residual_unit

    new = []
    for u, (p, dil) in enumerate(zip(units, dilations)):
        x, nc = _residual_unit(p, x, dil, None if caches is None
                               else caches[u])
        new.append(nc)
    return x, new


def _check_stack(x: torch.Tensor, dilations) -> None:
    if len(dilations) != 3:
        raise ValueError("kernel is specialized to 3-unit stacks")
    max_pad = (KERNEL_SIZE - 1) * max(dilations)
    T = x.shape[-1]
    if T <= max_pad:
        raise ValueError(f"chunk T={T} must exceed the widest halo {max_pad}")


def _launch_unit(x: torch.Tensor, p: dict, cache: Optional[torch.Tensor],
                 dil: int, tm: int) -> tuple[torch.Tensor,
                                             Optional[torch.Tensor]]:
    B, C, T = x.shape
    dev = x.device
    pad = (KERNEL_SIZE - 1) * dil
    w1 = p["conv1"]["w"]
    w2 = p["conv2"]["w"]
    if tuple(w1.shape) != (C, C, KERNEL_SIZE) or tuple(w2.shape) != (C, C, 1):
        raise ValueError(f"unit weights {tuple(w1.shape)} / "
                         f"{tuple(w2.shape)} do not match C={C}")
    f32 = torch.float32

    def bias(conv):
        b = conv.get("b")
        return (torch.zeros((C,), dtype=f32, device=dev) if b is None
                else b.to(f32).contiguous())

    w1t = w1.to(f32).permute(2, 1, 0).contiguous()      # (7, C_in, C_out)
    w2t = w2[:, :, 0].to(f32).t().contiguous()          # (C_in, C_out)
    b1, b2 = bias(p["conv1"]), bias(p["conv2"])
    af1, bi1 = snake_constants(p["alpha1"], p["beta1"])
    af2, bi2 = snake_constants(p["alpha2"], p["beta2"])
    if cache is not None:
        kernels._check("cache", cache, f32, 3, dev)
        if tuple(cache.shape) != (B, C, pad):
            raise ValueError(f"cache {tuple(cache.shape)} != {(B, C, pad)}")
    out = torch.empty_like(x)
    new_cache = (None if cache is None else
                 torch.empty((B, C, pad), dtype=f32, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = kernels.library().vox_resunit(
        x.data_ptr(), ptr(cache), w1t.data_ptr(), b1.data_ptr(),
        w2t.data_ptr(), b2.data_ptr(), af1.data_ptr(), bi1.data_ptr(),
        af2.data_ptr(), bi2.data_ptr(), out.data_ptr(), ptr(new_cache), B,
        C, T, dil, tm, torch.cuda.current_stream(dev).cuda_stream)
    kernels._raise_on(err, "fused_resunit_stack")
    return out, new_cache


def fused_resunit_stack(x: torch.Tensor, units: list, caches,
                        dilations=(1, 3, 9)):
    """Run a chained residual-unit stack (``_residual_unit`` x 3).

    x: (B, C, T) NCH activation, float32 on the card.
    units: per-unit param dicts (alpha1/beta1/conv1{w,b}/alpha2/beta2/
        conv2{w,b}; conv weights (C_out, C_in, k)).
    caches: per-unit conv caches (B, C, 6*dil), the last samples of the
        SNAKED pre-conv signal, or None (zero halos, no new caches).
    Returns (out (B, C, T), new_caches: a list of three, None entries when
    ``caches`` is None). Raises when T <= 54 or len(dilations) != 3.

    CPU tensors: the plain version. CUDA tensors: three K2 launches (each
    counted in ``fused_resunit_stack.launches``; whole stacks in
    ``.stacks``), or raise.
    """
    _check_stack(x, dilations)
    if x.device.type == "cpu":
        return fused_resunit_stack_plain(x, units, caches, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be a float32 (B, C, T) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, C, T = x.shape
    if C % 8:
        raise ValueError(f"C={C} must be a multiple of 8")
    if max(dilations) > 9:
        raise ValueError(f"dilations {dilations}: the kernel stages halos "
                         "of at most 54 samples (dilation <= 9)")
    lib = kernels.library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # 16-step time tiles when 32-step tiles would leave SMs idle
    tm = 32 if B * -(-T // 32) >= sms else 16
    limit = 227 * 1024
    need = max(lib.vox_resunit_smem_bytes(C, d, tm) for d in dilations)
    if need > limit:
        raise ValueError(f"C={C} needs {need} B of shared memory > {limit}")
    h = x.contiguous()
    new = []
    for u, (p, dil) in enumerate(zip(units, dilations)):
        cache = None if caches is None else caches[u].contiguous()
        h, nc = _launch_unit(h, p, cache, dil, tm)
        new.append(nc)
        fused_resunit_stack.launches += 1
    fused_resunit_stack.stacks += 1
    return h, new


fused_resunit_stack.launches = 0
fused_resunit_stack.stacks = 0
