"""K2: the codec decoder's stack of three chained residual units as a
hand-written kernel (port of vox_serve_tpu/ops/pallas_resunit.py).

Each unit is ``x + conv1x1(snake(conv_k7,dil(snake(x))))`` with dilations
1, 3, 9 (codecs/qwen3_codec.py ``_residual_unit``). On the card
``fused_resunit_stack`` runs each unit as three launches of
``csrc/resunit.cu`` (snake1 into y, conv1 + snake2 into z, conv2 + the
residual), tensor-core products in 3xTF32; on the CPU it runs the plain
version, three ``_residual_unit`` calls. The 128-lane channel pad of the TPU
kernel's parameter packing is a TPU artefact and is not carried over.

Each unit's parameters are packed once per parameter set and dtype
(``pack_unit``): the conv weights split into TF32 hi and lo planes, K-major
as the kernel's wgmma reads them (``pack_weights``), the biases and the
snake constants, kept beside the parameters until they are freed or changed
in place. The CTA tile comes from ``plan_tiles``, a cost model of the
kernel.

In bf16 (the codec served at ``codec_dtype="bfloat16"``), the stack follows
the Pallas kernel's rounding points in its serving dtype
(pallas_resunit.py:80-101): snake1 in float32, rounded to bf16 as the conv
input and the new cache; both convs sum bf16 products in float32; z is
rounded to bf16 before the 1x1 conv; the residual sum is rounded to bf16.
The plain version is ``_residual_unit_bf16`` (not the codec's unfused chain
in bf16, which rounds after every op); on the card the kernel's bf16 entry
runs bf16 wgmma products, counted in ``fused_resunit_stack_bf16``.

Opt-in, as in the JAX package: ``VOX_FUSED_RESUNIT=1`` routes the codec's
blocks whose chunk is longer than the widest halo (54 samples) here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from . import kernels

KERNEL_SIZE = 7  # all codec residual units use k=7
#: CTA tiles the kernel is compiled for: time steps and output channels
TILE_M = (128, 64)
TILE_N = (64, 32)
#: plan_tiles' price of a staged byte against a tensor-core output,
#: fitted to the tile timings of the eight serving shapes on an H100
STAGE_COST = 0.2
LAUNCHES_PER_UNIT = 3


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), by integer arithmetic on the bits: the kernel's
    ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = tf32(x), lo = tf32(x - hi): hi + lo is x within 2^-22 relative,
    and hi*hi + hi*lo + lo*hi is a product within ~2^-21."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """Conv weights (C_out, C_in, k) -> the kernel's K-major B operand, (2,
    k, C_in/4, C_out, 4): the TF32 hi and lo planes, in each tap the 4
    input channels 4c .. 4c+3 of an output channel contiguous (16 bytes)."""
    C_out, C_in, k = w.shape
    hi, lo = split_tf32(w.float().permute(2, 1, 0))  # (k, C_in, C_out)
    halves = torch.stack((hi, lo)).reshape(2, k, C_in // 4, 4, C_out)
    return halves.transpose(3, 4).contiguous()


@dataclasses.dataclass(frozen=True)
class PackedUnit:
    """One unit's parameters as the kernel reads them: ``w1`` (2, 7, C/4, C,
    4) and ``w2`` (2, 1, C/4, C, 4) from ``pack_weights``; the rest (C,)
    float32."""
    w1: torch.Tensor
    w2: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    af1: torch.Tensor
    bi1: torch.Tensor
    af2: torch.Tensor
    bi2: torch.Tensor


def pack_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """Conv weights (C_out, C_in, k) -> the bf16 kernel's K-major B operand,
    (k, C_in/8, C_out, 8): in each tap the 8 input channels 8c .. 8c+7 of
    an output channel contiguous (16 bytes), rounded to bf16 as the Pallas
    kernel's ``_pack_params`` rounds them."""
    C_out, C_in, k = w.shape
    wt = w.to(torch.bfloat16).permute(2, 1, 0)  # (k, C_in, C_out)
    return wt.reshape(k, C_in // 8, 8, C_out).transpose(2, 3).contiguous()


#: conv1 weight -> {dtype: (stamp, PackedUnit)}
_packed = WeakIdKeyDictionary()


def pack_unit(p: dict, dtype: torch.dtype = torch.float32) -> PackedUnit:
    """The unit's packing for the kernel of ``dtype`` (float32: TF32 hi/lo
    planes; bfloat16: bf16 weights), computed at the first call for this
    parameter set and dtype and kept (weakly, keyed by its conv1 weight)
    for every later call; recomputed only when one of its tensors is
    replaced or changed in place. Each computation counts in
    ``pack_unit.count``."""
    w1 = p["conv1"]["w"]
    sources = (w1, p["conv1"].get("b"), p["conv2"]["w"],
               p["conv2"].get("b"), p["alpha1"], p["beta1"], p["alpha2"],
               p["beta2"])
    stamp = tuple(None if t is None else (id(t), t._version)
                  for t in sources)
    by_dtype = _packed.setdefault(w1, {})
    hit = by_dtype.get(dtype)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    C = w1.shape[0]
    w2 = p["conv2"]["w"]
    if (tuple(w1.shape) != (C, C, KERNEL_SIZE)
            or tuple(w2.shape) != (C, C, 1) or C % 8):
        raise ValueError(f"unit weights {tuple(w1.shape)} / "
                         f"{tuple(w2.shape)} are not (C, C, 7) / (C, C, 1) "
                         "with C a multiple of 8")

    def bias(conv):
        b = conv.get("b")
        return (torch.zeros((C,), dtype=torch.float32, device=w1.device)
                if b is None else b.float().contiguous())

    pack = pack_weights_bf16 if dtype == torch.bfloat16 else pack_weights
    packed = PackedUnit(pack(w1), pack(w2), bias(p["conv1"]),
                        bias(p["conv2"]),
                        *snake_constants(p["alpha1"], p["beta1"]),
                        *snake_constants(p["alpha2"], p["beta2"]))
    by_dtype[dtype] = (stamp, packed)
    pack_unit.count += 1
    return packed


pack_unit.count = 0


def plan_tiles(B: int, C: int, T: int, sms: int) -> tuple[int, int]:
    """The CTA tile (time steps, output channels) of both GEMM passes, the
    cheapest by a model of the kernel on the card. The grid, B *
    ceil(T/bm) * ceil(C/bn) CTAs of bm/64 warpgroups, is dealt evenly over
    the SMs; each warpgroup owns 64 x bn outputs, and an output costs its
    tensor-core time plus ``STAGE_COST`` per byte staged for it in a K
    stage. Tensor time: a m64nNk8 wgmma does N/2 clocks of math and reads
    2048 + 32N bytes of shared memory at 128 B a clock, so N=64 runs at
    full rate and N=32 at two thirds. Staged bytes: the stage's weights,
    hi and lo of 7 taps x 8 channels x bn, and its activation rows, hi and
    lo of 8 channels x (bm + 54), over the tile's bm * bn outputs. Only
    widths that divide C are considered when one does; ties go to the
    taller, then the wider tile."""
    def cost(tile):
        bm, bn = tile
        ctas = B * -(-T // bm) * -(-C // bn)
        warpgroups = -(-ctas // sms) * (bm // 64)
        tensor = max(1.0, (2048 + 32 * bn) / (64 * bn))
        staged = (448 * bn + 64 * (bm + 54)) / (bm * bn)
        return warpgroups * 64 * bn * (tensor + STAGE_COST * staged), -bm, -bn

    widths = [bn for bn in TILE_N if C % bn == 0] or list(TILE_N)
    return min(((bm, bn) for bm in TILE_M for bn in widths), key=cost)


def _snake(x: torch.Tensor, af: torch.Tensor, binv: torch.Tensor):
    """snake over (B, C, T) float32 with (C,) constants, in the Pallas
    kernel's order: x + binv * sin(x * af)^2."""
    return x + binv[:, None] * torch.square(torch.sin(x * af[:, None]))


def _residual_unit_bf16(p: dict, x: torch.Tensor, dil: int,
                        cache: Optional[torch.Tensor]):
    """One unit at the Pallas kernel's bf16 rounding points: x and the
    cache bf16, snake and both sums in float32 (the bf16 products are exact
    in float32), y and z rounded to bf16, the output rounded to bf16."""
    pad = (KERNEL_SIZE - 1) * dil
    B, C, T = x.shape
    bf = torch.bfloat16

    def bias(conv):
        b = conv.get("b")
        return (torch.zeros((C, 1), dtype=torch.float32, device=x.device)
                if b is None else b.float()[:, None])

    hf = x.float()
    yb = _snake(hf, *snake_constants(p["alpha1"], p["beta1"])).to(bf)
    halo = (torch.zeros((B, C, pad), dtype=bf, device=x.device)
            if cache is None else cache.to(bf))
    ypad = torch.cat([halo, yb], dim=-1).float()
    acc = F.conv1d(ypad, p["conv1"]["w"].to(bf).float(),
                   dilation=dil) + bias(p["conv1"])
    zb = _snake(acc, *snake_constants(p["alpha2"], p["beta2"])).to(bf)
    o = F.conv1d(zb.float(), p["conv2"]["w"].to(bf).float()) + bias(
        p["conv2"])
    return (hf + o).to(bf), (None if cache is None else yb[..., T - pad:])


def fused_resunit_stack_plain(x: torch.Tensor, units: list, caches,
                              dilations=(1, 3, 9)):
    """Plain PyTorch version. float32: the three ``_residual_unit`` calls of
    the codec's unfused path, with the same cache semantics; bfloat16: the
    Pallas kernel's rounding points (``_residual_unit_bf16``)."""
    from ..codecs.qwen3_codec import _residual_unit

    unit = (_residual_unit_bf16 if x.dtype == torch.bfloat16
            else _residual_unit)
    new = []
    for u, (p, dil) in enumerate(zip(units, dilations)):
        x, nc = unit(p, x, dil, None if caches is None else caches[u])
        new.append(nc)
    return x, new


def _check_stack(x: torch.Tensor, dilations) -> None:
    if len(dilations) != 3:
        raise ValueError("kernel is specialized to 3-unit stacks")
    max_pad = (KERNEL_SIZE - 1) * max(dilations)
    T = x.shape[-1]
    if T <= max_pad:
        raise ValueError(f"chunk T={T} must exceed the widest halo {max_pad}")


def _launch_unit(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                 pk: PackedUnit, cache: Optional[torch.Tensor], dil: int,
                 tiles: tuple[int, int]) -> tuple[torch.Tensor,
                                                  Optional[torch.Tensor]]:
    """One unit: the snaked input with its halo into y, conv1 into z (both
    scratch sized by ``_scratch``), conv2 the output; the kernel entry of
    x's dtype."""
    B, C, T = x.shape
    dev = x.device
    pad = (KERNEL_SIZE - 1) * dil
    if pk.w1.shape[-2] != C:
        raise ValueError(f"unit weights {tuple(pk.w1.shape)} do not match "
                         f"C={C}")
    if cache is not None:
        kernels._check("cache", cache, x.dtype, 3, dev)
        if tuple(cache.shape) != (B, C, pad):
            raise ValueError(f"cache {tuple(cache.shape)} != {(B, C, pad)}")
    out = torch.empty_like(x)
    new_cache = (None if cache is None else
                 torch.empty((B, C, pad), dtype=x.dtype, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = kernels.library()
    entry = (lib.vox_resunit_bf16 if x.dtype == torch.bfloat16
             else lib.vox_resunit)
    err = entry(
        x.data_ptr(), ptr(cache), pk.w1.data_ptr(), pk.b1.data_ptr(),
        pk.w2.data_ptr(), pk.b2.data_ptr(), pk.af1.data_ptr(),
        pk.bi1.data_ptr(), pk.af2.data_ptr(), pk.bi2.data_ptr(),
        y.data_ptr(), z.data_ptr(), out.data_ptr(), ptr(new_cache), B, C, T,
        dil,
        *tiles, torch.cuda.current_stream(dev).cuda_stream)
    kernels._raise_on(err, "fused_resunit_stack")
    return out, new_cache


def _scratch(B: int, C: int, T: int, max_dil: int, device,
             dtype: torch.dtype = torch.float32
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch of channel-minor rows: y the snaked input with
    its halo (B, 6*dil + T, C), z the output of conv1 (B, T, C); in float32
    tf32 hi and lo planes (a leading axis of 2), in bf16 one plane."""
    lead = () if dtype == torch.bfloat16 else (2,)

    def planes(rows):
        return torch.empty((*lead, B, rows, C), dtype=dtype, device=device)

    return planes((KERNEL_SIZE - 1) * max_dil + T), planes(T)


def fused_resunit_stack(x: torch.Tensor, units: list, caches,
                        dilations=(1, 3, 9)):
    """Run a chained residual-unit stack (``_residual_unit`` x 3).

    x: (B, C, T) NCH activation, float32 or bfloat16 (then the bf16 stack,
        ``fused_resunit_stack_bf16``).
    units: per-unit param dicts (alpha1/beta1/conv1{w,b}/alpha2/beta2/
        conv2{w,b}; conv weights (C_out, C_in, k)).
    caches: per-unit conv caches (B, C, 6*dil) in x's dtype, the last
        samples of the SNAKED pre-conv signal, or None (zero halos, no new
        caches).
    Returns (out (B, C, T), new_caches: a list of three, None entries when
    ``caches`` is None). Raises when T <= 54 or len(dilations) != 3.

    CPU tensors: the plain version. CUDA tensors: three K2 launches per
    unit (each counted in ``fused_resunit_stack.launches``; whole stacks in
    ``.stacks``), or raise.
    """
    if x.dtype == torch.bfloat16:
        return fused_resunit_stack_bf16(x, units, caches, dilations)
    return _run_stack(fused_resunit_stack, torch.float32, x, units, caches,
                      dilations)


def fused_resunit_stack_bf16(x: torch.Tensor, units: list, caches,
                             dilations=(1, 3, 9)):
    """The bf16 stack: ``fused_resunit_stack`` for a bfloat16 x and caches,
    at the Pallas kernel's bf16 rounding points. CUDA tensors: three
    launches of the kernel's bf16 entry per unit, counted here
    (``.launches``, ``.stacks``) and not in ``fused_resunit_stack``."""
    return _run_stack(fused_resunit_stack_bf16, torch.bfloat16, x, units,
                      caches, dilations)


def _run_stack(counter, dtype: torch.dtype, x: torch.Tensor, units: list,
               caches, dilations):
    _check_stack(x, dilations)
    if x.device.type == "cpu":
        return fused_resunit_stack_plain(x, units, caches, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    if x.dtype != dtype or x.dim() != 3:
        raise ValueError(f"x must be a {dtype} (B, C, T) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, C, T = x.shape
    if C % 8:
        raise ValueError(f"C={C} must be a multiple of 8")
    if max(dilations) > 9:
        raise ValueError(f"dilations {dilations}: the kernel stages halos "
                         "of at most 54 samples (dilation <= 9)")
    packed = [pack_unit(p, dtype) for p in units]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles = plan_tiles(B, C, T, sms)
    h = x.contiguous()
    y, z = _scratch(B, C, T, max(dilations), x.device, dtype)
    new = []
    for u, (pk, dil) in enumerate(zip(packed, dilations)):
        cache = None if caches is None else caches[u].contiguous()
        h, nc = _launch_unit(h, y, z, pk, cache, dil, tiles)
        new.append(nc)
        counter.launches += LAUNCHES_PER_UNIT
    counter.stacks += 1
    return h, new


fused_resunit_stack.launches = 0
fused_resunit_stack.stacks = 0
fused_resunit_stack_bf16.launches = 0
fused_resunit_stack_bf16.stacks = 0
