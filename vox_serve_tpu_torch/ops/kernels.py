"""The port's hand-written Hopper kernels, their wrappers and their plain
PyTorch versions.

Ten kernels (K2 in two types, K6 in four), all CUDA C++ for ``sm_90a`` under
``csrc/``:

* K1 ``paged_decode_attention`` (``csrc/paged_decode.cu``) replaces the
  Pallas ``ragged_paged_attention`` that vox_serve_tpu/ops/attention.py
  ``paged_attention_decode`` runs over the combined bf16 pool;
* K1q ``paged_decode_attention_quant`` (same source, the pool's element
  type a template parameter) is that kernel over an int8 or float8 e4m3
  pool with static dequant scales;
* K4 ``paged_decode_attention_pair`` (same source, head-major addressing)
  replaces vox_serve_tpu/ops/pallas_attention.py ``_pallas_decode_call``
  over the legacy (k, v) pair;
* K3 ``ragged_prefill_attention`` (``csrc/ragged_prefill.cu``) replaces
  vox_serve_tpu/ops/pallas_prefill.py ``_pallas_prefill_call``;
* K2 ``fused_resunit_stack`` (``csrc/resunit.cu``; wrapper in
  ``ops/resunit.py``) replaces vox_serve_tpu/ops/pallas_resunit.py
  ``fused_resunit_stack`` over float32 activations (3xTF32), and its bf16
  entry, counted as ``fused_resunit_stack_bf16``, the same Pallas kernel
  in the bf16 serving dtype;
* K5 ``w8a16_linear`` (``csrc/w8a16_linear.cu``) is the int8 weight-only
  linear of the backbone under ``weight_quant="int8"``, over weights
  packed once into its tile layout (``pack_w8a16``), up to three linears
  that share x in one launch (``w8a16_linear_group``). It replaces no
  Pallas kernel: vox_serve_tpu/models/backbone.py ``linear`` leaves its
  ``w_q`` branch to an XLA fusion on the TPU;
* K6 (``csrc/depth_layer.cu``) is the depth transformer's layer around its
  four projections (models/depth.py ``depth_forward``): ``depth_add_rms_norm``
  (K6a, the residual add with the RMS norm after it), ``depth_qkv_rope``
  (K6b, q/k norm, rotary, the cache write), ``depth_attention`` (K6c) and
  ``depth_silu_mul`` (K6d). It replaces no Pallas kernel either: the JAX
  package leaves that chain to XLA's fusions. Its wrappers run on CUDA
  tensors only and raise on any input they refuse, on every device; the
  depth forward runs the plain versions on the CPU.

Build: ``nvcc`` compiles every source into one shared library with a plain
C interface, loaded with ``ctypes``, at the first launch (or an explicit
``build()``). The sources compile in parallel, one ``nvcc -c`` each, and
link once. The library lands in ``vox_serve_tpu_torch/_build/`` under a
name keyed by the sources' hash, so an edited source never loads a stale
build. Nothing is compiled or imported from CUDA when this module is
imported: the CPU tests import every module.

Dispatch is by device: a CPU tensor goes to the plain version (that is the
only reason the plain path runs), a CUDA tensor launches the kernel or the
call raises. There is no fallback from the kernel to the plain version.
Each wrapper counts its kernel launches in ``<wrapper>.launches`` (K2
also its whole stacks in ``.stacks``); a captured CUDA graph adds the
counts its capture made on each replay (``worker/graphs.py``), and its
capture counts none. The
launch geometry is planned on the host from shapes alone
(``plan_decode_splits``, ``plan_prefill_tiles``, ``plan_w8a16``), so no
launch waits on the device. A split decode launch keeps its partial
states in the caller's ``DecodeScratch`` (the worker sizes one at
start-up), or in one of its own; a split K5 launch its partial sums in a
``W8A16Scratch`` in the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import cdiv
from .norms import rms_norm
from .rope import rope_frequencies

NEG_INF = float(torch.finfo(torch.float32).min)

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("paged_decode.cu", "ragged_prefill.cu", "resunit.cu",
            "w8a16_linear.cu", "depth_layer.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()
#: compiler output of the build that produced the loaded library
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvox_kernels_{h.hexdigest()[:16]}.so"


def _compile(cmds: list[list[str]]) -> str:
    """Run the nvcc commands concurrently; returns their joined output,
    raises if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)} -> {p.returncode}")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{log}")
    return log


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source revision is not built yet) and
    load the library. Returns its path. Raises on any compiler error."""
    global _lib, build_log
    with _lib_lock:
        path = _library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique temp names + atomic rename: a server daemon and a test
            # process may build the same revision at the same time
            tmpdir = tempfile.mkdtemp(dir=str(BUILD_DIR))
            try:
                nvcc = _nvcc()
                ptxas = ("-Xptxas", "-v") if verbose else ()
                objs = [os.path.join(tmpdir, s + ".o") for s in _SOURCES]
                build_log = _compile([
                    [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", o,
                     str(_CSRC / s)] for s, o in zip(_SOURCES, objs)])
                tmp = os.path.join(tmpdir, "lib.so")
                build_log += _compile([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                                        tmp, *objs]])
                os.replace(tmp, path)
            finally:
                shutil.rmtree(tmpdir, ignore_errors=True)
        if _lib is None:
            lib = ctypes.CDLL(str(path))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.vox_paged_decode_attention.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                cf, ci, cf, cf, ci, vp]
            lib.vox_paged_decode_attention.restype = ci
            lib.vox_paged_decode_attention_pair.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                ci, cf, ci, vp]
            lib.vox_paged_decode_attention_pair.restype = ci
            lib.vox_ragged_prefill_attention.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, vp]
            lib.vox_ragged_prefill_attention.restype = ci
            for entry in (lib.vox_resunit, lib.vox_resunit_bf16):
                entry.argtypes = [vp] * 14 + [ci] * 6 + [vp]
                entry.restype = ci
            lib.vox_w8a16_linear.argtypes = ([vp] * 13 + [ci] * 4 + [vp] * 2
                                            + [ci] * 5 + [vp])
            lib.vox_w8a16_linear.restype = ci
            lib.vox_w8a16_occupancy.argtypes = [ci]
            lib.vox_w8a16_occupancy.restype = ci
            lib.vox_depth_add_rms_norm.argtypes = [vp] * 5 + [ci, ci, cf, vp]
            lib.vox_depth_qkv_rope.argtypes = ([vp] * 6 + [ci] * 7
                                               + [cf, cf, vp])
            lib.vox_depth_attention.argtypes = ([vp] * 4 + [ci] * 7
                                                + [cf, vp])
            lib.vox_depth_silu_mul.argtypes = [vp, vp, ci, ci, ci, vp]
            for entry in (lib.vox_depth_add_rms_norm, lib.vox_depth_qkv_rope,
                          lib.vox_depth_attention, lib.vox_depth_silu_mul):
                entry.restype = ci
            _lib = lib
        return path


def library():
    """The loaded kernel library (built at the first call)."""
    if _lib is None:
        build()
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_heads(H: int, KH: int, D: int, max_group: int) -> None:
    """The head layout a kernel takes: any GQA group G = H / KH up to
    ``max_group`` (K3: a 2-warp query tile holds one token of at most 32
    heads; the decode kernel: its head groups cover any G, masked where 4
    does not divide it), head dim a multiple of 8 up to 128."""
    if KH <= 0 or H % KH:
        raise ValueError(f"{H} query heads not a multiple of {KH} KV heads")
    G = H // KH
    if not 1 <= G <= max_group:
        raise ValueError(f"GQA group {G} unsupported (1 to {max_group})")
    if D > 128 or D % 8:
        raise ValueError(f"head dim {D} unsupported (multiple of 8, <= 128)")


def check_attention_heads(H: int, KH: int, D: int,
                          pool_dtype: torch.dtype) -> None:
    """Raise unless K1/K1q/K4 and K3 take H query heads over KH KV heads
    at head dim D over a pool of ``pool_dtype`` (a tensor-parallel rank's
    local heads are checked at start-up, before anything launches)."""
    _check_heads(H, KH, D, MAX_GROUP)
    if torch.empty((), dtype=pool_dtype).element_size() == 1 and D % 16:
        raise ValueError(f"head dim {D} unsupported for a 1-byte pool "
                         "(multiple of 16)")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


# ---------------------------------------------------------------------------
# K1, K1q and K4: paged decode attention
# ---------------------------------------------------------------------------

#: pool element type -> the kernel's pool_type code (K1 bf16, K1q the rest)
_POOL_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}

#: the decode kernel's unit of work (tokens) and warps per CTA
DECODE_TILE = 16
DECODE_WARPS = 4
#: query heads one decode CTA holds (a larger G takes several head groups)
DECODE_MAX_HEADS = 4
#: the largest GQA group the kernels take (K3's 2-warp tile: 32 rows)
MAX_GROUP = 32


def decode_heads_per_cta(H: int, KH: int) -> int:
    """Query heads one decode CTA holds: G where G <= 4, else 4 (the last
    head group of a G that 4 does not divide masks its missing heads)."""
    return min(H // KH, DECODE_MAX_HEADS)


def decode_head_groups(H: int, KH: int) -> int:
    """CTAs per KV head in the decode grid: ceil(G / min(G, 4))."""
    return cdiv(H // KH, decode_heads_per_cta(H, KH))


def plan_decode_splits(B: int, KH: int, max_pages: int, n_sm: int = 132,
                       page: int = 16, head_groups: int = 1) -> int:
    """How many CTAs split each sequence's tokens in the decode kernel.

    The grid is (B, KH * head_groups, splits). One split where that grid
    already fills the SMs; otherwise enough splits to fill them, but no
    more than gives each split one 16-token tile per warp of the table's
    width (``max_pages`` pages), since a CTA's four warps take its tiles
    in parallel. Pure host arithmetic: the sequence lengths stay on the
    device."""
    ctas = B * KH * head_groups
    if ctas >= n_sm:
        return 1
    tiles = cdiv(max_pages * page, DECODE_TILE)
    return max(1, min(cdiv(n_sm, ctas), cdiv(tiles, DECODE_WARPS)))


def decode_split_ranges(n_tok: int, splits: int) -> list[tuple[int, int]]:
    """The token range [start, end) each split of one sequence covers, as
    the kernel cuts it: whole 16-token tiles, contiguous, in order."""
    n_tiles = cdiv(n_tok, DECODE_TILE)
    per = cdiv(n_tiles, splits)
    out = []
    for s in range(splits):
        j0, j1 = s * per, min(n_tiles, (s + 1) * per)
        out.append((min(j0 * DECODE_TILE, n_tok),
                    min(max(j0, j1) * DECODE_TILE, n_tok)))
    return out


def _split_need(B: int, H: int, KH: int, D: int, max_pages: int, n_sm: int,
                 page: int) -> tuple[int, int, int]:
    """(splits, partial-state floats, counters) of one decode launch: the
    (max, sum, acc) state of each query head of each CTA, and one arrival
    counter per (sequence, head group). No scratch at one split."""
    groups = decode_head_groups(H, KH)
    splits = plan_decode_splits(B, KH, max_pages, n_sm, page, groups)
    if splits == 1:
        return 1, 0, 0
    ctas = B * KH * groups
    return (splits, ctas * splits * decode_heads_per_cta(H, KH) * (D + 2),
            ctas)


def decode_scratch_size(max_batch: int, H: int, KH: int, D: int,
                        max_pages: int, n_sm: int = 132, page: int = 16
                        ) -> tuple[int, int]:
    """(floats, counters) that cover every decode launch of at most
    ``max_batch`` rows over a block table at most ``max_pages`` wide (the
    split count grows with the table's width, so the widest is the
    largest)."""
    floats = counters = 0
    for B in range(1, max_batch + 1):
        _, f, c = _split_need(B, H, KH, D, max_pages, n_sm, page)
        floats, counters = max(floats, f), max(counters, c)
    return floats, counters


class DecodeScratch:
    """The workspace of split decode launches: partial softmax states and
    arrival counters, which the kernel leaves at zero. Sized once, for the
    largest launch its owner makes (a worker: its max batch and its block
    table limit), and never replaced, so a CUDA graph that captured a
    launch keeps valid pointers while the scratch lives. The launches that
    share one must run in order on one stream, as a worker's do."""

    def __init__(self, device: torch.device, max_batch: int, H: int, KH: int,
                 D: int, max_pages: int, page: int = 16):
        device = torch.device(device)
        n_sm = _sm_count(device) if device.type == "cuda" else 132
        floats, counters = decode_scratch_size(max_batch, H, KH, D,
                                               max_pages, n_sm, page)
        self.part = torch.empty(max(floats, 1), dtype=torch.float32,
                                device=device)
        self.counters = torch.zeros(max(counters, 1), dtype=torch.int32,
                                    device=device)


def _decode_split(q: torch.Tensor, KH: int, page: int, max_pages: int,
                  scratch: Optional[DecodeScratch]
                  ) -> tuple[int, Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """(splits, partial states, counters) of one decode launch. Without a
    ``scratch`` a split launch gets its own, zeroed on its stream (one
    allocation and one fill per call, inside a captured graph too); a
    ``scratch`` too small for the launch raises."""
    B, H, D = q.shape
    splits, floats, counters = _split_need(B, H, KH, D, max_pages,
                                           _sm_count(q.device), page)
    if splits == 1:
        return 1, None, None
    if scratch is None:
        return (splits, torch.empty(floats, dtype=torch.float32,
                                    device=q.device),
                torch.zeros(counters, dtype=torch.int32, device=q.device))
    part, cnt = scratch.part, scratch.counters
    if part.device != q.device:
        raise ValueError(f"decode scratch is on {part.device}, q on "
                         f"{q.device}")
    if part.numel() < floats or cnt.numel() < counters:
        raise ValueError(f"decode scratch ({part.numel()} floats, "
                         f"{cnt.numel()} counters) too small for B={B} over "
                         f"{max_pages} pages ({floats}, {counters})")
    return splits, part, cnt


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _decode_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_lens: torch.Tensor, scale: Optional[float]
                    ) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, S, KH, D) float32, token s of row b valid
    iff s < seq_lens[b]. f32 softmax; a row with seq_len == 0 is defined as
    zeros (the JAX gathers would average V over the whole table there)."""
    B, H, D = q.shape
    KH = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = k.repeat_interleave(H // KH, dim=2)
    v = v.repeat_interleave(H // KH, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float() * scale, k)
    tok = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = tok < seq_lens[:, None].to(tok.dtype)
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v)
    out = torch.where((seq_lens > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, pool: torch.Tensor,
                                 layer: int, block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 scale: Optional[float] = None,
                                 kv_scales: Optional[tuple[float, float]]
                                 = None) -> torch.Tensor:
    """Plain PyTorch version of K1 and K1q (the port of vox_serve_tpu's
    ``_combined_decode_gather``). q: (B, H, D); pool: (L, P, page, 2KH, D);
    block_tables: (B, maxP) int; seq_lens: (B,) int. A quantized pool is
    dequantized with the static (k_scale, v_scale)."""
    B, H, D = q.shape
    KH = pool.shape[3] // 2
    page = pool.shape[2]
    # float8 gathers through a uint8 view (bit-identical)
    raw = pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn \
        else pool
    pages = raw[layer][block_tables.long()].view(pool.dtype)
    kv = pages.reshape(B, pages.shape[1] * page, 2 * KH, D)
    k = kv[:, :, 0::2].float()
    v = kv[:, :, 1::2].float()
    if kv_scales is not None:
        k = k * kv_scales[0]
        v = v * kv_scales[1]
    return _decode_softmax(q, k, v, seq_lens, scale)


def _check_decode(q, block_tables, seq_lens, H, KH, D, layer, L) -> None:
    dev = q.device
    _check("q", q, torch.bfloat16, 3, dev)
    _check("block_tables", block_tables, torch.int32, 2, dev)
    _check("seq_lens", seq_lens, torch.int32, 1, dev)
    _check_heads(H, KH, D, MAX_GROUP)
    B = q.shape[0]
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens batch mismatch")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def _launch_combined(q, pool, layer, block_tables, seq_lens, scale,
                     kv_scales, scratch) -> torch.Tensor:
    if pool.dtype not in _POOL_TYPES:
        raise ValueError(f"pool dtype {pool.dtype} unsupported (bf16, int8 "
                         "or float8_e4m3fn)")
    _check("pool", pool, pool.dtype, 5, q.device)
    B, H, D = q.shape
    L, P, page, KH2, Dp = pool.shape
    KH = KH2 // 2
    if Dp != D or KH2 % 2:
        raise ValueError(f"pool {tuple(pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _check_decode(q, block_tables, seq_lens, H, KH, D, layer, L)
    if pool.element_size() == 1 and D % 16:
        raise ValueError(f"head dim {D} unsupported for a 1-byte pool "
                         "(multiple of 16)")
    ks, vs = kv_scales if kv_scales is not None else (1.0, 1.0)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    maxp = block_tables.shape[1]
    splits, part, cnt = _decode_split(q, KH, page, maxp, scratch)
    err = library().vox_paged_decode_attention(
        q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), _ptr(part), _ptr(cnt), B, H, KH,
        D, P, page,
        maxp, int(layer), float(scale), _POOL_TYPES[pool.dtype], float(ks),
        float(vs), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    return out


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor, layer: int,
                           block_tables: torch.Tensor, seq_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           kv_scales: Optional[tuple[float, float]] = None,
                           scratch: Optional[DecodeScratch] = None
                           ) -> torch.Tensor:
    """K1 wrapper over the combined pool. CPU tensors: the plain version.
    CUDA tensors: the kernel (bf16 q, int32 tables and lengths), or raise.
    A quantized pool (int8, float8_e4m3fn) goes to K1q, which needs
    ``kv_scales``; a bf16 pool takes none. ``scratch``: the caller's
    ``DecodeScratch`` for split launches (else one per call)."""
    if pool.dtype in (torch.int8, torch.float8_e4m3fn):
        if kv_scales is None:
            raise ValueError(f"a {pool.dtype} pool needs kv_scales")
        return paged_decode_attention_quant(q, pool, layer, block_tables,
                                            seq_lens, kv_scales, scale,
                                            scratch)
    if kv_scales is not None:
        raise ValueError(f"kv_scales given for a {pool.dtype} pool")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool, layer, block_tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {q.device}")
    out = _launch_combined(q, pool, layer, block_tables, seq_lens, scale,
                           None, scratch)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q: torch.Tensor, pool: torch.Tensor,
                                 layer: int, block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 kv_scales: tuple[float, float],
                                 scale: Optional[float] = None,
                                 scratch: Optional[DecodeScratch] = None
                                 ) -> torch.Tensor:
    """K1q wrapper: K1 over an int8 or float8_e4m3fn combined pool,
    dequantized in the kernel by the static (k_scale, v_scale). CPU
    tensors: the plain version; CUDA tensors: the kernel, or raise."""
    if pool.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"K1q takes int8 or float8_e4m3fn pools, not "
                         f"{pool.dtype}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool, layer, block_tables,
                                            seq_lens, scale, kv_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no K1q kernel for device {q.device}")
    out = _launch_combined(q, pool, layer, block_tables, seq_lens, scale,
                           kv_scales, scratch)
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention_quant.launches = 0


def paged_decode_attention_pair_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor, layer: int,
                                      block_tables: torch.Tensor,
                                      seq_lens: torch.Tensor,
                                      scale: Optional[float] = None
                                      ) -> torch.Tensor:
    """Plain PyTorch version of K4 (the port of the legacy gather of
    vox_serve_tpu's ``paged_attention_decode``). k_pages, v_pages:
    (L, KH, P, page, D) head-major."""
    B, H, D = q.shape
    KH, page = k_pages.shape[1], k_pages.shape[3]
    tables = block_tables.long()

    def gather(pages):  # (KH, B, maxP, page, D) -> (B, S, KH, D)
        g = pages[layer][:, tables]
        return g.reshape(KH, B, -1, D).permute(1, 2, 0, 3).float()

    return _decode_softmax(q, gather(k_pages), gather(v_pages), seq_lens,
                           scale)


def paged_decode_attention_pair(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, layer: int,
                                block_tables: torch.Tensor,
                                seq_lens: torch.Tensor,
                                scale: Optional[float] = None,
                                scratch: Optional[DecodeScratch] = None
                                ) -> torch.Tensor:
    """K4 wrapper over the head-major pair. CPU tensors: the plain version.
    CUDA tensors: the kernel (bf16 q and pools, int32 tables and lengths),
    or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_pair_plain(
            q, k_pages, v_pages, layer, block_tables, seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {q.device}")
    dev = q.device
    _check("k_pages", k_pages, torch.bfloat16, 5, dev)
    _check("v_pages", v_pages, torch.bfloat16, 5, dev)
    B, H, D = q.shape
    L, KH, P, page, Dp = k_pages.shape
    if Dp != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _check_decode(q, block_tables, seq_lens, H, KH, D, layer, L)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    maxp = block_tables.shape[1]
    splits, part, cnt = _decode_split(q, KH, page, maxp, scratch)
    err = library().vox_paged_decode_attention_pair(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        _ptr(part), _ptr(cnt), B, H, KH, D, P, page, maxp, int(layer),
        float(scale), splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_decode_attention_pair")
    paged_decode_attention_pair.launches += 1
    return out


paged_decode_attention_pair.launches = 0


# ---------------------------------------------------------------------------
# K3: ragged causal prefill attention
# ---------------------------------------------------------------------------


def plan_prefill_tiles(T: int, H: int, KH: int, n_sm: int = 132
                       ) -> tuple[int, int, int]:
    """K3's query tile: (warps, tokens per tile, tiles). A tile holds
    16 * warps rows, the G = H / KH heads of a KV group over
    floor(16 * warps / G) tokens (the fewer than G rows left over idle);
    the grid is (tiles, KH). Four warps where that grid fills the SMs, else
    two (more, smaller CTAs for short prompts)."""
    G = H // KH
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"GQA group {G} unsupported (1 to {MAX_GROUP})")
    for warps in (4, 2):
        bq = 16 * warps // G
        tiles = cdiv(T, bq)
        if tiles * KH >= n_sm:
            break
    return warps, bq, tiles


def ragged_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, segment_ids: torch.Tensor,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of K3 (the port of vox_serve_tpu's dense
    ``ragged_prefill_attention``). q: (T, H, D); k, v: (T, KH, D);
    segment_ids: (T,) int, -1 = padding. Token i attends j iff
    seg[i] == seg[j] >= 0 and j <= i in buffer order (equal to the JAX
    oracle's position order for contiguous segments). Padding rows are
    don't-care."""
    T, H, D = q.shape
    KH = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(H // KH, dim=1)
    vf = v.float().repeat_interleave(H // KH, dim=1)
    scores = torch.einsum("thd,shd->hts", q.float() * scale, kf)
    seg = segment_ids
    idx = torch.arange(T, device=q.device)
    mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
            & (idx[:, None] >= idx[None, :]))
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hts,shd->thd", probs, vf).to(q.dtype)


def ragged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, segment_ids: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """K3 wrapper. CPU tensors: the plain version. CUDA tensors: the kernel
    (bf16 q/k/v, int32 segment ids; each segment a contiguous span of the
    buffer, as the worker packs prompts), or raise."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_plain(q, k, v, segment_ids, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {q.device}")
    dev = q.device
    _check("q", q, torch.bfloat16, 3, dev)
    _check("k", k, torch.bfloat16, 3, dev)
    _check("v", v, torch.bfloat16, 3, dev)
    _check("segment_ids", segment_ids, torch.int32, 1, dev)
    T, H, D = q.shape
    KH = k.shape[1]
    if k.shape != (T, KH, D) or v.shape != k.shape \
            or segment_ids.shape[0] != T:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, seg "
                         f"{tuple(segment_ids.shape)}")
    _check_heads(H, KH, D, MAX_GROUP)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    warps = plan_prefill_tiles(T, H, KH, _sm_count(dev))[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().vox_ragged_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), T, H, KH, D, float(scale), warps, stream)
    _raise_on(err, "ragged_prefill_attention")
    ragged_prefill_attention.launches += 1
    return out


ragged_prefill_attention.launches = 0


# ---------------------------------------------------------------------------
# K5: int8 weight-only linear
# ---------------------------------------------------------------------------

#: K per stage of K5 (one 128-byte row of bf16 x) and features per packed
#: unit (one consumer warpgroup's wgmma rows)
W8A16_K_TILE = 64
W8A16_UNIT_FEATURES = 64
#: bytes of one packed unit (64 features x 64 K of int8)
W8A16_UNIT_BYTES = W8A16_K_TILE * W8A16_UNIT_FEATURES
#: output features one K5 CTA owns (two consumer warpgroups)
W8A16_TILE_FEATURES = 2 * W8A16_UNIT_FEATURES
#: the token tiles (wgmma's N) K5 has instances for; more rows than the
#: largest take several tiles
W8A16_TOKEN_TILES = (8, 16, 32, 64, 128, 192, 256)
#: most linears one K5 launch takes (q, k, v)
W8A16_MAX_SEGMENTS = 3
#: token tiles up to this width run two CTAs an SM (the instances'
#: register cap), wider ones one
W8A16_TWO_PER_SM = 32
#: most K splits; a split's merge costs ``splits x token tile /
#: W8A16_MERGE_TOKENS`` K tiles of work in the planner's model (its partial
#: sums' round trip through L2 and the last CTA's serial read of them;
#: fitted to a sweep of split counts at the served widths on an H100)
W8A16_MAX_SPLITS = 16
W8A16_MERGE_TOKENS = 32


def pack_w8a16(w_q: torch.Tensor) -> torch.Tensor:
    """K5's packed layout of an int8 weight: (..., K, N) -> (..., ceil(N /
    64), ceil(K / 64), 4096), zero-padded to whole 64 x 64 units. Unit (u,
    kt) holds features [64 u, 64 u + 64) over K [64 kt, 64 kt + 64), so a
    CTA's stream of one unit row is one contiguous run. Inside a unit,
    thread t of a consumer warpgroup (warp w = t / 32, g = lane / 4, q =
    lane % 4) owns bytes [16 t, 16 t + 16) of each half c: its wgmma A
    fragments of k16 steps 2c and 2c + 1, ordered (step, k half, row half,
    k pair) over rows 16 w + g (+ 8) and k 2q (+ 1) (+ 8). Pure index
    arithmetic, one (K, N) layer at a time."""
    *lead, K, N = w_q.shape
    kt, units = cdiv(K, W8A16_K_TILE), cdiv(N, W8A16_UNIT_FEATURES)
    flat = w_q.reshape(-1, K, N)
    out = torch.empty((flat.shape[0], units, kt, W8A16_UNIT_BYTES),
                      dtype=torch.int8, device=w_q.device)
    for i in range(flat.shape[0]):
        pad = flat.new_zeros((kt * W8A16_K_TILE,
                              units * W8A16_UNIT_FEATURES))
        pad[:K, :N] = flat[i]
        # k = 64 kt + 32 c + 16 j + 8 kh + 2 q + e; n = 64 u + 16 w + 8 nh
        # + g -> (u, kt, c, w, g, q, j, kh, nh, e)
        out[i] = (pad.view(kt, 2, 2, 2, 4, 2, units, 4, 2, 8)
                  .permute(6, 0, 1, 7, 9, 4, 2, 3, 8, 5)
                  .reshape(units, kt, W8A16_UNIT_BYTES))
    return out.reshape(*lead, units, kt, W8A16_UNIT_BYTES)


def unpack_w8a16(w_p: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of ``pack_w8a16``: (..., units, kt, 4096) -> (..., K,
    N), the padding dropped."""
    *lead, units, kt, _ = w_p.shape
    flat = w_p.reshape(-1, units, kt, W8A16_UNIT_BYTES)
    out = torch.empty((flat.shape[0], K, N), dtype=torch.int8,
                      device=w_p.device)
    for i in range(flat.shape[0]):
        full = (flat[i].view(units, kt, 2, 4, 8, 4, 2, 2, 2, 2)
                .permute(1, 2, 6, 7, 5, 9, 0, 3, 8, 4)
                .reshape(kt * W8A16_K_TILE, units * W8A16_UNIT_FEATURES))
        out[i] = full[:K, :N]
    return out.reshape(*lead, K, N)


def w8a16_token_tile(M: int) -> tuple[int, int]:
    """(token tile, token tiles) of K5 at M rows: the narrowest instance
    that holds M (256 at most), or, beyond 256 rows, the narrowest that
    splits M into ceil(M / 256) tiles."""
    per = cdiv(M, cdiv(M, W8A16_TOKEN_TILES[-1]))
    bm = next(t for t in W8A16_TOKEN_TILES if t >= per)
    return bm, cdiv(M, bm)


def w8a16_feature_tiles(ns) -> int:
    """128-feature CTA tiles over the linears of one launch (each linear's
    features rounded up to whole 64-feature units, a lone last unit in a
    tile of its own)."""
    return sum(cdiv(cdiv(n, W8A16_UNIT_FEATURES), 2) for n in ns)


def plan_w8a16(M: int, K: int, ns, n_sm: int = 132
               ) -> tuple[int, int, int, int, int]:
    """K5's grid at M rows over the linears of output widths ``ns`` that
    share a K: (token tile, token tiles, CTA tiles, splits, K tiles per
    split). The grid is (tiles, splits), tiles = feature tiles x token
    tiles. Where a single token tile's CTAs leave a quarter of the SMs or
    more without one, K is split so that the CTAs still fit one wave of
    the SM slots (132, or
    264 at token tiles up to 32), into the count that finishes soonest: K
    tiles per split plus the merge (``W8A16_MERGE_TOKENS``), the fewer
    splits on a tie. Every split holds at least one K tile. Pure host
    arithmetic on the shapes."""
    bm, m_tiles = w8a16_token_tile(M)
    tiles = w8a16_feature_tiles(ns) * m_tiles
    kt = cdiv(K, W8A16_K_TILE)
    slots = n_sm * (2 if bm <= W8A16_TWO_PER_SM else 1)
    best_cost, splits = kt, 1
    if m_tiles == 1 and 4 * tiles <= 3 * n_sm:
        for s in range(2, min(kt, W8A16_MAX_SPLITS, slots // tiles) + 1):
            per = cdiv(kt, s)
            s = cdiv(kt, per)
            cost = per + s * bm / W8A16_MERGE_TOKENS
            if cost < best_cost:
                best_cost, splits = cost, s
    return bm, m_tiles, tiles, splits, cdiv(kt, splits)


def _w8a16_need(M: int, K: int, ns, n_sm: int) -> tuple[int, int, int]:
    """(splits, partial-sum floats, counters) of one launch: 128 features
    x the token tile per CTA and split, one counter per CTA tile."""
    bm, _, tiles, splits, _ = plan_w8a16(M, K, ns, n_sm)
    if splits == 1:
        return 1, 0, 0
    return splits, tiles * splits * W8A16_TILE_FEATURES * bm, tiles


def w8a16_scratch_size(groups, n_sm: int = 132) -> tuple[int, int]:
    """(floats, counters) that cover every launch over the ``(K, ns)``
    groups at any row count (more than one token tile never splits, so
    the rows up to the widest tile are all there is to cover)."""
    floats = counters = 0
    for K, ns in groups:
        for M in range(1, W8A16_TOKEN_TILES[-1] + 1):
            _, f, c = _w8a16_need(M, K, ns, n_sm)
            floats, counters = max(floats, f), max(counters, c)
    return floats, counters


class W8A16Scratch:
    """The workspace of split K5 launches: partial sums and per-tile
    arrival counters, which the kernel leaves at zero. Sized once for the
    ``(K, (N, ...))`` launches of its owner's quantized weights (the
    worker's backbone: ``models/backbone.py`` ``w8a16_groups``) and never
    replaced, so a captured CUDA graph keeps valid pointers while it
    lives. The launches that share one run in order on one stream, as a
    worker's do."""

    def __init__(self, device: torch.device, groups):
        device = torch.device(device)
        n_sm = _sm_count(device) if device.type == "cuda" else 132
        floats, counters = w8a16_scratch_size(groups, n_sm)
        self.part = torch.empty(max(floats, 1), dtype=torch.float32,
                                device=device)
        self.counters = torch.zeros(max(counters, 1), dtype=torch.int32,
                                    device=device)


def w8a16_linear_plain(x: torch.Tensor, w_p: torch.Tensor, w_s: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (the port of vox_serve_tpu's ``linear``
    over a quantized leaf): the packed weight ``w_p`` (units, kt, 4096)
    unpacked to ``w_q`` (K, N) (K from x, N from w_s), then ``(x @
    w_q.astype(x.dtype)) * w_s.astype(x.dtype)``, then ``+ b``."""
    w_q = unpack_w8a16(w_p, x.shape[-1], w_s.shape[0])
    y = (x @ w_q.to(x.dtype)) * w_s.to(x.dtype)
    if b is not None:
        y = y + b
    return y


def _w8a16_check(x: torch.Tensor, leaves) -> list[int]:
    """The output widths of a K5 launch, after checking what the kernel
    takes: x (..., K) bf16 contiguous; 1-3 leaves (w_p (ceil(N / 64),
    ceil(K / 64), 4096) int8 contiguous, w_s (N,) float32, b (N,) bf16 or
    None), all on x's device."""
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x has dtype {x.dtype}, expected torch.bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= len(leaves) <= W8A16_MAX_SEGMENTS:
        raise ValueError(f"{len(leaves)} linears in one K5 launch (1 to "
                         f"{W8A16_MAX_SEGMENTS})")
    K = x.shape[-1]
    ns = []
    for w_p, w_s, b in leaves:
        _check("w_p", w_p, torch.int8, 3, dev)
        _check("w_s", w_s, torch.float32, 1, dev)
        N = w_s.shape[0]
        want = (cdiv(N, W8A16_UNIT_FEATURES), cdiv(K, W8A16_K_TILE),
                W8A16_UNIT_BYTES)
        if tuple(w_p.shape) != want:
            raise ValueError(f"packed weight {tuple(w_p.shape)} does not "
                             f"match x {tuple(x.shape)} and w_s "
                             f"{tuple(w_s.shape)} (expected {want})")
        if b is not None:
            _check("b", b, torch.bfloat16, 1, dev)
            if b.shape[0] != N:
                raise ValueError(f"b {tuple(b.shape)} does not match N={N}")
        ns.append(N)
    return ns


def w8a16_linear_group(x: torch.Tensor, leaves,
                       scratch: Optional[W8A16Scratch] = None) -> tuple:
    """K5 over up to three linears that share x (q, k, v; gate, up) in
    one launch. ``leaves``: (w_p, w_s, b or None) each; returns their
    outputs (..., N) in order. CPU tensors: the plain version per linear.
    CUDA tensors: the kernel, or raise; its split partial sums go to
    ``scratch`` (the worker's ``W8A16Scratch``; without one, a fresh one
    per split launch). Counts on ``w8a16_linear``: ``launches``,
    ``grouped`` (launches of 2-3 linears) and ``split`` (split-K
    launches)."""
    leaves = [tuple(leaf) for leaf in leaves]
    if x.device.type == "cpu":
        return tuple(w8a16_linear_plain(x, *leaf) for leaf in leaves)
    if x.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {x.device}")
    dev = x.device
    ns = _w8a16_check(x, leaves)
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    ys = [torch.empty(x.shape[:-1] + (N,), dtype=torch.bfloat16, device=dev)
          for N in ns]
    xk = x.reshape(M, K)
    if K % 8 or xk.data_ptr() % 16:
        # the x tile's tensor map needs 16-byte rows and base: a zero-padded
        # copy (the padding meets zero-padded weights)
        xk = torch.nn.functional.pad(xk, (0, (-K) % 8))
    bm, _, tiles, splits, per = plan_w8a16(M, K, ns, _sm_count(dev))
    part = cnt = None
    if splits > 1:
        floats = tiles * splits * W8A16_TILE_FEATURES * bm
        if scratch is None:
            part = torch.empty(floats, dtype=torch.float32, device=dev)
            cnt = torch.zeros(tiles, dtype=torch.int32, device=dev)
        else:
            part, cnt = scratch.part, scratch.counters
            if part.device != dev:
                raise ValueError(f"K5 scratch is on {part.device}, x on "
                                 f"{dev}")
            if part.numel() < floats or cnt.numel() < tiles:
                raise ValueError(
                    f"K5 scratch ({part.numel()} floats, {cnt.numel()} "
                    f"counters) too small for M={M} K={K} N={ns} "
                    f"({floats}, {tiles})")
    pad = [None] * (W8A16_MAX_SEGMENTS - len(leaves))
    ws = [leaf[0].data_ptr() for leaf in leaves] + pad
    ss = [leaf[1].data_ptr() for leaf in leaves] + pad
    bs = [_ptr(leaf[2]) for leaf in leaves] + pad
    yp = [y.data_ptr() for y in ys] + pad
    nn = ns + [0] * len(pad)
    err = library().vox_w8a16_linear(
        xk.data_ptr(), *ws, *ss, *bs, *yp, *nn, len(leaves), _ptr(part),
        _ptr(cnt), M, xk.shape[1], bm, splits, per,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "w8a16_linear")
    w8a16_linear.launches += 1
    w8a16_linear.grouped += len(leaves) > 1
    w8a16_linear.split += splits > 1
    return tuple(ys)


def w8a16_linear(x: torch.Tensor, w_p: torch.Tensor, w_s: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 scratch: Optional[W8A16Scratch] = None) -> torch.Tensor:
    """K5 wrapper over one linear (``w8a16_linear_group`` of one)."""
    return w8a16_linear_group(x, [(w_p, w_s, b)], scratch)[0]


w8a16_linear.launches = 0
w8a16_linear.grouped = 0
w8a16_linear.split = 0


# ---------------------------------------------------------------------------
# K6: the depth transformer's layer around its four projections
# ---------------------------------------------------------------------------

#: the head dim K6b and K6c take; the most query heads per KV head, cache
#: positions and new tokens of one forward (K6c stages a row's cache rows
#: and queries in shared memory); the widest row K6a takes (one 8-wide
#: chunk a thread, 1024 threads)
DEPTH_HEAD_DIM = 128
DEPTH_MAX_GROUP = 8
DEPTH_MAX_SEQ = 64
DEPTH_MAX_NEW = 2
DEPTH_MAX_WIDTH = 8192


def depth_add_rms_norm_plain(h: torch.Tensor, r: Optional[torch.Tensor],
                             w: torch.Tensor, eps: float = 1e-6
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6a: (h + r, rms_norm(h + r, w)); without r, (h,
    rms_norm(h, w))."""
    if r is not None:
        h = h + r
    return h, rms_norm(h, w, eps)


def depth_qkv_rope_plain(qkv: torch.Tensor, q_norm: Optional[torch.Tensor],
                         k_norm: Optional[torch.Tensor],
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         start_pos: int, theta: float, eps: float = 1e-6
                         ) -> torch.Tensor:
    """Plain version of K6b. qkv: (B, t, (H + 2 KH) D), the q|k|v product
    of t new tokens at positions start_pos..; q_norm, k_norm: (D,), or both
    None; k_cache, v_cache: one layer's (B, S, KH, D), where k (normed,
    rotated) and v are written in place. Returns q, normed and rotated (B,
    t, H, D)."""
    B, t, _ = qkv.shape
    KH, D = k_cache.shape[2], k_cache.shape[3]
    H = qkv.shape[-1] // D - 2 * KH
    q, k, v = torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    q = q.reshape(B, t, H, D)
    k = k.reshape(B, t, KH, D)
    v = v.reshape(B, t, KH, D)
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
        k = rms_norm(k, k_norm, eps)
    inv_freq = rope_frequencies(D, theta, device=qkv.device)
    positions = torch.arange(start_pos, start_pos + t, device=qkv.device)
    angles = positions[:, None].float() * inv_freq[None, :]   # (t, D/2)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]

    def rot(x):
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    q = rot(q)
    k = rot(k)
    k_cache[:, start_pos:start_pos + t] = k.to(k_cache.dtype)
    v_cache[:, start_pos:start_pos + t] = v.to(v_cache.dtype)
    return q


def depth_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, start_pos: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K6c. q: (B, t, H, D) of the tokens at positions
    start_pos..; k_cache, v_cache: one layer's (B, S, KH, D). Query i sees
    cache positions <= start_pos + i; f32 scores, softmax and P.V. Returns
    (B, t, H D) in q's dtype."""
    B, t, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    positions = torch.arange(start_pos, start_pos + t, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= positions[:, None])                                 # (t, S)
    k_all = k_cache.float()
    v_all = v_cache.float()
    qg = q.reshape(B, t, KH, H // KH, D).float() * scale
    scores = torch.einsum("btkrd,bskd->bkrts", qg, k_all)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bkrts,bskd->btkrd", probs, v_all)
    return attn.reshape(B, t, H * D).to(q.dtype)


def depth_silu_mul_plain(gu: torch.Tensor) -> torch.Tensor:
    """Plain version of K6d: gu (..., 2 I), gate then up -> silu(g) * u."""
    g, u = torch.chunk(gu, 2, dim=-1)
    return F.silu(g) * u


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _no_k6(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no K6 kernel for device {dev}")


def depth_add_rms_norm(h: torch.Tensor, r: Optional[torch.Tensor],
                       w: torch.Tensor, eps: float = 1e-6
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6a wrapper: (h + r, rms_norm(h + r, w)), r None: (h, rms_norm(h,
    w)). h, r: (..., C) bf16 contiguous, C a multiple of 8 up to
    ``DEPTH_MAX_WIDTH``; w: (C,) bf16, on CUDA."""
    dev = h.device
    _check("h", h, torch.bfloat16, h.dim(), dev)
    C = h.shape[-1]
    if r is not None:
        _check("r", r, torch.bfloat16, h.dim(), dev)
        if r.shape != h.shape:
            raise ValueError(f"r {tuple(r.shape)} does not match h "
                             f"{tuple(h.shape)}")
    _check("w", w, torch.bfloat16, 1, dev)
    if w.shape[0] != C or C % 8 or not 0 < C <= DEPTH_MAX_WIDTH:
        raise ValueError(f"width {C} (w {tuple(w.shape)}) unsupported: a "
                         f"multiple of 8 up to {DEPTH_MAX_WIDTH}")
    _no_k6(dev)
    out = torch.empty_like(h)
    h_out = h if r is None else torch.empty_like(h)
    err = library().vox_depth_add_rms_norm(
        h.data_ptr(), _ptr(r), w.data_ptr(),
        None if r is None else h_out.data_ptr(), out.data_ptr(),
        h.numel() // C, C, float(eps), _stream(dev))
    _raise_on(err, "depth_add_rms_norm")
    depth_add_rms_norm.launches += 1
    return h_out, out


depth_add_rms_norm.launches = 0


def depth_qkv_rope(qkv: torch.Tensor, q_norm: Optional[torch.Tensor],
                   k_norm: Optional[torch.Tensor], k_cache: torch.Tensor,
                   v_cache: torch.Tensor, start_pos: int, theta: float,
                   eps: float = 1e-6) -> torch.Tensor:
    """K6b wrapper (``depth_qkv_rope_plain``'s contract): qkv (B, t, (H + 2
    KH) 128), caches (B, S, KH, 128), all bf16 contiguous, start_pos + t
    <= S, on CUDA."""
    dev = qkv.device
    _check("qkv", qkv, torch.bfloat16, 3, dev)
    _check("k_cache", k_cache, torch.bfloat16, 4, dev)
    _check("v_cache", v_cache, torch.bfloat16, 4, dev)
    B, t, W = qkv.shape
    _, S, KH, D = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B \
            or D != DEPTH_HEAD_DIM or W % D or W // D <= 2 * KH:
        raise ValueError(f"qkv {tuple(qkv.shape)} and caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"unsupported (head dim {DEPTH_HEAD_DIM})")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm come together")
    for name, nw in (("q_norm", q_norm), ("k_norm", k_norm)):
        if nw is not None:
            _check(name, nw, torch.bfloat16, 1, dev)
            if nw.shape[0] != D:
                raise ValueError(f"{name} {tuple(nw.shape)}, expected ({D},)")
    if t < 1 or start_pos < 0 or start_pos + t > S:
        raise ValueError(f"positions {start_pos}..{start_pos + t - 1} "
                         f"outside a cache of {S}")
    _no_k6(dev)
    H = W // D - 2 * KH
    q = torch.empty((B, t, H, D), dtype=torch.bfloat16, device=dev)
    err = library().vox_depth_qkv_rope(
        qkv.data_ptr(), _ptr(q_norm), _ptr(k_norm), q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), B, t, H, KH, D, S,
        int(start_pos), float(theta), float(eps), _stream(dev))
    _raise_on(err, "depth_qkv_rope")
    depth_qkv_rope.launches += 1
    return q


depth_qkv_rope.launches = 0


def depth_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, start_pos: int,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K6c wrapper (``depth_attention_plain``'s contract): q (B, t, H,
    128), caches (B, S, KH, 128), all bf16 contiguous, H / KH up to
    ``DEPTH_MAX_GROUP``, t up to ``DEPTH_MAX_NEW``, S up to
    ``DEPTH_MAX_SEQ``, on CUDA."""
    dev = q.device
    _check("q", q, torch.bfloat16, 4, dev)
    _check("k_cache", k_cache, torch.bfloat16, 4, dev)
    _check("v_cache", v_cache, torch.bfloat16, 4, dev)
    B, t, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D or D != DEPTH_HEAD_DIM:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
                         f"unsupported (head dim {DEPTH_HEAD_DIM})")
    _check_heads(H, KH, D, DEPTH_MAX_GROUP)
    if not 1 <= t <= DEPTH_MAX_NEW or S > DEPTH_MAX_SEQ or start_pos < 0 \
            or start_pos + t > S:
        raise ValueError(f"t={t} new tokens at {start_pos} over a cache of "
                         f"{S} unsupported (t <= {DEPTH_MAX_NEW}, cache <= "
                         f"{DEPTH_MAX_SEQ})")
    _no_k6(dev)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, t, H * D), dtype=torch.bfloat16, device=dev)
    err = library().vox_depth_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        B, t, H, KH, D, S, int(start_pos), float(scale), _stream(dev))
    _raise_on(err, "depth_attention")
    depth_attention.launches += 1
    return out


depth_attention.launches = 0


def depth_silu_mul(gu: torch.Tensor) -> torch.Tensor:
    """K6d wrapper: gu (..., 2 I) bf16 contiguous, I a multiple of 8 ->
    silu(g) * u (..., I), on CUDA."""
    dev = gu.device
    _check("gu", gu, torch.bfloat16, gu.dim(), dev)
    I2 = gu.shape[-1]
    if I2 % 16 or I2 == 0:
        raise ValueError(f"gate|up width {I2} unsupported (2 x a multiple "
                         "of 8)")
    _no_k6(dev)
    out = torch.empty(gu.shape[:-1] + (I2 // 2,), dtype=torch.bfloat16,
                      device=dev)
    err = library().vox_depth_silu_mul(gu.data_ptr(), out.data_ptr(),
                                       gu.numel() // I2, I2 // 2,
                                       _sm_count(dev), _stream(dev))
    _raise_on(err, "depth_silu_mul")
    depth_silu_mul.launches += 1
    return out


depth_silu_mul.launches = 0


def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from .resunit import fused_resunit_stack, fused_resunit_stack_bf16

    return {
        "paged_decode_attention": paged_decode_attention,
        "paged_decode_attention_quant": paged_decode_attention_quant,
        "paged_decode_attention_pair": paged_decode_attention_pair,
        "ragged_prefill_attention": ragged_prefill_attention,
        "fused_resunit_stack": fused_resunit_stack,
        "fused_resunit_stack_bf16": fused_resunit_stack_bf16,
        "w8a16_linear": w8a16_linear,
        "depth_add_rms_norm": depth_add_rms_norm,
        "depth_qkv_rope": depth_qkv_rope,
        "depth_attention": depth_attention,
        "depth_silu_mul": depth_silu_mul,
    }


#: the counters a wrapper keeps beside ``launches`` (K2 also counts stacks,
#: K5 its grouped and split launches)
_EXTRA_COUNTERS = {"fused_resunit_stack": ("stacks",),
                   "fused_resunit_stack_bf16": ("stacks",),
                   "w8a16_linear": ("grouped", "split")}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def counters() -> dict[tuple[str, str], int]:
    """Every counter of every wrapper, by (wrapper name, counter)."""
    return {(name, field): getattr(fn, field)
            for name, fn in wrappers().items()
            for field in ("launches", *_EXTRA_COUNTERS.get(name, ()))}


def set_counters(values: dict[tuple[str, str], int]) -> None:
    """Put the counters back to ``values`` (``counters()`` output): a graph
    capture runs the wrappers without launching."""
    fns = wrappers()
    for (name, field), n in values.items():
        setattr(fns[name], field, n)


def reset_launch_counts() -> None:
    set_counters({k: 0 for k in counters()})
