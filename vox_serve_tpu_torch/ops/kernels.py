"""The port's hand-written Hopper kernels, their wrappers and their plain
PyTorch versions.

Five kernels (K2 in two types), all CUDA C++ for ``sm_90a`` under ``csrc/``:

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
  in the bf16 serving dtype.

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
(``plan_decode_splits``, ``plan_prefill_tiles``), so no launch waits on
the device. A split decode launch keeps its partial states in the
caller's ``DecodeScratch`` (the worker sizes one at start-up), or in one
of its own.
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

from ..utils import cdiv

NEG_INF = float(torch.finfo(torch.float32).min)

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("paged_decode.cu", "ragged_prefill.cu", "resunit.cu")
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
    }


#: the counters a wrapper keeps beside ``launches`` (K2 also counts stacks)
_EXTRA_COUNTERS = {"fused_resunit_stack": ("stacks",),
                   "fused_resunit_stack_bf16": ("stacks",)}


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
