"""The port's hand-written Hopper kernels, their wrappers and their plain
PyTorch versions.

Five kernels, all CUDA C++ for ``sm_90a`` under ``csrc/``:

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
  ``fused_resunit_stack``.

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
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
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
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci,
                cf, cf, vp]
            lib.vox_paged_decode_attention.restype = ci
            lib.vox_paged_decode_attention_pair.argtypes = [
                vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf,
                vp]
            lib.vox_paged_decode_attention_pair.restype = ci
            lib.vox_ragged_prefill_attention.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, vp]
            lib.vox_ragged_prefill_attention.restype = ci
            lib.vox_resunit.argtypes = [vp] * 14 + [ci] * 6 + [vp]
            lib.vox_resunit.restype = ci
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
    if KH <= 0 or H % KH:
        raise ValueError(f"{H} query heads not a multiple of {KH} KV heads")
    G = H // KH
    if G > max_group or max_group % G:
        raise ValueError(f"GQA group {G} unsupported (divisor of "
                         f"{max_group} required)")
    if D > 128 or D % 8:
        raise ValueError(f"head dim {D} unsupported (multiple of 8, <= 128)")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1, K1q and K4: paged decode attention
# ---------------------------------------------------------------------------

#: pool element type -> the kernel's pool_type code (K1 bf16, K1q the rest)
_POOL_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


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
    _check_heads(H, KH, D, 8)
    B = q.shape[0]
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens batch mismatch")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")


def _launch_combined(q, pool, layer, block_tables, seq_lens, scale,
                     kv_scales) -> torch.Tensor:
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
    ks, vs = kv_scales if kv_scales is not None else (1.0, 1.0)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    err = library().vox_paged_decode_attention(
        q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, H, KH, D, P, page,
        block_tables.shape[1], int(layer), float(scale),
        _POOL_TYPES[pool.dtype], float(ks), float(vs),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    return out


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor, layer: int,
                           block_tables: torch.Tensor, seq_lens: torch.Tensor,
                           scale: Optional[float] = None,
                           kv_scales: Optional[tuple[float, float]] = None
                           ) -> torch.Tensor:
    """K1 wrapper over the combined pool. CPU tensors: the plain version.
    CUDA tensors: the kernel (bf16 q, int32 tables and lengths), or raise.
    A quantized pool (int8, float8_e4m3fn) goes to K1q, which needs
    ``kv_scales``; a bf16 pool takes none."""
    if pool.dtype in (torch.int8, torch.float8_e4m3fn):
        if kv_scales is None:
            raise ValueError(f"a {pool.dtype} pool needs kv_scales")
        return paged_decode_attention_quant(q, pool, layer, block_tables,
                                            seq_lens, kv_scales, scale)
    if kv_scales is not None:
        raise ValueError(f"kv_scales given for a {pool.dtype} pool")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool, layer, block_tables,
                                            seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {q.device}")
    out = _launch_combined(q, pool, layer, block_tables, seq_lens, scale,
                           None)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q: torch.Tensor, pool: torch.Tensor,
                                 layer: int, block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 kv_scales: tuple[float, float],
                                 scale: Optional[float] = None
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
                           kv_scales)
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
                                scale: Optional[float] = None
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
    err = library().vox_paged_decode_attention_pair(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B, H,
        KH, D, P, page, block_tables.shape[1], int(layer), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged_decode_attention_pair")
    paged_decode_attention_pair.launches += 1
    return out


paged_decode_attention_pair.launches = 0


# ---------------------------------------------------------------------------
# K3: ragged causal prefill attention
# ---------------------------------------------------------------------------


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
    (bf16 q/k/v, int32 segment ids), or raise."""
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
    _check_heads(H, KH, D, 32)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().vox_ragged_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), T, H, KH, D, float(scale), stream)
    _raise_on(err, "ragged_prefill_attention")
    ragged_prefill_attention.launches += 1
    return out


ragged_prefill_attention.launches = 0

def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from .resunit import fused_resunit_stack

    return {
        "paged_decode_attention": paged_decode_attention,
        "paged_decode_attention_quant": paged_decode_attention_quant,
        "paged_decode_attention_pair": paged_decode_attention_pair,
        "ragged_prefill_attention": ragged_prefill_attention,
        "fused_resunit_stack": fused_resunit_stack,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["fused_resunit_stack"].stacks = 0
