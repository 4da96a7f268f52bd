"""Port parity, quantized KV pools (K1q's path): the int8 / float8 e4m3
write path bit for bit against the JAX package, decode over the quantized
pool against JAX's dequantizing gather, the layout rule, the worker's pool
choice and fallback, and the flags from the launcher to the daemon and its
stats file. CPU only: the kernel itself is held against its plain version
on the card (``test_torch_kernels.py``, ``chip_smoke.py``).

Tolerances: the quantized bytes and pools must be equal; decode outputs
1e-5 absolute (float32, the same formula summed in another order).
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import time

import httpx
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vox_serve_tpu.models.backbone import BackboneConfig as JBackboneConfig
from vox_serve_tpu.models.backbone import init_backbone_params as jinit_bb
from vox_serve_tpu.models.dummy import DummyLM as JDummyLM
from vox_serve_tpu.ops import attention as jattn
from vox_serve_tpu.ops import kv_cache as jkv
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import launch as tlaunch
from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                 init_backbone_params,
                                                 seeded_generator)
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.ops import attention as tattn
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.ops import kv_cache as tkv
from vox_serve_tpu_torch.scheduler_entry import build_parser as daemon_parser
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
QUANTS = ["int8", "f8_e4m3"]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        "float8_e4m3fn": jnp.float8_e4m3fn}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bytes_j(a):
    return np.asarray(a).view(np.uint8)


def _bytes_t(t):
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.numpy()


def _kv_values(rng, shape, scale):
    """Normal values with out-of-range tails and exact int8 half-steps (the
    round-half-to-even cases)."""
    x = rng.standard_normal(shape).astype(np.float32) * 4
    flat = x.reshape(-1)
    n = flat.size
    flat[: n // 8] = rng.choice([-1000.0, -448.5, 449.0, 700.0], n // 8)
    half = (rng.integers(-140, 140, n // 8) + 0.5) * np.float32(scale)
    flat[n // 8: n // 4] = half.astype(np.float32)
    return x


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_exact_against_jax(quant, in_dtype):
    cfg = tkv.KVCacheConfig(1, 2, 4, 2, 16, combined=True, quant=quant,
                            k_amax=6.0, v_amax=3.0)
    rng = np.random.default_rng(0)
    k = _kv_values(rng, (4000, 2, 16), cfg.kv_scales[0])
    v = _kv_values(rng, (4000, 2, 16), cfg.kv_scales[1])
    if in_dtype == "bfloat16":
        k = k.astype(ml_dtypes.bfloat16)
        v = v.astype(ml_dtypes.bfloat16)
    jk, jv = jattn._quantize_kv(jnp.asarray(k), jnp.asarray(v),
                                _JNP[str(cfg.pool_dtype).split(".")[1]],
                                cfg.kv_scales)
    tdt = getattr(torch, in_dtype)
    tk, tv = tattn._quantize_kv(
        torch.from_numpy(k.astype(np.float32)).to(tdt),
        torch.from_numpy(v.astype(np.float32)).to(tdt), cfg.pool_dtype,
        cfg.kv_scales)
    assert tk.dtype == cfg.pool_dtype
    np.testing.assert_array_equal(_bytes_t(tk), _bytes_j(jk))
    np.testing.assert_array_equal(_bytes_t(tv), _bytes_j(jv))


def _write_sequence(quant, steps=6, L=2, P=8, page=4, KH=2, D=16):
    """A prefill write then single-token decode writes, in both packages;
    returns (jax pool, torch pool, cfg, tables, seq_lens)."""
    cfg = tkv.KVCacheConfig(L, P, page, KH, D, dtype=torch.float32,
                            combined=True, quant=quant, k_amax=5.0,
                            v_amax=4.0)
    jcfg = jkv.KVCacheConfig(L, P, page, KH, D, dtype=jnp.float32,
                             combined=True, quant=quant, k_amax=5.0,
                             v_amax=4.0)
    jpool, _ = jkv.alloc_kv_pages(jcfg)
    tpool, none = tkv.alloc_kv_pages(cfg, "cpu")
    assert none is None and tpool.dtype == cfg.pool_dtype
    assert str(jpool.dtype) == str(cfg.pool_dtype).split(".")[1]
    rng = np.random.default_rng(1)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    lens = np.array([7, 3, 2], np.int32)
    # prefill: the three prompts packed, plus one padded row on page 0
    ids, offs = [], []
    for b, n in enumerate(lens):
        for t in range(n):
            ids.append(tables[b, t // page])
            offs.append(t % page)
    ids.append(0)
    offs.append(0)
    writes = [(np.array(ids, np.int32), np.array(offs, np.int32), layer)
              for layer in range(L)]
    for s in range(steps):
        b = s % 3
        t = lens[b]
        lens[b] += 1
        writes += [(np.array([tables[b, t // page]], np.int32),
                    np.array([t % page], np.int32), layer)
                   for layer in range(L)]
    for ids, offs, layer in writes:
        k = (rng.standard_normal((len(ids), KH, D)) * 3).astype(np.float32)
        v = (rng.standard_normal((len(ids), KH, D)) * 3).astype(np.float32)
        jm = jattn.AttnMetadata(False, jnp.asarray(ids), jnp.asarray(offs))
        jpool, _ = jattn.write_kv_decode(jpool, None, layer, jnp.asarray(k),
                                         jnp.asarray(v), jm,
                                         kv_scales=jcfg.kv_scales)
        tm = tattn.AttnMetadata(False, _t(ids), _t(offs))
        tattn.write_kv_decode(tpool, None, layer, _t(k), _t(v), tm,
                              kv_scales=cfg.kv_scales)
    return jpool, tpool, cfg, tables, lens


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_pool_after_writes_is_bytewise_jax(quant):
    jpool, tpool, cfg, *_ = _write_sequence(quant)
    # the JAX pool pads head dims to 128 TPU lanes (store_dim), with zeros
    jb = _bytes_j(jpool)
    D = cfg.head_dim
    assert np.count_nonzero(jb[..., D:]) == 0
    np.testing.assert_array_equal(_bytes_t(tpool), jb[..., :D])
    assert np.count_nonzero(jb) > 0


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_decode_matches_jax_gather(quant):
    jpool, tpool, cfg, tables, lens = _write_sequence(quant)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    jm = jattn.AttnMetadata(False, None, None,
                            block_tables=jnp.asarray(tables),
                            seq_lens=jnp.asarray(lens))
    tm = tattn.AttnMetadata(False, None, None, block_tables=_t(tables),
                            seq_lens=_t(lens))
    for layer in range(2):
        ref = np.asarray(jattn._combined_decode_gather(
            jnp.asarray(q), jpool, layer, jm, None,
            kv_scales=cfg.kv_scales))
        got = tattn.paged_attention_decode(_t(q), tpool, None, layer, tm,
                                           kv_scales=cfg.kv_scales)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
        # the K1q wrapper takes the plain path for CPU tensors, uncounted
        before = kernels.paged_decode_attention_quant.launches
        q2 = kernels.paged_decode_attention_quant(
            _t(q), tpool, layer, _t(tables), _t(lens), cfg.kv_scales)
        np.testing.assert_array_equal(q2.numpy(), got.numpy())
        assert kernels.paged_decode_attention_quant.launches == before
    with pytest.raises(ValueError, match="kv_scales"):
        kernels.paged_decode_attention(_t(q), tpool, 0, _t(tables),
                                       _t(lens))


def test_kv_cache_config_rules_match_jax():
    for quant in ("none", *QUANTS):
        t = tkv.KVCacheConfig(1, 2, 4, 2, 16, combined=True, quant=quant,
                              k_amax=10.0, v_amax=2.0)
        j = jkv.KVCacheConfig(1, 2, 4, 2, 16, combined=True, quant=quant,
                              k_amax=10.0, v_amax=2.0)
        assert t.kv_scales == j.kv_scales
    for bad in (dict(quant="int4"), dict(quant="int8", combined=False)):
        with pytest.raises(ValueError):
            tkv.KVCacheConfig(1, 2, 4, 2, 16, **bad)
        with pytest.raises(ValueError):
            jkv.KVCacheConfig(1, 2, 4, 2, 16, **bad)


def test_combined_kv_supported_matches_jax():
    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.int8, jnp.int8),
              (torch.float8_e4m3fn, jnp.float8_e4m3fn)]
    seen = set()
    for D in (16, 64, 96, 128, 160, 256):
        for KH in (1, 2, 3, 4, 6, 8, 12, 16, 20):
            for tdt, jdt in dtypes:
                want = jkv.combined_kv_supported(D, KH, jdt)
                assert tkv.combined_kv_supported(D, KH, tdt) == want, \
                    (D, KH, tdt)
                seen.add(want)
    assert seen == {True, False}


def _dummy_pair(num_kv_heads=2):
    """The port's and the JAX package's dummy models with the same
    backbone shape (KH changed on both when asked)."""
    tm, jm = DummyLM(), JDummyLM()
    if num_kv_heads != 2:
        tm._cfg = BackboneConfig(vocab_size=64, hidden_size=64, num_layers=2,
                                 num_heads=4, num_kv_heads=num_kv_heads,
                                 intermediate_size=128, dtype=torch.float32)
        tm.params["backbone"] = init_backbone_params(
            tm._cfg, seeded_generator("cpu", 0), "cpu")
        jm._cfg = JBackboneConfig(vocab_size=64, hidden_size=64,
                                  num_layers=2, num_heads=4,
                                  num_kv_heads=num_kv_heads,
                                  intermediate_size=128, dtype=jnp.float32)
        jm.params = {**jm.params,
                     "backbone": jinit_bb(jm._cfg, jax.random.key(0))}
    return tm, jm


def _workers(kv_quant, num_kv_heads=2):
    tm, jm = _dummy_pair(num_kv_heads)
    kw = dict(max_batch_size=2, num_pages=64, page_size=16,
              kv_quant=kv_quant, kv_k_amax=8.0, kv_v_amax=2.0)
    return (ModelWorker(tm, WorkerConfig(**kw)),
            JWorker(jm, JWorkerConfig(warmup=False, **kw)), tm, jm)


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_worker_picks_the_pool_dtype_jax_picks(kv_quant):
    tw, jw, tm, jm = _workers(kv_quant)
    assert tw.kv_config.quant == jw.kv_config.quant == kv_quant
    assert tw.kv_config.combined and jw.kv_config.combined
    assert str(tw.k_pages.dtype).split(".")[1] == str(jw.k_pages.dtype)
    assert tw.v_pages is None and jw.v_pages is None
    assert tm.kv_quant_scales == jm.kv_quant_scales is not None


def test_worker_falls_back_like_jax_on_an_unsupported_shape():
    """int8 needs 2*KH divisible by 4: with KH=1 both packages serve a
    full-precision combined pool instead."""
    tw, jw, tm, jm = _workers("int8", num_kv_heads=1)
    assert tw.kv_config.quant == jw.kv_config.quant == "none"
    assert tw.k_pages.dtype == torch.float32
    assert str(jw.k_pages.dtype) == "float32"
    assert tm.kv_quant_scales is None and jm.kv_quant_scales is None


def test_worker_with_int8_kv_serves_tokens():
    tw, *_ = _workers("int8")
    from vox_serve_tpu_torch.requests import Request

    req = Request(request_id="q", prompt="hello world")
    tw.run_lm_prefill([req])
    for _ in range(4):
        if req.done_lm_generation:
            break
        tw.run_lm_decode([req])
    tw.free_kv_cache(req)
    assert len(req.lm_output_tokens) >= 2
    assert torch.count_nonzero(tw.k_pages) > 0


def test_kv_quant_flags_parse_like_jax():
    args = daemon_parser().parse_args(
        ["--model", "dummy", "--kv-quant", "int8", "--kv-k-amax", "12.5",
         "--kv-v-amax", "9.0"])
    assert (args.kv_quant, args.kv_k_amax, args.kv_v_amax) == ("int8", 12.5,
                                                               9.0)
    largs = tlaunch.build_parser().parse_args(["--kv-quant", "f8_e4m3"])
    assert largs.kv_quant == "f8_e4m3"
    src = inspect.getsource(tlaunch.main)
    for key in ("kv_quant", "kv_k_amax", "kv_v_amax"):
        assert f'"{key}"' in src, f"{key} missing from scheduler_args"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_daemon_stats_file_records_what_it_served(tmp_path):
    """launch -> daemon: --kv-quant and the amax flags arrive, and the stats
    file written when the daemon is terminated names the KV layout, the
    pool dtype and the codec path."""
    port = _free_port()
    stats = tmp_path / "stats.json"
    env = {**os.environ, "VOX_FUSED_RESUNIT": "1"}
    env.pop("VOX_KV_COMBINED", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vox_serve_tpu_torch.launch",
         "--model", "dummy", "--device", "cpu", "--port", str(port),
         "--host", "127.0.0.1", "--max-batch-size", "2",
         "--max-num-pages", "32", "--page-size", "8",
         "--prefill-buckets", "64", "--socket-suffix", f"_kvq{port}",
         "--kv-quant", "int8", "--kv-k-amax", "12.7", "--kv-v-amax", "2.54",
         "--stats-file", str(stats)], cwd=ROOT, env=env)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "server died during startup"
            try:
                if httpx.get(f"http://127.0.0.1:{port}/health",
                             timeout=2).status_code == 200:
                    break
            except httpx.HTTPError:
                pass
            assert time.time() < deadline, "server did not become healthy"
            time.sleep(0.3)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    for _ in range(100):
        if stats.exists() and stats.stat().st_size:
            break
        time.sleep(0.1)
    got = json.loads(stats.read_text())
    assert got["kv_layout"] == "combined"
    assert got["kv_pool_dtype"] == "int8"
    assert got["fused_resunit"] is True
    np.testing.assert_allclose(got["kv_scales"], [0.1, 0.02], rtol=1e-6)
    assert set(got["launches"].values()) == {0}  # the CPU runs no kernel
