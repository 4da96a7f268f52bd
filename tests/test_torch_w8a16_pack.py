"""K5's packed int8 layout and grouped launches on the CPU, with
tests/test_weight_quant.py's JAX package as the oracle at small widths:

* ``pack_w8a16`` / ``unpack_w8a16`` round trip bit for bit at the served
  families' shapes (whole 64 x 64 units) and at odd ones (padded), over a
  stack of layers, and the padding is zeros;
* the packed bytes read thread by thread as wgmma's register layout of A
  (rows g and g + 8, k 2q, 2q + 1, 2q + 8, 2q + 9 of each k16 step), which
  is how the kernel consumes them;
* the plain version over a packed leaf equals JAX's ``linear`` over the
  ``w_q`` leaf (float32 within 1e-5, bf16 within one bf16 step);
* the grouped wrapper's plain path equals separate ``linear`` calls
  and JAX's rule exactly (q/k/v and gate/up);
* ``pack_backbone_params``: every quantized leaf's ``w_q`` replaced by
  ``w_p`` (unpacking gives JAX's ``w_q`` back), the rest shared; the
  packed backbone equals JAX's quantized one over prefill + decode;
  ``w8a16_groups`` gives the scratch its launch shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import Plan, _i
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.ops import kernels

torch.set_num_threads(1)
ATOL_F32 = 1e-5       # one linear: the same sum in another order
BACKBONE_ATOL = 1e-4  # the other backbone parity tests' tolerance

#: (K, N) of the served linears (whole units) and odd shapes (padded)
SHAPES = [(2048, 1024), (3072, 8192), (4096, 256), (13696, 4096),
          (896, 128), (4864, 896), (1024, 4096), (3584, 512),
          (200, 300), (64, 5), (100, 64), (8, 8), (130, 1)]


def _q(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("K,N", SHAPES)
def test_pack_round_trip_is_bit_exact(K, N):
    rng = np.random.default_rng(K * 7 + N)
    q = _q(rng, (2, K, N)) if K * N <= 2 ** 22 else _q(rng, (K, N))
    p = kernels.pack_w8a16(q)
    units, kt = -(-N // 64), -(-K // 64)
    assert p.shape == q.shape[:-2] + (units, kt, 4096)
    assert p.dtype == torch.int8 and p.is_contiguous()
    assert torch.equal(kernels.unpack_w8a16(p, K, N), q)
    # the padding is zeros: the packed bytes hold q's and nothing else
    assert int((p != 0).sum()) == int((q != 0).sum())


@pytest.mark.parametrize("K,N", [(128, 128), (200, 300)])
def test_packed_bytes_follow_the_wgmma_register_layout(K, N):
    """Unit (u, kt), half c, thread t = 32 w + 4 g + q, byte 8 j + 2 r + e
    is A's register r (r = 2 kh + nh) element e of k16 step s = 2c + j:
    feature 64 u + 16 w + g + 8 nh, k 64 kt + 16 s + 2 q + e + 8 kh."""
    rng = np.random.default_rng(3)
    q = _q(rng, (K, N))
    p = kernels.pack_w8a16(q)
    full = torch.zeros((p.shape[1] * 64, p.shape[0] * 64), dtype=torch.int8)
    full[:K, :N] = q
    t = torch.arange(128)
    w, g, qq = t // 32, (t % 32) // 4, t % 4
    for u in range(p.shape[0]):
        for kt in range(p.shape[1]):
            unit = p[u, kt].view(2, 128, 16)
            for c in range(2):
                for j in range(2):
                    for r in range(4):
                        for e in range(2):
                            kh, nh = r // 2, r % 2
                            n = 64 * u + 16 * w + g + 8 * nh
                            k = (64 * kt + 16 * (2 * c + j) + 2 * qq + e
                                 + 8 * kh)
                            assert torch.equal(unit[c, :, 8 * j + 2 * r + e],
                                               full[k, n])


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_over_the_packed_leaf_matches_jax(dtype, bias):
    rng = np.random.default_rng(2)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    p = {"w": jnp.asarray(rng.standard_normal((200, 300)) * 0.1, jdt)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(300), jdt)
    jq = jbb.quantize_linear_params(p)
    x = jnp.asarray(rng.standard_normal((7, 200)), jdt)
    ref = np.asarray(jbb.linear(jq, x).astype(jnp.float32))
    tq = tparams.tree_to_torch(jax.tree.map(np.asarray, jq), "cpu",
                               getattr(torch, dtype))
    tx = tparams.to_tensor(np.asarray(x), "cpu")
    got = kernels.w8a16_linear_plain(tx, kernels.pack_w8a16(tq["w_q"]),
                                     tq["w_s"], tq.get("b"))
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL_F32, rtol=0)
    else:
        step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= step


def _leaf(g, K, N, bias):
    w = torch.randn((K, N), generator=g) * K ** -0.5
    leaf = {"w": w}
    if bias:
        leaf["b"] = torch.randn((N,), generator=g)
    q = tbb.quantize_linear_params(leaf)
    packed = {"w_p": kernels.pack_w8a16(q["w_q"]), "w_s": q["w_s"]}
    if bias:
        packed["b"] = q["b"]
    return q, packed


@pytest.mark.parametrize("ns,bias", [((96, 32, 32), True),
                                     ((160, 160), False), ((70,), True)])
def test_grouped_plain_path_equals_separate_linears(ns, bias):
    """The grouped launch's plain path is each ``linear`` alone, bit for
    bit, and JAX's rule over the unpacked weight."""
    g = torch.Generator().manual_seed(len(ns))
    leaves = [_leaf(g, 80, n, bias) for n in ns]
    x = torch.randn((5, 80), generator=g)
    before = kernels.counters()
    grouped = tbb.linear_group([p for _, p in leaves], x)
    assert kernels.counters() == before  # the CPU launches nothing
    assert len(grouped) == len(ns)
    for (q, p), y in zip(leaves, grouped):
        assert torch.equal(y, tbb.linear(p, x))
        rule = (x @ q["w_q"].to(x.dtype)) * q["w_s"]
        assert torch.equal(y, rule + q["b"] if bias else rule)


def _bb_cfg(pkg, **kw):
    dt = jnp.float32 if pkg is jbb else torch.float32
    return pkg.BackboneConfig(
        vocab_size=64, hidden_size=64, num_layers=2, num_heads=6,
        num_kv_heads=2, head_dim=16, intermediate_size=128, qkv_bias=True,
        qk_norm=True, rms_eps=1e-5, dtype=dt, **kw)


def test_packed_tree_and_backbone_match_jax():
    jcfg, tcfg = _bb_cfg(jbb), _bb_cfg(tbb)
    jq = jbb.quantize_backbone_params(
        jbb.init_backbone_params(jcfg, jax.random.key(5)))
    npq = jax.tree.map(np.asarray, jq)
    tq = tparams.tree_to_torch(npq, "cpu", torch.float32)
    tp = tbb.pack_backbone_params(tq)
    lay, qlay = tp["layers"], tq["layers"]
    for part, names in tbb.LINEAR_GROUPS:
        for n in names:
            leaf = lay[part][n]
            assert "w_q" not in leaf and leaf["w_p"].dtype == torch.int8
            K, N = qlay[part][n]["w_q"].shape[-2:]
            assert torch.equal(kernels.unpack_w8a16(leaf["w_p"], K, N),
                               qlay[part][n]["w_q"])
            assert leaf["w_s"] is qlay[part][n]["w_s"]
            assert leaf.get("b") is qlay[part][n].get("b")
    assert "w_q" in qlay["attn"]["q"]  # the input is not changed
    assert lay["input_norm"] is qlay["input_norm"]
    assert tbb.w8a16_groups(tp) == [(64, (96, 32, 32)), (128, (64,)),
                                    (64, (128, 128)), (128, (64,))]
    plan = Plan(lens=(11, 6))
    shape = (2, plan.P, plan.page, 4, 16)
    jpool, tpool = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(7)
    for jm, tm, pos in [plan.prefill()[:3]] + [plan.decode()
                                              for _ in range(2)]:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jq, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool, None)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tpool)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                   atol=BACKBONE_ATOL, rtol=0)
