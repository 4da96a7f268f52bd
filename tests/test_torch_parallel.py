"""Port parity, tensor parallelism (vox_serve_tpu_torch/parallel/,
models/backbone.py's split forward) against vox_serve_tpu/parallel/ on the
CPU (JAX's virtual 8-device mesh):

* ``make_mesh``: the same grid, errors and trailing-device warning as
  JAX's on the same ``(dp, tp, n)`` cases;
* ``backbone_param_shardings``: leaf by leaf, the port's split axes equal
  the ``PartitionSpec``s of JAX's rules, for a bf16 tree, an int8 tree, a
  LayerNorm tree and a tree with every bias and ``pos_emb``;
* ``shard_params``: the shards put back together give the whole tree, with
  ``KH % tp == 0`` (KV heads split) and ``tp % KH == 0`` (each rank the one
  KV head its query heads read);
* the split backbone, its ranks run one after another on one device with
  the partial sums added in place of the all-reduce
  (``backbone_forward_shards``), against JAX's whole ``backbone_forward``
  over a prefill and three decode steps, the same numpy weights and
  inputs: tp 2 and 4, both KV-head cases, the combined, int8 and pair
  pools (the int8 one over one KV head a rank: K1q's two combined rows),
  biased q/k/v, o and MLP, and int8 weights. Hidden states within 1e-5 of
  JAX's peak in float32 (int8: the 1e-4 absolute of
  ``test_torch_weight_quant.py``); each rank's pool holds exactly its KV
  heads' rows of JAX's pool.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import Plan, _i
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.ops import kv_cache as jkv
from vox_serve_tpu.parallel.mesh import make_mesh as jmake_mesh
from vox_serve_tpu.parallel.sharding import \
    backbone_param_shardings as jshardings
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.ops import kv_cache as tkv
from vox_serve_tpu_torch.parallel import (backbone_param_shardings,
                                          make_mesh, shard_params)
from vox_serve_tpu_torch.parallel.sharding import (kv_heads_of,
                                                   shard_config, tp_heads)

torch.set_num_threads(1)

REL_TOL = 1e-5        # float32, relative to JAX's peak
INT8_ATOL = 1e-4      # test_torch_weight_quant.py's BACKBONE_ATOL


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------

MESH_CASES = [(1, None, 8), (2, None, 8), (3, None, 8), (1, 4, 8),
              (2, 4, 8), (2, 2, 5), (16, None, 8), (2, 8, 8), (1, 0, 4),
              (3, 2, 4)]


@pytest.mark.parametrize("dp,tp,n", MESH_CASES)
def test_make_mesh_matches_jax(dp, tp, n, caplog):
    jdev = jax.devices()[:n]
    tdev = [torch.device("cuda", i) for i in range(n)]
    try:
        jm = jmake_mesh(dp=dp, tp=tp, devices=jdev)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(dp=dp, tp=tp, devices=tdev)
        assert str(got.value) == str(e)
        return
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jm = jmake_mesh(dp=dp, tp=tp, devices=jdev)
        jwarn = [r.getMessage() for r in caplog.records]
        caplog.clear()
        grid = make_mesh(dp=dp, tp=tp, devices=tdev)
        twarn = [r.getMessage() for r in caplog.records]
    assert twarn == jwarn
    assert bool(jwarn) == (tp is None and n % dp != 0)
    ids = [[jdev.index(d) for d in row] for row in jm.devices.tolist()]
    assert [[d.index for d in row] for row in grid] == ids
    assert jm.axis_names == ("dp", "tp")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _jax_tree(kind):
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=64, dtype=jnp.bfloat16)
    if kind == "layer_norm":
        kw["use_layer_norm"] = True
    if kind == "bias_pos_emb":
        kw.update(qkv_bias=True, o_bias=True, mlp_bias=True,
                  use_layer_norm=True, dtype=jnp.float32)
    if kind == "qk_norm":
        kw["qk_norm"] = True
    params = jbb.init_backbone_params(jbb.BackboneConfig(**kw),
                                      jax.random.key(0))
    if kind == "int8":
        params = jbb.quantize_backbone_params(params)
    if kind == "bias_pos_emb":
        params["pos_emb"] = jnp.zeros((16, 32), jnp.float32)
    return params


@pytest.mark.parametrize("kind", ["bf16", "int8", "layer_norm", "qk_norm",
                                  "bias_pos_emb"])
def test_rules_equal_jax_partition_specs(kind):
    jp = _jax_tree(kind)
    mesh = jmake_mesh(dp=1, tp=4)
    jsh = jshardings(mesh, jp)
    tp = tparams.tree_to_torch(_np(jp), "cpu")
    rules = backbone_param_shardings(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a, s: (a.ndim, tuple(s.spec)), jp, jsh),
        is_leaf=lambda x: isinstance(x, tuple))[0]
    seen = 0
    for path, (ndim, spec) in flat_j:
        keys = [p.key for p in path]
        rule = rules
        for k in keys:
            rule = rule[k]
        want = tuple(spec) + (None,) * (ndim - len(spec))
        got = tuple("tp" if i == rule else None for i in range(ndim))
        assert got == want, (keys, got, want)
        seen += 1
    assert seen == len(tparams.tree_leaves(tp))


def test_tp_heads_kv_map_and_unsupported():
    assert tp_heads(16, 8, 4) == (4, 2)            # the flagship
    assert tp_heads(32, 2, 4) == (8, 1)            # GLM-4-Voice-9B
    assert [kv_heads_of(r, 32, 2, 4) for r in range(4)] == [[0], [0], [1],
                                                            [1]]
    assert [kv_heads_of(r, 16, 8, 4) for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    for H, KH, tp in ((16, 8, 3), (28, 4, 8), (12, 6, 4)):
        with pytest.raises(ValueError) as e:
            tp_heads(H, KH, tp)
        assert f"H={H}" in str(e.value) and f"KH={KH}" in str(e.value)
        assert f"tp={tp}" in str(e.value)
    cfg = tbb.BackboneConfig(vocab_size=8, hidden_size=64, num_layers=1,
                             num_heads=8, num_kv_heads=2,
                             intermediate_size=96)
    local = shard_config(cfg, 4)
    assert (local.num_heads, local.num_kv_heads, local.head_dim,
            local.intermediate_size) == (2, 1, 8, 24)


# ---------------------------------------------------------------------------
# shard_params
# ---------------------------------------------------------------------------


def _tree(H, KH, bias=True, seed=0, int8=False):
    cfg = tbb.BackboneConfig(vocab_size=64, hidden_size=64, num_layers=2,
                             num_heads=H, num_kv_heads=KH, head_dim=16,
                             intermediate_size=128, qkv_bias=bias,
                             o_bias=bias, mlp_bias=bias,
                             dtype=torch.float32)
    p = tbb.init_backbone_params(cfg, tbb.seeded_generator("cpu", seed),
                                 "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for leaf in tparams.tree_leaves(p):
        leaf.add_(0.1 * torch.randn(leaf.shape, generator=g))
    return tbb.quantize_backbone_params(p) if int8 else p


@pytest.mark.parametrize("tp,H,KH", [(2, 8, 4), (4, 8, 4), (4, 8, 2),
                                     (2, 8, 1), (4, 16, 8)])
@pytest.mark.parametrize("int8", [False, True])
def test_shards_put_back_give_the_whole_tree(tp, H, KH, int8):
    full = _tree(H, KH, int8=int8)
    shards = [shard_params(full, r, tp, KH) for r in range(tp)]
    rules = backbone_param_shardings(full)
    per_kv = tp // KH if KH < tp else 1

    def check(f, r, ss, path):
        if isinstance(f, dict):
            for k in f:
                check(f[k], r[k], [s[k] for s in ss], path + (k,))
            return
        if r is None:
            assert all(s is f for s in ss), path  # whole, shared
            return
        kv = path[:3] in (("layers", "attn", "k"), ("layers", "attn", "v"))
        parts = ss[::per_kv] if kv else ss
        if kv:  # the ranks that share a KV head hold the same columns
            for i, s in enumerate(ss):
                torch.testing.assert_close(s, parts[i // per_kv], rtol=0,
                                           atol=0)
        torch.testing.assert_close(torch.cat(parts, dim=r), f, rtol=0,
                                   atol=0)
        assert all(s.is_contiguous() for s in ss)

    check(full, rules, shards, ())


# ---------------------------------------------------------------------------
# the split backbone against JAX's whole one
# ---------------------------------------------------------------------------

BACKBONE_CASES = {
    # name: (tp, H, KH, layout, bias, int8)
    "tp2_kv_split": (2, 8, 4, "combined", False, False),
    "tp4_kv_split": (4, 8, 4, "combined", False, False),
    "tp4_kv_per_rank": (4, 8, 2, "combined", False, False),
    "tp2_one_kv_head": (2, 4, 1, "combined", False, False),
    "tp2_pair": (2, 8, 4, "pair", False, False),
    "tp4_pair_kv_per_rank": (4, 8, 2, "pair", False, False),
    "tp4_biases": (4, 8, 4, "combined", True, False),
    "tp2_biases_one_kv_head": (2, 4, 1, "combined", True, False),
    "tp2_int8": (2, 8, 4, "combined", True, True),
    "tp4_int8_kv_per_rank": (4, 8, 2, "combined", True, True),
    # an int8 pool: K1q's plain version over one KV head (2 rows) a rank
    "tp2_int8_pool_one_kv_head": (2, 8, 2, "int8", False, False),
    "tp4_int8_pool": (4, 8, 4, "int8", True, False),
}


def _configs(H, KH, bias):
    kw = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=H,
              num_kv_heads=KH, head_dim=16, intermediate_size=128,
              qkv_bias=bias, o_bias=bias, mlp_bias=bias, qk_norm=True,
              rope_theta=1e6)
    return (jbb.BackboneConfig(**kw, dtype=jnp.float32),
            tbb.BackboneConfig(**kw, dtype=torch.float32))


def _jax_backbone(cfg, seed):
    """JAX's tree at the case's heads, every norm and bias drawn at random
    (numpy) so that each leaf shows."""
    p = _np(jbb.init_backbone_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    lay = p["layers"]
    for k in ("input_norm", "post_norm"):
        lay[k] = (1 + 0.3 * rng.standard_normal(lay[k].shape)).astype(
            np.float32)
    for part in ("attn", "mlp"):
        for leaf in lay[part].values():
            if isinstance(leaf, dict) and "b" in leaf:
                leaf["b"] = (0.1 * rng.standard_normal(
                    leaf["b"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("case", list(BACKBONE_CASES))
def test_split_backbone_matches_jax(case):
    tp, H, KH, layout, bias, int8 = BACKBONE_CASES[case]
    jcfg, tcfg = _configs(H, KH, bias)
    jp = jax.tree.map(jnp.asarray, _jax_backbone(jcfg, seed=len(case)))
    if int8:
        jp = jbb.quantize_backbone_params(jp)
    tree = tparams.tree_to_torch(_np(jp), "cpu", torch.float32)
    shards = [shard_params(tree, r, tp, KH) for r in range(tp)]
    if int8:
        shards = [tbb.pack_backbone_params(s) for s in shards]
    plan = Plan(lens=(11, 6))
    combined = layout != "pair"
    quant = dict(quant="int8", k_amax=4.0, v_amax=4.0) \
        if layout == "int8" else {}
    jc = jkv.KVCacheConfig(2, plan.P, plan.page, KH, 16, dtype=jnp.float32,
                           combined=combined, **quant)
    jk, jv = jkv.alloc_kv_pages(jc)
    local = shard_config(tcfg, tp)
    tc = tkv.KVCacheConfig(2, plan.P, plan.page, local.num_kv_heads, 16,
                           dtype=torch.float32, combined=combined, **quant)
    pools = [tkv.alloc_kv_pages(tc, "cpu") for _ in range(tp)]
    rng = np.random.default_rng(3)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jk, jv = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), jm, jk, jv,
                                          kv_scales=jc.kv_scales)
        th = tbb.backbone_forward_shards(shards, tcfg, torch.from_numpy(x),
                                         _i(pos), [tm] * tp, pools,
                                         tc.kv_scales)
        ref = np.asarray(jh)
        err = np.abs(th.numpy() - ref).max()
        if int8:
            assert err <= INT8_ATOL, err
        else:
            assert err <= REL_TOL * np.abs(ref).max(), err
    # each rank's pool: its KV heads' rows of JAX's pool, and nothing else
    jk = np.asarray(jk).astype(np.float32)
    jv = None if jv is None else np.asarray(jv)
    tol = INT8_ATOL if int8 else REL_TOL * np.abs(jk).max()
    if layout == "int8":  # K/V from another matmul shape: one int8 step
        tol = 1.0
    for r, (tk, tv) in enumerate(pools):
        heads = kv_heads_of(r, H, KH, tp)
        if combined:
            rows = [2 * h + i for h in heads for i in (0, 1)]
            want = jk[:, :, :, rows, :16]
            assert tk.shape[3] == len(rows)
            np.testing.assert_allclose(tk.float().numpy(), want, atol=tol,
                                       rtol=0)
        else:
            np.testing.assert_allclose(tk.numpy(), jk[:, heads], atol=tol,
                                       rtol=0)
            np.testing.assert_allclose(tv.numpy(), jv[:, heads], atol=tol,
                                       rtol=0)


def test_whole_backbone_unchanged_by_the_split_path():
    """``tp=None`` and one rank of one (``backbone_forward_shards`` over
    the whole tree) give the same hidden states bit for bit, biases
    included: the row-parallel bias moves after the reduce only when a
    backbone is split."""
    tree = _tree(4, 2)
    cfg = tbb.BackboneConfig(vocab_size=64, hidden_size=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             intermediate_size=128, qkv_bias=True,
                             o_bias=True, mlp_bias=True, dtype=torch.float32)
    plan = Plan(lens=(11, 6))
    tc = tkv.KVCacheConfig(2, plan.P, plan.page, 2, 16, dtype=torch.float32,
                           combined=True)
    pool_a, pool_b = (tkv.alloc_kv_pages(tc, "cpu") for _ in range(2))
    _, tm, pos = plan.prefill()[:3]
    x = torch.randn((len(pos), 64), generator=torch.Generator().manual_seed(1))
    a = tbb.backbone_forward(tree, cfg, x, _i(pos), tm, *pool_a)
    b = tbb.backbone_forward_shards([tree], cfg, x, _i(pos), [tm], [pool_b])
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pool_a[0], pool_b[0], rtol=0, atol=0)
