"""Port parity, the Zonos backbone (vox_serve_tpu_torch/models/backbone.py
``use_layer_norm`` and weights.py ``load_zonos_backbone``) against the
JAX package, on the CPU at the JAX Zonos test's small widths (2 layers, 64
wide, 4 query heads over 4 KV heads at head dim 16):

* the LayerNorm backbone (input, post-attention and final norms with
  random weights and biases, at eps 1e-5) over a two-segment prefill and
  three decode steps: hidden states and the K/V written to the pool
  within 1e-4 in float32 (the same tolerance as the other backbones);
* the init's tree equal in keys and shapes to JAX's, with and without
  ``use_layer_norm`` (an RMSNorm config gains no bias leaf), and an
  RMSNorm config's hidden states still JAX's;
* ``load_zonos_backbone`` on the exporter's state (the published names:
  fused ``mixer.in_proj``, ``mlp.fc1`` up-then-gate, ``norm`` / ``norm2``
  / ``norm_f`` with biases) leaf for leaf equal to JAX's loader, in bf16
  and float32; an ``in_proj`` of another row count raises, naming both
  counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_checkpoints as synth
from test_torch_models import Plan, _i
from test_torch_weights import assert_trees_equal
from vox_serve_tpu import weights as jweights
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch import weights
from vox_serve_tpu_torch.models import backbone as tbb

torch.set_num_threads(1)
ATOL = 1e-4
BB = dict(vocab_size=1025, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=4, head_dim=16, intermediate_size=128, rms_eps=1e-5)


def _params(use_ln: bool, seed: int = 5) -> dict:
    """The port's init with every norm weight and bias drawn at random (so
    that the bias and the affine both show)."""
    cfg = tbb.BackboneConfig(**BB, use_layer_norm=use_ln,
                             dtype=torch.float32)
    p = tbb.init_backbone_params(cfg, tbb.seeded_generator("cpu", seed),
                                 "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    norms = [(p["layers"], k) for k in ("input_norm", "post_norm",
                                        "input_norm_b", "post_norm_b")]
    norms += [(p, "final_norm"), (p, "final_norm_b")]
    for d, k in norms:
        if k in d:
            base = 0.0 if k.endswith("_b") else 1.0
            d[k] = base + 0.3 * torch.randn(d[k].shape, generator=g)
    return p


def _jax(tree):
    return jax.tree.map(jnp.asarray, tparams.tree_map(lambda t: t.numpy(),
                                                      tree))


@pytest.mark.parametrize("use_ln", [True, False])
def test_backbone_prefill_and_decode_match_jax(use_ln):
    jcfg = jbb.BackboneConfig(**BB, use_layer_norm=use_ln, dtype=jnp.float32)
    tcfg = tbb.BackboneConfig(**BB, use_layer_norm=use_ln,
                              dtype=torch.float32)
    tp = _params(use_ln)
    jp = _jax(tp)
    plan = Plan(lens=(11, 6))
    shape = (2, plan.P, plan.page, 2 * BB["num_kv_heads"], BB["head_dim"])
    jpool, tpool = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(7)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool, None)
        th = tbb.backbone_forward(tp, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tpool)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                   atol=ATOL)


@pytest.mark.parametrize("use_ln", [True, False])
def test_init_tree_matches_jax(use_ln):
    """The port's init has JAX's keys and shapes: the three bias leaves
    under ``use_layer_norm``, none without."""
    jp = jbb.init_backbone_params(
        jbb.BackboneConfig(**BB, use_layer_norm=use_ln, dtype=jnp.float32),
        jax.random.key(0))
    tp = tbb.init_backbone_params(
        tbb.BackboneConfig(**BB, use_layer_norm=use_ln, dtype=torch.float32),
        torch.Generator().manual_seed(0), "cpu")
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, jp))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, tp)))
    jax.tree.map(lambda a, t: a.shape == tuple(t.shape) or pytest.fail(
        "shape"), jp, tp)
    biases = {"input_norm_b", "post_norm_b"} & set(tp["layers"])
    assert bool(biases) == use_ln and ("final_norm_b" in tp) == use_ln
    if use_ln:
        assert all(not tp["layers"][k].any() for k in biases)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_zonos_mapper_matches_jax(tmp_path, dt):
    src = _params(True, seed=9)
    state = synth.export_zonos_backbone(src)
    weights.save_safetensors({k: v.to(getattr(torch, dt))
                              for k, v in state.items()},
                             tmp_path / "model.safetensors")
    L, H, KH, D = (BB[k] for k in ("num_layers", "num_heads",
                                   "num_kv_heads", "head_dim"))
    got = weights.load_zonos_backbone(
        weights.load_safetensors_state(tmp_path), L, H, KH, D,
        dtype=getattr(torch, dt), device="cpu")
    ref = jweights.load_zonos_backbone(
        jweights.load_safetensors_state(tmp_path), L, H, KH, D,
        dtype=getattr(jnp, dt))
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    if dt == "float32":  # the exporter inverts the mapper
        assert_trees_equal(got, tparams.tree_map(lambda t: t.numpy(), src))


def test_in_proj_row_count_is_named(tmp_path):
    """16 query heads over 16 KV heads expect (16 + 32) x 128 rows; a
    checkpoint with fewer KV heads does not split, and the error names
    both counts."""
    state = synth.export_zonos_backbone(_params(True))
    with pytest.raises(ValueError, match=r"has 192 rows, expected .* = 256"):
        weights.load_zonos_backbone(state, 2, 4, 6, 16, device="cpu")
