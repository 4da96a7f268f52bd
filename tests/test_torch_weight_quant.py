"""Port parity, int8 weight-only quantization of the backbone matmuls
(``weight_quant="int8"``), with tests/test_weight_quant.py's JAX package
as the oracle, on the CPU at small widths:

* ``quantize_linear_params`` bit-equal to JAX's (``w_q`` and ``w_s``) on a
  stacked (L, K, N) weight in float32 and in bf16, exact round-half-even
  ties included, the bias passed through; the per-layer loop equal to a
  whole-stack quantization;
* ``quantize_backbone_params``: JAX's keys, every untouched leaf (norms,
  q/k norms, biases) the same;
* the int8 ``linear`` (over the leaf packed into K5's layout) against
  JAX's: float32 within 1e-5, bf16 within one bf16 step of the output's
  top binade, with and without a bias;
* the quantized ``backbone_forward`` (prefill and 3 decode steps over the
  paged pool) against JAX's from the same JAX parameters through
  ``params.tree_to_torch`` (which keeps ``w_s`` in float32) and
  ``pack_backbone_params``: GQA groups of 2 and 3, q/k/v biases,
  ``use_layer_norm``; float32 within 1e-4, the tolerance of the other
  backbone parity tests;
* the worker: the dummy model's backbone (packed into K5's layout, as on
  the card) under a 0.4 share of its float32 bytes and decoding, an
  unknown mode raising ``ValueError``, the flag parsed by the launcher and
  the daemon into ``WorkerConfig``, and the debug Qwen3-TTS served at int8
  by both packages' workers with the same greedy tokens, its packed
  weights unpacking to JAX's and its depth stack left unquantized as in
  JAX.

K5 itself runs only on the card: the ``cuda``-marked tests below hold it
against its plain version there, at every token tile, grouped and alone,
and inside a captured graph (``test_torch_kernels.py`` has its host plan
and wrapper checks, ``test_torch_w8a16_pack.py`` the packed layout).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_decode import _drive, _qwen3_pair
from test_torch_models import Plan, _i
from vox_serve_tpu.models import backbone as jbb
from vox_serve_tpu.requests import Request as JRequest
from vox_serve_tpu.scheduler.base import Scheduler as JScheduler
from vox_serve_tpu.worker import ModelWorker as JWorker
from vox_serve_tpu.worker import WorkerConfig as JWorkerConfig
from vox_serve_tpu_torch import launch as tlaunch
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch.models import backbone as tbb
from vox_serve_tpu_torch.models.dummy import DummyLM
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.requests import Request
from vox_serve_tpu_torch.scheduler import load_scheduler
from vox_serve_tpu_torch.scheduler_entry import build_parser as daemon_parser
from vox_serve_tpu_torch.worker import ModelWorker, WorkerConfig

torch.set_num_threads(1)
ATOL_F32 = 1e-5      # one linear: the same sum in another order
BACKBONE_ATOL = 1e-4  # the other backbone parity tests' tolerance
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(rng, shape, dtype):
    """Normal weights with exact round-half-to-even ties: in each layer's
    column 0 the largest |w| is 127, so the scale is 1.0 and the values
    k + 0.5 sit on the rounding boundary."""
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    w[..., 0, 0] = 127.0
    w[..., 1:9, 0] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return jnp.asarray(w).astype(_JNP[dtype])


def _to_torch(a):
    return tparams.to_tensor(np.asarray(a), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_linear_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    w = _weights(rng, (3, 40, 24), dtype)
    b = jnp.asarray(rng.standard_normal((3, 24)), _JNP[dtype])
    jq = jbb.quantize_linear_params({"w": w, "b": b})
    tq = tbb.quantize_linear_params({"w": _to_torch(w),
                                     "b": _to_torch(b)})
    assert set(tq) == set(jq) == {"w_q", "w_s", "b"}
    assert tq["w_q"].dtype == torch.int8 and tq["w_s"].dtype == torch.float32
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["w_s"].numpy().view(np.int32),
                                  np.asarray(jq["w_s"]).view(np.int32))
    np.testing.assert_array_equal(tq["w_q"][:, 1:9, 0].numpy()[0],
                                  [0, 2, 2, 0, -2, -2, 126, -126])
    assert tq["b"] is not None and torch.equal(tq["b"], _to_torch(b))


def test_per_layer_loop_equals_whole_stack():
    """The port quantizes a stack one layer at a time; the same formula
    over the whole stack at once gives the same bits (the scales are per
    (layer, output channel)). A 2-D weight takes the same path."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn((4, 32, 48), generator=g)
    got = tbb.quantize_linear_params({"w": w})
    s = torch.clamp_min(w.abs().amax(dim=-2), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / s[:, None, :]), -127, 127).to(torch.int8)
    assert torch.equal(got["w_q"], q) and torch.equal(got["w_s"], s)
    one = tbb.quantize_linear_params({"w": w[2]})
    assert torch.equal(one["w_q"], q[2]) and torch.equal(one["w_s"], s[2])


def _bb_cfg(pkg, H, KH, qkv_bias=False, use_ln=False, dtype="float32"):
    dt = _JNP[dtype] if pkg is jbb else getattr(torch, dtype)
    return pkg.BackboneConfig(
        vocab_size=64, hidden_size=64, num_layers=2, num_heads=H,
        num_kv_heads=KH, head_dim=16, intermediate_size=128,
        qkv_bias=qkv_bias, qk_norm=not use_ln, use_layer_norm=use_ln,
        rms_eps=1e-5, dtype=dt)


def _jax_params(cfg, seed):
    """JAX's init with every norm, norm bias and linear bias drawn at
    random, so that each untouched leaf shows."""
    p = _np(jbb.init_backbone_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def draw(a, base):
        return (base + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)

    lay = p["layers"]
    for k in ("input_norm", "post_norm", "input_norm_b", "post_norm_b"):
        if k in lay:
            lay[k] = draw(lay[k], 0.0 if k.endswith("_b") else 1.0)
    for k in ("q_norm", "k_norm"):
        if k in lay["attn"]:
            lay["attn"][k] = draw(lay["attn"][k], 1.0)
    for k in ("q", "k", "v"):
        if "b" in lay["attn"][k]:
            lay["attn"][k]["b"] = draw(lay["attn"][k]["b"], 0.0)
    for k in ("final_norm", "final_norm_b"):
        if k in p:
            p[k] = draw(p[k], 0.0 if k.endswith("_b") else 1.0)
    return jax.tree.map(jnp.asarray, p)


def test_quantized_tree_matches_jax():
    jcfg = _bb_cfg(jbb, 6, 2, qkv_bias=True)
    jp = _jax_params(jcfg, 3)
    jq = _np(jbb.quantize_backbone_params(jp))
    tp = tparams.tree_to_torch(_np(jp), "cpu", torch.float32)
    tq = tbb.quantize_backbone_params(tp)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, jq))
            == jax.tree.structure(tparams.tree_map(lambda t: 0, tq)))
    jax.tree.map(lambda a, t: np.testing.assert_array_equal(t.numpy(), a),
                 jq, tq)
    # untouched leaves are the input's tensors; the bf16 stacks are gone
    assert tq["layers"]["input_norm"] is tp["layers"]["input_norm"]
    assert tq["layers"]["attn"]["q_norm"] is tp["layers"]["attn"]["q_norm"]
    assert tq["layers"]["attn"]["q"]["b"] is tp["layers"]["attn"]["q"]["b"]
    for name in ("q", "k", "v", "o"):
        assert "w" not in tq["layers"]["attn"][name]
    assert set(tq["layers"]["mlp"]["down"]) == {"w_q", "w_s"}
    assert "w" in tp["layers"]["mlp"]["down"]  # the input is not changed


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(dtype, bias):
    rng = np.random.default_rng(2)
    p = {"w": _weights(rng, (96, 80), dtype)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(80), _JNP[dtype])
    jq = jbb.quantize_linear_params(p)
    x = jnp.asarray(rng.standard_normal((7, 96)), _JNP[dtype])
    ref = np.asarray(jbb.linear(jq, x).astype(jnp.float32))
    tq = tparams.tree_to_torch(_np(jq), "cpu", getattr(torch, dtype))
    assert tq["w_s"].dtype == torch.float32 and tq["w_q"].dtype == torch.int8
    tx = tparams.to_tensor(np.asarray(x), "cpu")
    tq["w_p"] = kernels.pack_w8a16(tq.pop("w_q"))  # the tree the port runs
    got = tbb.linear(tq, tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=ATOL_F32, rtol=0)
    else:
        # one bf16 step of the top binade: the bf16 product rounds a sum
        # taken in another order, and the scale and bias round after it
        step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= step
    assert np.abs(got - np.asarray(jbb.linear(p, x).astype(
        jnp.float32))).max() > 0  # actually quantized


CASES = {"g2": dict(H=4, KH=2), "g3_qkv_bias": dict(H=6, KH=2, qkv_bias=True),
         "layer_norm": dict(H=4, KH=2, use_ln=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_backbone_matches_jax(case):
    kw = CASES[case]
    jcfg, tcfg = _bb_cfg(jbb, **kw), _bb_cfg(tbb, **kw)
    jq = jbb.quantize_backbone_params(_jax_params(jcfg, 5))
    tq = tbb.pack_backbone_params(  # the tree the port runs
        tparams.tree_to_torch(_np(jq), "cpu", torch.float32))
    assert tq["layers"]["mlp"]["gate"]["w_s"].dtype == torch.float32
    plan = Plan(lens=(11, 6))
    shape = (2, plan.P, plan.page, 2 * kw["KH"], 16)
    jpool, tpool = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    rng = np.random.default_rng(7)
    steps = [plan.prefill()[:3]] + [plan.decode() for _ in range(3)]
    for jm, tm, pos in steps:
        x = rng.standard_normal((len(pos), 64)).astype(np.float32)
        jh, jpool, _ = jbb.backbone_forward(jq, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos), jm, jpool, None)
        th = tbb.backbone_forward(tq, tcfg, torch.from_numpy(x), _i(pos), tm,
                                  tpool)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                                   atol=BACKBONE_ATOL, rtol=0)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                   atol=BACKBONE_ATOL, rtol=0)


def _backbone_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in tparams.tree_leaves(model.params["backbone"]))


def test_dummy_worker_int8_quarter_bytes_and_decodes():
    base = _backbone_bytes(DummyLM())
    model = DummyLM()
    worker = ModelWorker(model, WorkerConfig(
        max_batch_size=2, num_pages=64, page_size=16, weight_quant="int8"))
    # f32 dev model: int8 weights (the k / v projections padded to 64
    # features by the pack) + f32 scales ~ 1/3 of the matmul bytes; the
    # norms stay f32. Under 40% shows the transform really applied.
    assert _backbone_bytes(model) < 0.4 * base
    assert worker.backbone_bytes() == _backbone_bytes(model)
    up = model.params["backbone"]["layers"]["mlp"]["up"]
    assert set(up) == {"w_p", "w_s"} and up["w_p"].dtype == torch.int8
    req = Request(request_id="wq", prompt="hello world")
    worker.run_lm_prefill([req])
    for _ in range(4):
        if req.done_lm_generation:
            break
        worker.run_lm_decode([req])
    worker.free_kv_cache(req)
    assert len(req.lm_output_tokens) >= 2
    assert kernels.w8a16_linear.launches == 0  # the CPU runs the plain one


def test_unknown_weight_quant_raises():
    with pytest.raises(ValueError, match="unknown weight_quant 'int4'"):
        ModelWorker(DummyLM(), WorkerConfig(max_batch_size=2, num_pages=64,
                                            weight_quant="int4"))


def test_weight_quant_flag_reaches_the_worker_config():
    args = daemon_parser().parse_args(["--model", "dummy",
                                       "--weight-quant", "int8"])
    assert args.weight_quant == "int8"
    assert daemon_parser().parse_args(["--model", "dummy"]).weight_quant \
        is None  # the worker's default, as in JAX
    with pytest.raises(SystemExit):
        daemon_parser().parse_args(["--model", "dummy", "--weight-quant",
                                    "int4"])
    largs = tlaunch.build_parser().parse_args(["--weight-quant", "int8"])
    assert largs.weight_quant == "int8"
    assert '"weight_quant": args.weight_quant' in inspect.getsource(
        tlaunch.main)
    from vox_serve_tpu_torch import scheduler_entry

    src = inspect.getsource(scheduler_entry)
    assert '{"weight_quant": args.weight_quant}' in src
    assert '"weight_quant": wcfg.weight_quant' in src
    assert WorkerConfig().weight_quant == JWorkerConfig().weight_quant \
        == "none"


def _unpacked(tree):
    """A packed backbone tree with each ``w_p`` unpacked to JAX's
    ``w_q`` (K from the layer's input width, N from the scales)."""
    out = tparams.tree_map(lambda t: t, tree)
    lay = out["layers"]
    for part, names in tbb.LINEAR_GROUPS:
        for n in names:
            leaf = lay[part][n]
            K = (lay["input_norm"].shape[-1] if n != "down"
                 else lay["mlp"]["gate"]["w_s"].shape[-1])
            if n == "o":
                K = lay["attn"]["q"]["w_s"].shape[-1]
            leaf["w_q"] = kernels.unpack_w8a16(leaf.pop("w_p"), K,
                                               leaf["w_s"].shape[-1])
    return out


def test_qwen3_int8_workers_match_jax_and_keep_the_depth_stack():
    """The debug Qwen3-TTS at int8 in both packages' workers: the same
    greedy tokens over a prefill and decode steps, the top-level backbone
    quantized and the depth stack (``params["depth"]["backbone"]``) not."""
    jm, tm = _qwen3_pair(max_tokens=24)
    depth = dict(tm.params["depth"]["backbone"]["layers"]["mlp"]["up"])
    kw = dict(max_batch_size=2, num_pages=400, page_size=8,
              max_prefill_requests=2, weight_quant="int8")
    jw = JWorker(jm, JWorkerConfig(prefill_token_buckets=(128,),
                                   warmup=False, **kw))
    tw = ModelWorker(tm, WorkerConfig(prefill_token_buckets=(128,), **kw))
    tmlp = tm.params["backbone"]["layers"]["mlp"]["up"]
    # JAX's worker quantizes under jit, where XLA turns the division by 127
    # into a product with its reciprocal: scales within one float32 step
    # of the eager formula the port follows, int8 values within one
    # (the port's leaves unpacked from K5's layout to JAX's w_q)
    jax.tree.map(lambda a, t: np.testing.assert_allclose(
        t.numpy().astype(np.float64), a.astype(np.float64),
        rtol=2.0 ** -23, atol=1 if a.dtype == np.int8 else 0),
        _np(jm.params["backbone"]), _unpacked(tm.params["backbone"]))
    assert set(tmlp) == {"w_p", "w_s"}
    dup = tm.params["depth"]["backbone"]["layers"]["mlp"]["up"]
    assert set(dup) == {"w"} and dup["w"] is depth["w"]
    assert "w" in jm.params["depth"]["backbone"]["layers"]["mlp"]["up"]
    prompts = ("hi", "hello!")
    jreqs = [JRequest(request_id=f"j{i}", prompt=p)
             for i, p in enumerate(prompts)]
    treqs = [Request(request_id=f"t{i}", prompt=p)
             for i, p in enumerate(prompts)]
    _drive(JScheduler(model_worker=jw, max_batch_size=2, connect=False),
           jreqs)
    _drive(load_scheduler("base", model_worker=tw, max_batch_size=2,
                          connect=False), treqs)
    for j, t in zip(jreqs, treqs):
        assert j.done_all and t.done_all
        assert len(t.lm_output_tokens) > 4
        np.testing.assert_array_equal(np.stack(t.lm_output_tokens),
                                      np.stack(j.lm_output_tokens))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: K5 against its plain version, relative to max |ref|: both round the
#: float32 sum, the product with the bf16 scale and the bias sum to bf16 at
#: the same points; another float32 sum order flips a rounding by one bf16
#: step (2^-7 of the top binade) and a flipped sum can carry one more step
#: through the scale: 2^-6
K5_REL_TOL = 2.0 ** -6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda")


def _k5_case(dev, M, K, N, bias, seed=0, layers=1, layer=0):
    """(x, packed weight, scales, bias) on ``dev``; the weight is layer
    ``layer`` of a packed stack of ``layers``."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((layers, K, N), generator=g) * K ** -0.5
    q = tbb.quantize_linear_params({"w": w})
    x = torch.randn((M, K), generator=g).to(torch.bfloat16)
    b = torch.randn((N,), generator=g).to(torch.bfloat16) if bias else None
    to = (lambda t: None if t is None else t.to(dev))
    return (to(x), to(kernels.pack_w8a16(q["w_q"]))[layer],
            to(q["w_s"])[layer], to(b))


def _assert_k5_close(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    rel = ((out.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= K5_REL_TOL, rel


#: every token tile and its edges, split and unsplit, past one tile
K5_CARD_ROWS = [1, 4, 8, 16, 17, 32, 64, 168, 256, 257, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("M", K5_CARD_ROWS)
@pytest.mark.parametrize("K,ns,bias", [
    (256, (512,), True), (200, (300,), False), (264, (272,), True),
    (1024, (96,), False), (3072, (3072, 1024, 1024), False),
    (1024, (4096, 4096), True), (896, (896, 128, 128), True),
    (64, (5, 64, 8), True)])
def test_k5_matches_plain_on_card(cuda_device, M, K, ns, bias):
    """The swap-AB plan at every token tile (8 to 256 tokens, several
    tiles past 256 rows), split and not, grouped (q/k/v, gate/up shapes)
    and alone, K and N tails padded by the pack, a bias and none, a layer
    view at an offset (layer 1 of a stack); one launch per call."""
    cases = [_k5_case(cuda_device, M, K, n, bias, seed=i, layers=2, layer=1)
             for i, n in enumerate(ns)]
    x = cases[0][0]
    leaves = [c[1:] for c in cases]
    before = dict(kernels.counters())
    outs = kernels.w8a16_linear_group(x, leaves)
    after = kernels.counters()
    assert after[("w8a16_linear", "launches")] == \
        before[("w8a16_linear", "launches")] + 1
    assert after[("w8a16_linear", "grouped")] == \
        before[("w8a16_linear", "grouped")] + (len(ns) > 1)
    for out, lv in zip(outs, leaves):
        _assert_k5_close(out, kernels.w8a16_linear_plain(x, *lv))
    if len(ns) == 1:
        _assert_k5_close(kernels.w8a16_linear(x, *leaves[0]),
                         kernels.w8a16_linear_plain(x, *leaves[0]))


@pytest.mark.cuda
def test_k5_instances_fit_the_planned_ctas_per_sm(cuda_device):
    """Every token tile's instance fits the CTAs an SM its registers are
    capped for (two up to 32 tokens, one above: csrc/w8a16_linear.cu's
    instance table)."""
    lib = kernels.library()
    for bm in kernels.W8A16_TOKEN_TILES:
        planned = 2 if bm <= kernels.W8A16_TWO_PER_SM else 1
        assert lib.vox_w8a16_occupancy(bm) >= planned, bm
    assert lib.vox_w8a16_occupancy(24) == -1  # no such instance


@pytest.mark.cuda
def test_k5_scratch_shared_and_in_a_captured_graph(cuda_device):
    """One W8A16Scratch serves split launches of growing and shrinking
    shape, grouped and alone, at decode and prefill rows, eagerly and
    inside a captured CUDA graph, and the replays give the same bits as
    the eager calls (no float atomics)."""
    groups = [(3072, (3072, 1024, 1024)), (3072, (3072,)),
              (1024, (4096, 4096)), (4096, (1024,))]
    scratch = kernels.W8A16Scratch(cuda_device, groups)
    cases = []
    for i, (M, (K, ns)) in enumerate(zip((4, 1, 64, 168), groups)):
        cs = [_k5_case(cuda_device, M, K, n, True, seed=10 * i + j)
              for j, n in enumerate(ns)]
        cases.append((cs[0][0], [c[1:] for c in cs]))
    splits = kernels.w8a16_linear.split
    eager = [kernels.w8a16_linear_group(x, lv, scratch) for x, lv in cases]
    assert kernels.w8a16_linear.split - splits == 4  # every one split
    for outs, (x, lv) in zip(eager, cases):
        for out, leaf in zip(outs, lv):
            _assert_k5_close(out, kernels.w8a16_linear_plain(x, *leaf))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [kernels.w8a16_linear_group(x, lv, scratch) for x, lv in cases]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernels.w8a16_linear_group(x, lv, scratch)
                for x, lv in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(outs, eager):
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
    assert not scratch.counters.any()  # left at zero for the next launch


@pytest.mark.cuda
def test_k5_rejects_what_it_cannot_take_on_card(cuda_device):
    x, w_p, s, b = _k5_case(cuda_device, 4, 64, 32, True)
    for bad in (dict(x=x.float()), dict(w_p=w_p.to(torch.int16)),
                dict(s=s.to(torch.bfloat16)), dict(b=b.float()),
                dict(x=x[:, :32]), dict(w_p=w_p[:, :, :2048])):
        args = {**dict(x=x, w_p=w_p, s=s, b=b), **bad}
        with pytest.raises(ValueError):
            kernels.w8a16_linear(args["x"], args["w_p"], args["s"],
                                 args["b"])
    with pytest.raises(ValueError, match="4 linears"):
        kernels.w8a16_linear_group(x, [(w_p, s, b)] * 4)
    tiny = kernels.W8A16Scratch(cuda_device, [(64, (32,))])  # one split
    x2, w2, s2, b2 = _k5_case(cuda_device, 4, 4096, 256, False)
    with pytest.raises(ValueError, match="too small"):
        kernels.w8a16_linear(x2, w2, s2, b2, scratch=tiny)
