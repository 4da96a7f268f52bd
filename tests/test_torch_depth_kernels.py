"""K6, the depth transformer's layer kernels (ops/kernels.py, csrc/
depth_layer.cu), and how ``depth_forward`` picks them.

On the CPU: the dispatch (the plain versions on the CPU; off the CPU the
wrappers for every shape, which raise on one they refuse), and what each
wrapper takes and refuses. On the card only (marker ``cuda``; skipped where
CUDA is unavailable): each kernel against its plain version at Qwen3-TTS's
depth shapes (G = 2, 17 positions, q/k norm) and CSM's (G = 4, 33
positions, none) over B in {1, 8, 16, 128}, t in {1, 2} and every start
position; and ``Qwen3TTSLM.depth_step`` fused against plain, each inside a
captured CUDA graph, with every codebook's logits teacher-forced on the
plain path's ids. This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_depth_kernels.py -q

Tolerances on the card: the kernels round where the plain versions round,
but sum in another order than PyTorch's reductions and cuBLAS, so an f32
result may differ in its last bits and a bf16 output by one step of its
own magnitude (at most ``BF16_STEP`` of it); where an output is a
difference of larger terms (the rotary, attention's weighted sum) that
step is taken of the largest term (``_close``). Through a whole depth step
such steps reach the logits: teacher-forced on the same ids, the fused
path's logits of each row and codebook lie within ``LOGIT_REL`` of the
plain path's (relative, by norm) and within ``LOGIT_ABS`` of the row's
largest logit (element by element); running free, a greedy codebook may
differ only where the plain path's best two logits lie within
``NEAR_TIE`` of each other.
"""

import math

import pytest
import torch

from vox_serve_tpu_torch.models.depth import (DepthConfig, depth_forward,
                                              init_depth_kv,
                                              init_depth_params)
from vox_serve_tpu_torch.ops import kernels
from vox_serve_tpu_torch.params import tree_map

torch.set_num_threads(1)
bf16 = torch.bfloat16

#: the depth stacks of the served models: Qwen3-TTS-12Hz-1.7B's code
#: predictor and CSM-1B's depth decoder
QWEN3 = DepthConfig(hidden_size=1024, num_layers=5, num_heads=16,
                    num_kv_heads=8, head_dim=128, intermediate_size=3072,
                    max_seq=17, qk_norm=True, rope_theta=1_000_000.0)
CSM = DepthConfig(hidden_size=1024, num_layers=4, num_heads=8,
                  num_kv_heads=2, head_dim=128, intermediate_size=8192,
                  max_seq=33, rope_theta=500_000.0)
CONFIGS = {"qwen3": QWEN3, "csm": CSM}
BATCHES = (1, 8, 16, 128)
#: the largest bf16 step relative to the value it is a step of (8 bits of
#: precision: 2^-8 of a value at the top of its binade, 2^-7 at the bottom)
BF16_STEP = 2.0 ** -7
#: the fused path's logits against the plain path's, teacher-forced on the
#: same ids: by norm, relative, per row and codebook (two bf16 steps: the
#: logits are the f32 product of a bf16 hidden that carries one-step
#: differences through 15 forwards of 5 layers and their caches), and
#: element by element, relative to the row's largest |logit|
LOGIT_REL = 2.0 ** -6
LOGIT_ABS = 2.0 ** -5
#: a greedy choice the two paths may make differently: the plain path's
#: logit of the fused path's token within this of its best (the depth
#: stack's logits spread ~0.64 at random init, their best two lie ~0.1
#: apart at the median)
NEAR_TIE = 0.02


def _small(head_dim=128, qk_norm=True, dtype=bf16):
    return DepthConfig(hidden_size=64, num_layers=2, num_heads=4,
                       num_kv_heads=2, head_dim=head_dim,
                       intermediate_size=96, max_seq=17, qk_norm=qk_norm,
                       rope_theta=1e6, dtype=dtype)


def _frame(cfg, B, device="cpu", seed=0):
    """Params, caches and the forwards of one frame: two tokens at 0, then
    one each at 2, 3, 4 (as a depth step feeds them)."""
    g = torch.Generator().manual_seed(seed)
    p = init_depth_params(cfg, g, "cpu")
    xs = [torch.randn((B, 2 if i == 0 else 1, cfg.hidden_size),
                      generator=g).to(cfg.dtype) for i in range(4)]
    kc, vc = init_depth_kv(cfg, B, "cpu")
    to = (lambda a: a.to(device))
    return (tree_map(to, p), [to(x) for x in xs], to(kc), to(vc))


def _run_frame(cfg, p, xs, kc, vc):
    return [depth_forward(p, cfg, x, 0 if i == 0 else i + 1, kc, vc)
            for i, x in enumerate(xs)]


def _spy(monkeypatch):
    """Wrap the four K6 wrappers; returns their call counts by name."""
    calls = {}
    for name in ("depth_add_rms_norm", "depth_qkv_rope", "depth_attention",
                 "depth_silu_mul"):
        fn = getattr(kernels, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernels, name, spy)
    return calls


SMALL = {"k6": _small(), "head_dim16": _small(head_dim=16),
         "float32": _small(dtype=torch.float32)}


@pytest.mark.parametrize("name", SMALL)
def test_depth_forward_runs_the_plain_versions_on_cpu(name, monkeypatch):
    """On the CPU every forward runs the plain versions, whatever its shape
    and type: no wrapper is called and no launch counted."""
    cfg = SMALL[name]
    p, xs, kc, vc = _frame(cfg, 3)
    before = kernels.launch_counts()
    calls = _spy(monkeypatch)
    out = _run_frame(cfg, p, xs, kc, vc)
    assert calls == {}
    monkeypatch.undo()
    assert kernels.launch_counts() == before
    assert out[-1].shape == (3, cfg.hidden_size)
    assert all(torch.isfinite(o.float()).all() for o in out)


@pytest.mark.parametrize("name,match", [
    ("k6", "no K6 kernel for device meta"),
    ("head_dim16", "no K6 kernel for device meta"),
    ("float32", "has dtype torch.float32")])
def test_depth_forward_off_the_cpu_calls_k6(name, match, monkeypatch):
    """Off the CPU (meta tensors here) every forward goes to K6's wrappers,
    whatever its shape and type: nothing runs plain. The first, the input
    norm, raises: on its dtype check, or past its checks for want of a
    kernel on that device."""
    cfg = SMALL[name]
    p, xs, kc, vc = _frame(cfg, 2, device="meta")
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match=match):
        depth_forward(p, cfg, xs[0], 0, kc, vc)
    assert calls == {"depth_add_rms_norm": 1}


def _refuses(fn, *args):
    """fn raises on its own checks, before it looks for a kernel."""
    with pytest.raises(ValueError) as e:
        fn(*args)
    assert "no K6 kernel" not in str(e.value), e.value


def _good_args():
    h = torch.zeros((2, 1, 64), dtype=bf16)
    qkv, nw, kc = _rope_case()
    return {
        "depth_add_rms_norm": (h, h.clone(), torch.ones((64,), dtype=bf16)),
        "depth_qkv_rope": (qkv, nw, nw, kc, kc.clone(), 3, 1e6),
        "depth_attention": (torch.zeros((2, 1, 4, 128), dtype=bf16), kc,
                            kc.clone(), 3),
        "depth_silu_mul": (torch.zeros((2, 96), dtype=bf16),),
    }


@pytest.mark.parametrize("name", ["depth_add_rms_norm", "depth_qkv_rope",
                                  "depth_attention", "depth_silu_mul"])
def test_wrapper_takes_good_inputs_up_to_the_device(name):
    """Inputs a wrapper takes pass all its checks: on the CPU it then
    raises for want of a kernel, and counts nothing."""
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="no K6 kernel for device cpu"):
        getattr(kernels, name)(*_good_args()[name])
    assert kernels.launch_counts() == before


def _bad_norm_args():
    h = torch.zeros((4, 64), dtype=bf16)
    w = torch.ones((64,), dtype=bf16)
    return [
        ("h float32", (h.float(), None, w)),
        ("h not contiguous", (torch.zeros((64, 4), dtype=bf16).t(), None,
                              w)),
        ("r shape", (h, torch.zeros((4, 32), dtype=bf16), w)),
        ("r float32", (h, h.float(), w)),
        ("w shape", (h, None, torch.ones((32,), dtype=bf16))),
        ("width not 8-aligned", (torch.zeros((4, 60), dtype=bf16), None,
                                 torch.ones((60,), dtype=bf16))),
        ("w float32", (h, None, w.float())),
        ("r on another device", (h, torch.zeros((4, 64), dtype=bf16,
                                                device="meta"), w)),
    ]


@pytest.mark.parametrize("case", _bad_norm_args(), ids=lambda c: c[0])
def test_add_rms_norm_wrapper_refuses(case):
    _refuses(kernels.depth_add_rms_norm, *case[1])


def _rope_case(B=2, t=1, H=4, KH=2, D=128, S=17):
    qkv = torch.zeros((B, t, (H + 2 * KH) * D), dtype=bf16)
    kc = torch.zeros((B, S, KH, D), dtype=bf16)
    nw = torch.ones((D,), dtype=bf16)
    return qkv, nw, kc


def _bad_rope_args():
    qkv, nw, kc = _rope_case()
    q64, nw64, kc64 = _rope_case(D=64)
    return [
        ("qkv float32", (qkv.float(), nw, nw, kc, kc.clone(), 0)),
        ("cache float32", (qkv, nw, nw, kc.float(), kc.float(), 0)),
        ("cache not contiguous", (qkv, nw, nw, kc.transpose(1, 2),
                                  kc.transpose(1, 2), 0)),
        ("head dim 64", (q64, nw64, nw64, kc64, kc64.clone(), 0)),
        ("cache batch", (qkv, nw, nw, kc[:1].contiguous(),
                         kc[:1].contiguous(), 0)),
        ("q_norm alone", (qkv, nw, None, kc, kc.clone(), 0)),
        ("norm shape", (qkv, nw[:64], nw[:64], kc, kc.clone(), 0)),
        ("past the cache", (qkv, nw, nw, kc, kc.clone(), 17)),
        ("v_cache shape", (qkv, nw, nw, kc, kc[:, :16].contiguous(), 0)),
        ("before the cache", (qkv, nw, nw, kc, kc.clone(), -1)),
    ]


@pytest.mark.parametrize("case", _bad_rope_args(), ids=lambda c: c[0])
def test_qkv_rope_wrapper_refuses(case):
    qkv, qn, kn, kc, vc, pos = case[1]
    _refuses(kernels.depth_qkv_rope, qkv, qn, kn, kc, vc, pos, 1e6)


def _bad_attention_args():
    q = torch.zeros((2, 1, 4, 128), dtype=bf16)
    kc = torch.zeros((2, 17, 2, 128), dtype=bf16)
    return [
        ("q float32", (q.float(), kc, kc, 0)),
        ("q not contiguous", (q.transpose(2, 3).contiguous().transpose(2, 3),
                              kc, kc, 0)),
        ("v shape", (q, kc, kc[:, :16].contiguous(), 0)),
        ("G = 16", (torch.zeros((2, 1, 32, 128), dtype=bf16), kc, kc, 0)),
        ("three new tokens", (torch.zeros((2, 3, 4, 128), dtype=bf16), kc,
                              kc, 0)),
        ("a cache of 65", (q, torch.zeros((2, 65, 2, 128), dtype=bf16),
                           torch.zeros((2, 65, 2, 128), dtype=bf16), 0)),
        ("past the cache", (q, kc, kc, 17)),
        ("head dim 64", (torch.zeros((2, 1, 4, 64), dtype=bf16),
                         torch.zeros((2, 17, 2, 64), dtype=bf16),
                         torch.zeros((2, 17, 2, 64), dtype=bf16), 0)),
        ("cache batch", (q, kc[:1].contiguous(), kc[:1].contiguous(), 0)),
    ]


@pytest.mark.parametrize("case", _bad_attention_args(), ids=lambda c: c[0])
def test_attention_wrapper_refuses(case):
    _refuses(kernels.depth_attention, *case[1])


@pytest.mark.parametrize("gu", [
    torch.zeros((4, 96)), torch.zeros((4, 200), dtype=bf16)[:, :96],
    torch.zeros((4, 88), dtype=bf16), torch.zeros((4, 0), dtype=bf16)],
    ids=["float32", "not contiguous", "intermediate not 8-aligned",
         "empty"])
def test_silu_mul_wrapper_refuses(gu):
    _refuses(kernels.depth_silu_mul, gu)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda")


def _steps(a, b):
    """The distance between two bf16 tensors in representable values."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def _close(got, want, scale):
    """|got - want| within one bf16 step of ``scale`` (the largest term
    the output was summed from) plus one of the value itself."""
    g, w = got.float(), want.float()
    tol = BF16_STEP * (w.abs() + scale)
    bad = (g - w).abs() > tol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} beyond one bf16 step: max "
        f"{(g - w).abs().max().item()} at scale {scale}")


def _plain_on_card(monkeypatch):
    """Put the plain versions in place of K6's wrappers, so that
    ``depth_forward`` runs its plain body on the card, until
    ``monkeypatch.undo()`` (the launch counters read the wrappers by
    name: read them after it)."""
    for name in ("depth_add_rms_norm", "depth_qkv_rope", "depth_attention",
                 "depth_silu_mul"):
        monkeypatch.setattr(kernels, name, getattr(kernels, name + "_plain"))


def _rand(g, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(bf16).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("t", (1, 2))
def test_k6a_add_rms_norm_matches_plain_on_card(cuda_device, name, B, t):
    cfg = CONFIGS[name]
    g = torch.Generator().manual_seed(B * 10 + t)
    C = cfg.hidden_size
    h = _rand(g, (B, t, C), cuda_device)
    r = _rand(g, (B, t, C), cuda_device, 0.5)
    w = _rand(g, (C,), cuda_device, 0.1) + 1
    for res in (None, r):
        got_h, got = kernels.depth_add_rms_norm(h, res, w, cfg.rms_eps)
        want_h, want = kernels.depth_add_rms_norm_plain(h, res, w,
                                                        cfg.rms_eps)
        torch.cuda.synchronize()
        assert torch.equal(got_h, want_h)
        assert int(_steps(got, want).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("t", (1, 2))
def test_k6b_qkv_rope_matches_plain_on_card(cuda_device, name, B, t):
    """Every start position: q, the written k and v rows, and every other
    cache row untouched."""
    cfg = CONFIGS[name]
    H, KH, D, S = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                   cfg.max_seq)
    g = torch.Generator().manual_seed(B * 10 + t)
    qkv = _rand(g, (B, t, (H + 2 * KH) * D), cuda_device, 4.0)
    qn = kn = None
    if cfg.qk_norm:
        qn = _rand(g, (D,), cuda_device, 0.1) + 1
        kn = _rand(g, (D,), cuda_device, 0.1) + 1
    kc0 = _rand(g, (B, S, KH, D), cuda_device)
    vc0 = _rand(g, (B, S, KH, D), cuda_device)
    # the largest term a rotated value is a difference of
    for pos in range(S - t + 1):
        kc, vc, kp, vp = kc0.clone(), vc0.clone(), kc0.clone(), vc0.clone()
        got = kernels.depth_qkv_rope(qkv, qn, kn, kc, vc, pos,
                                     cfg.rope_theta, cfg.rms_eps)
        want = kernels.depth_qkv_rope_plain(qkv, qn, kn, kp, vp, pos,
                                            cfg.rope_theta, cfg.rms_eps)
        torch.cuda.synchronize()
        # a rotated value is a difference of two products of its pair
        scale = 2 * float(want.float().abs().max())
        _close(got, want, scale)
        _close(kc[:, pos:pos + t], kp[:, pos:pos + t], scale)
        assert torch.equal(vc, vp)
        rest = torch.ones(S, dtype=torch.bool)
        rest[pos:pos + t] = False
        assert torch.equal(kc[:, rest], kc0[:, rest])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("t", (1, 2))
def test_k6c_attention_matches_plain_on_card(cuda_device, name, B, t):
    """Every start position, over a cache whose rows past the last query
    hold garbage (masked: neither version reads it into the output)."""
    cfg = CONFIGS[name]
    H, KH, D, S = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                   cfg.max_seq)
    g = torch.Generator().manual_seed(B * 10 + t)
    q = _rand(g, (B, t, H, D), cuda_device, 2.0)
    kc = _rand(g, (B, S, KH, D), cuda_device, 2.0)
    vc = _rand(g, (B, S, KH, D), cuda_device)
    scale = float(vc.float().abs().max())
    for pos in range(S - t + 1):
        got = kernels.depth_attention(q, kc, vc, pos)
        want = kernels.depth_attention_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert got.shape == (B, t, H * D)
        _close(got, want, scale / 16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("t", (1, 2))
def test_k6d_silu_mul_matches_plain_on_card(cuda_device, name, B, t):
    cfg = CONFIGS[name]
    g = torch.Generator().manual_seed(B * 10 + t)
    gu = _rand(g, (B * t, 2 * cfg.intermediate_size), cuda_device, 3.0)
    got = kernels.depth_silu_mul(gu)
    want = kernels.depth_silu_mul_plain(gu)
    torch.cuda.synchronize()
    assert int(_steps(got, want).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", BATCHES)
def test_depth_forward_fused_matches_plain_on_card(cuda_device, name, B,
                                                   monkeypatch):
    """A frame of forwards (two tokens, then one at a time to the last
    position) through K6 and through the plain body on the card: the
    launch counts, and outputs and caches within a relative 2^-7 (five
    layers of one-step differences)."""
    cfg = CONFIGS[name]
    p, xs, kc, vc = _frame(cfg, B, cuda_device)
    xs = xs[:1] + [xs[1 + i % 3] for i in range(cfg.max_seq - 2)]
    before = kernels.launch_counts()
    got = _run_frame(cfg, p, xs, kc, vc)
    after = kernels.launch_counts()
    L, n = cfg.num_layers, len(xs)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"depth_add_rms_norm": n * (2 * L + 1),
                  "depth_qkv_rope": n * L, "depth_attention": n * L,
                  "depth_silu_mul": n * L}
    _plain_on_card(monkeypatch)
    kp, vp = init_depth_kv(cfg, B, cuda_device)
    want = _run_frame(cfg, p, xs, kp, vp)
    monkeypatch.undo()
    assert kernels.launch_counts() == after
    torch.cuda.synchronize()
    for a, b in [*zip(got, want), (kc, kp), (vc, vp)]:
        err = (a.float() - b.float()).norm() / b.float().norm()
        assert err < 2.0 ** -7, err


def _qwen3_lm(device):
    from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
    from vox_serve_tpu_torch.models.backbone import BackboneConfig
    from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM

    m = Qwen3TTSLM(
        dtype=bf16, device=device, detokenize_interval=4,
        debug_backbone=BackboneConfig(
            vocab_size=3072, hidden_size=2048, num_layers=1, num_heads=16,
            num_kv_heads=8, head_dim=128, intermediate_size=256,
            qk_norm=True, rope_theta=1e6, dtype=bf16),
        debug_depth=QWEN3,
        debug_codec=Qwen3CodecConfig(
            codebook_dim=32, codebook_size=2048, latent_dim=48,
            decoder_dim=64, hidden_size=32, intermediate_size=64,
            head_dim=16, num_heads=4, num_kv_heads=4, num_layers=2,
            num_quantizers=16, sliding_window=48, upsample_rates=(4, 3),
            upsampling_ratios=(2, 2), vq_dim=16))
    m.sampling_config = m.sampling_config.replace(greedy=True)
    return m


def _depth_step_in_graph(m, hidden, cb0):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        m.depth_step(m.params, hidden, cb0, None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ids, feedback = m.depth_step(m.params, hidden, cb0, None)
    graph.replay()
    torch.cuda.synchronize()
    return ids.clone(), feedback.clone()


def _depth_logits(m, hidden, cb0, ids):
    """The logits (B, 15, vocab) of each codebook of ``depth_step``,
    teacher-forced on ``ids`` (its arithmetic, step by step)."""
    from vox_serve_tpu_torch.models.backbone import linear

    d, dcfg, B = m.params["depth"], m.depth_config, hidden.shape[0]
    x0 = torch.stack([hidden, m.params["codec_embedding"][cb0.long()]], 1)
    x = linear(d["proj"], x0.reshape(B * 2, -1)).reshape(B, 2, -1)
    kc, vc = init_depth_kv(dcfg, B, hidden.device)
    db = m.prepared_depth(d["backbone"])
    h = depth_forward(db, dcfg, x, 0, kc, vc)
    out = []
    for i in range(1, m.num_code_groups):
        out.append(h.float() @ d["heads"][i - 1].float())
        if i < m.num_code_groups - 1:
            ci = d["embeds"][i - 1][ids[:, i].long()]
            h = depth_forward(db, dcfg, linear(d["proj"], ci)[:, None],
                              i + 1, kc, vc)
    return torch.stack(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_qwen3_depth_step_fused_matches_plain_in_graph_on_card(
        cuda_device, B, monkeypatch):
    """Qwen3-TTS's whole depth step (15 forwards, 15 greedy codebooks, the
    feedback sum) captured in a CUDA graph, through the plain body and
    through K6. Teacher-forced on the plain path's ids, every row's logits
    of all 15 codebooks agree within ``LOGIT_REL`` and ``LOGIT_ABS``.
    Running free, a row's ids are the same up to its first codebook where
    the plain path's best two logits are a near tie (``NEAR_TIE``), and
    there the fused path took the other; rows with the same ids have the
    same feedback within one bf16 step."""
    m = _qwen3_lm(cuda_device)
    g = torch.Generator().manual_seed(B)
    hidden = _rand(g, (B, 2048), cuda_device)
    cb0 = torch.randint(0, 2048, (B,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    before = kernels.launch_counts()
    _plain_on_card(monkeypatch)
    ids_p, feedback_p = _depth_step_in_graph(m, hidden, cb0)
    logits_p = _depth_logits(m, hidden, cb0, ids_p)
    monkeypatch.undo()
    assert kernels.launch_counts() == before
    ids, feedback = _depth_step_in_graph(m, hidden, cb0)
    logits = _depth_logits(m, hidden, cb0, ids_p)   # fused, teacher-forced
    assert kernels.launch_counts()["depth_attention"] > \
        before["depth_attention"]
    assert ids.shape == (B, 17)
    diff = (logits - logits_p).abs()                     # (B, 15, vocab)
    rel = diff.norm(dim=-1) / logits_p.norm(dim=-1)      # (B, 15)
    assert float(rel.max()) < LOGIT_REL, float(rel.max())
    top = logits_p.abs().amax(-1, keepdim=True)
    assert float((diff / top).max()) <= LOGIT_ABS, float((diff / top).max())
    books = torch.arange(1, 16, device=cuda_device)
    best = logits_p.max(-1).values
    differ = ids[:, books] != ids_p[:, books]
    for r in differ.any(1).nonzero().flatten().tolist():
        c = int(differ[r].nonzero()[0])
        for name, row in (("plain", ids_p), ("fused", ids)):
            gap = float(best[r, c] - logits_p[r, c, row[r, c + 1]])
            assert gap < NEAR_TIE, (
                f"row {r} codebook {c + 1}: the {name} path took a token "
                f"{gap} below the plain logits' best")
    same = ~differ.any(1)
    if same.any():
        assert int(_steps(feedback[same], feedback_p[same]).max()) <= 1
    assert math.isfinite(float(feedback.float().abs().max()))
