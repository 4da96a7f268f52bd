"""Port parity, checkpoint plumbing (vox_serve_tpu_torch/weights.py) against
the JAX package's vox_serve_tpu/weights.py, on the CPU.

* the port's safetensors reader against ``safetensors.numpy`` (the JAX
  package's reader) on F32, F16, BF16 (written after importing jax, so
  numpy knows bfloat16 through ml_dtypes), I64, BOOL, an empty tensor and a
  two-shard merge: bit-exact; the port's writer read back by
  ``safetensors.numpy``;
* ``resolve_model_dir`` against JAX's on a local directory, on a fake hub
  cache through ``HF_HUB_CACHE`` (``refs/main`` -> ``snapshots/<commit>``;
  JAX's goes through ``huggingface_hub.snapshot_download``) and on a
  missing id;
* ``load_llama_family_backbone`` (with and without q/k norms and qkv
  biases), ``load_embedding`` and ``load_head`` (own and tied) on the same
  state: leaf for leaf equal to JAX's, in the tree ``init_backbone_params``
  makes (keys, shapes, dtype), bf16 and f32;
* ``load_text_tokenizer``: a local Hugging Face tokenizer directory gives
  the same ids as JAX's; none gives the dev tokenizer and False.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from vox_serve_tpu import weights as jweights
from vox_serve_tpu_torch import params as tparams
from vox_serve_tpu_torch import weights
from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                 init_backbone_params)

torch.set_num_threads(1)

assert jax  # imported first: it registers bfloat16 with numpy

rng = np.random.default_rng(11)

SAMPLES = {
    "f32": rng.standard_normal((3, 5)).astype(np.float32),
    "f16": rng.standard_normal((4, 2, 3)).astype(np.float16),
    "bf16": rng.standard_normal((7, 3)).astype(ml_dtypes.bfloat16),
    "i64": rng.integers(-2 ** 40, 2 ** 40, (6,)).astype(np.int64),
    "bool": rng.random((2, 5)) < 0.5,
    "empty": np.zeros((0, 4), np.float32),
    "scalar": np.asarray(2.5, np.float32),
}


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_reader_is_bit_exact_against_safetensors(tmp_path, name):
    ref = SAMPLES[name]
    save_file({name: ref, "other": SAMPLES["f32"]},
              str(tmp_path / "a.safetensors"))
    got = weights.load_safetensors_file(tmp_path / "a.safetensors")[name]
    assert tuple(got.shape) == ref.shape
    want = {np.float32: torch.float32, np.float16: torch.float16,
            np.int64: torch.int64, np.bool_: torch.bool}.get(
                ref.dtype.type, torch.bfloat16)
    assert got.dtype == want
    assert _bits(got) == ref.tobytes()
    assert (load_file(str(tmp_path / "a.safetensors"))[name].tobytes()
            == ref.tobytes())


def test_two_shards_merge_in_sorted_order(tmp_path):
    save_file({"a": SAMPLES["f32"], "b": SAMPLES["bf16"]},
              str(tmp_path / "model-00002-of-00002.safetensors"))
    save_file({"c": SAMPLES["i64"], "a": SAMPLES["f16"]},
              str(tmp_path / "model-00001-of-00002.safetensors"))
    got = weights.load_safetensors_state(tmp_path)
    ref = jweights.load_safetensors_state(tmp_path)
    assert sorted(got) == sorted(ref) == ["a", "b", "c"]
    for k in got:
        assert _bits(got[k]) == ref[k].tobytes(), k
    # the later shard wins, as in the JAX merge
    assert got["a"].dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        weights.load_safetensors_state(tmp_path / "nothing")


def test_writer_round_trip_through_safetensors(tmp_path):
    src = {k: torch.from_numpy(np.array(v.view(np.int16)
                                        if v.dtype == ml_dtypes.bfloat16
                                        else v))
           for k, v in SAMPLES.items()}
    src["bf16"] = src["bf16"].view(torch.bfloat16)
    n = weights.save_safetensors(src, tmp_path / "w.safetensors")
    assert n == (tmp_path / "w.safetensors").stat().st_size
    back = load_file(str(tmp_path / "w.safetensors"))
    for k, v in SAMPLES.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k
    again = weights.load_safetensors_file(tmp_path / "w.safetensors")
    for k in src:
        assert _bits(again[k]) == _bits(src[k])


def _fake_hub(cache, model_id, commit="c0ffee" * 6 + "abcd"):
    repo = cache / ("models--" + model_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit)
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    return snap


def test_resolve_model_dir_matches_jax(tmp_path, monkeypatch):
    import huggingface_hub.constants as hf_constants

    cache = tmp_path / "hub"
    snap = _fake_hub(cache, "Org/Model-1B")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hf_constants, "HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert weights.resolve_model_dir(str(tmp_path)) == tmp_path
    assert jweights.resolve_model_dir(str(tmp_path)) == tmp_path
    got = weights.resolve_model_dir("Org/Model-1B")
    assert got == snap
    assert got.resolve() == jweights.resolve_model_dir("Org/Model-1B"
                                                       ).resolve()
    assert weights.resolve_model_dir("Org/absent-zzz") is None
    assert jweights.resolve_model_dir("Org/absent-zzz") is None
    # a ref naming no snapshot resolves to nothing
    (cache / "models--Org--Model-1B" / "refs" / "main").write_text("dead")
    assert weights.resolve_model_dir("Org/Model-1B") is None


def test_hub_cache_dir_order(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert weights.hub_cache_dir() == tmp_path / "home" / "hub"
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert weights.hub_cache_dir() == (tmp_path / ".cache" / "huggingface"
                                       / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "c"))
    assert weights.hub_cache_dir() == tmp_path / "c"


def _r(*shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _llama_state(prefix, L, H, heads, kvh, hd, ffn, qk_norm=False,
                 qkv_bias=False):
    s = {}
    for i in range(L):
        p = f"{prefix}layers.{i}."
        s[p + "self_attn.q_proj.weight"] = _r(heads * hd, H)
        s[p + "self_attn.k_proj.weight"] = _r(kvh * hd, H)
        s[p + "self_attn.v_proj.weight"] = _r(kvh * hd, H)
        s[p + "self_attn.o_proj.weight"] = _r(H, heads * hd)
        s[p + "mlp.gate_proj.weight"] = _r(ffn, H)
        s[p + "mlp.up_proj.weight"] = _r(ffn, H)
        s[p + "mlp.down_proj.weight"] = _r(H, ffn)
        s[p + "input_layernorm.weight"] = _r(H)
        s[p + "post_attention_layernorm.weight"] = _r(H)
        if qk_norm:
            s[p + "self_attn.q_norm.weight"] = _r(hd)
            s[p + "self_attn.k_norm.weight"] = _r(hd)
        if qkv_bias:
            for k in "qkv":
                s[p + f"self_attn.{k}_proj.bias"] = _r(
                    (heads if k == "q" else kvh) * hd)
    s[prefix + "norm.weight"] = _r(H)
    return s


def assert_trees_equal(got, ref, path=""):
    """Port tree (torch) == JAX tree (numpy of each leaf), leaf for leaf by
    key path: same keys, shapes, dtypes and bits."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_trees_equal(g, r, f"{path}[{i}]")
    else:
        r = np.asarray(ref)
        assert tuple(got.shape) == r.shape, path
        g = got.detach().cpu()
        if g.dtype == torch.bfloat16:
            assert r.dtype == ml_dtypes.bfloat16, path
            assert _bits(g) == r.tobytes(), path
        else:
            assert str(g.dtype).removeprefix("torch.") == r.dtype.name, path
            assert np.array_equal(g.numpy(), r), path


@pytest.mark.parametrize("qk_norm,qkv_bias,dt", [
    (True, False, "bfloat16"), (False, True, "float32"),
    (False, False, "bfloat16")])
def test_llama_backbone_mapper_matches_jax(tmp_path, qk_norm, qkv_bias, dt):
    L, H, heads, kvh, hd, ffn = 3, 32, 4, 2, 8, 48
    state = _llama_state("model.", L, H, heads, kvh, hd, ffn, qk_norm,
                         qkv_bias)
    save_file(state, str(tmp_path / "m.safetensors"))
    tstate = weights.load_safetensors_state(tmp_path)
    jstate = jweights.load_safetensors_state(tmp_path)
    tdt = getattr(torch, dt)
    got = weights.load_llama_family_backbone(
        tstate, L, qk_norm=qk_norm, qkv_bias=qkv_bias, dtype=tdt,
        device="cpu")
    ref = jweights.load_llama_family_backbone(
        jstate, L, qk_norm=qk_norm, qkv_bias=qkv_bias,
        dtype=getattr(jax.numpy, dt))
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    # the tree init_backbone_params makes: keys, shapes and dtype
    cfg = BackboneConfig(vocab_size=10, hidden_size=H, num_layers=L,
                         num_heads=heads, num_kv_heads=kvh, head_dim=hd,
                         intermediate_size=ffn, qk_norm=qk_norm, dtype=tdt)
    init = init_backbone_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if qkv_bias:
        for k in "qkv":
            init["layers"]["attn"][k]["b"] = got["layers"]["attn"][k]["b"]
    tparams.tree_map(lambda a, b: (a.shape == b.shape and a.dtype == b.dtype
                                   ) or pytest.fail("shape/dtype"), got, init)
    assert all(t.is_contiguous() for t in tparams.tree_leaves(got))


@pytest.mark.parametrize("tied", [False, True])
def test_embedding_and_head_match_jax(tmp_path, tied):
    state = {"model.embed_tokens.weight": _r(40, 16)}
    if not tied:
        state["lm_head.weight"] = _r(40, 16)
    save_file(state, str(tmp_path / "m.safetensors"))
    ts = weights.load_safetensors_state(tmp_path)
    js = jweights.load_safetensors_state(tmp_path)
    got_e = weights.load_embedding(ts, "model.embed_tokens.weight",
                                   device="cpu")
    got_h = weights.load_head(ts, "lm_head.weight",
                              "model.embed_tokens.weight", device="cpu")
    ref_e = jweights.load_embedding(js, "model.embed_tokens.weight")
    ref_h = jweights.load_head(js, "lm_head.weight",
                               "model.embed_tokens.weight")
    assert_trees_equal({"e": got_e, "h": got_h},
                       {"e": np.asarray(ref_e), "h": np.asarray(ref_h)})
    assert tuple(got_h.shape) == (16, 40) and got_h.is_contiguous()
    if tied:
        with pytest.raises(KeyError):
            weights.load_head(ts, "lm_head.weight", device="cpu")


def test_text_tokenizer_from_local_files_and_fallback(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, "hello": 1, "world": 2, "voice": 3}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="[UNK]"
                            ).save_pretrained(str(tmp_path))
    tok, ok = weights.load_text_tokenizer(str(tmp_path), 100)
    jtok, jok = jweights.load_text_tokenizer(str(tmp_path), 100)
    assert ok and jok
    text = "hello voice world zzz"
    assert list(tok.encode(text)) == list(jtok.encode(text)) == [1, 3, 2, 0]

    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps({}))
    tok, ok = weights.load_text_tokenizer(str(empty), 500)
    assert not ok and isinstance(tok, weights.DevTokenizer)
    assert tok.encode("ab") == jweights.DevTokenizer(500).encode("ab")
