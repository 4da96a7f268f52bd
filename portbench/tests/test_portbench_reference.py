"""The Qwen3-TTS reference at a small size on the CPU, against the port
built at the same size: the frozen weight recipe gives the port's weights
bit for bit, and the port's greedy tokens and streamed PCM, served through
its worker and online scheduler, sit within rounding of the reference."""

import pytest
import torch

from portbench.run import judge
from portbench.tests.served import serve_small
from portbench.reference import qwen3_tts as ref

SEED = 2**31 + 12345
TEXTS = ["Hello there, how are you.", "The weather is fine today."]
KW = {"speaker": "ryan", "language": "english"}

TINY = {
    "talker": {"hidden": 64, "layers": 2, "heads": 4, "kv_heads": 2,
               "head_dim": 16, "intermediate": 128, "vocab": 3072,
               "text_vocab": 151936, "rope_theta": 1e6, "eps": 1e-6,
               "repetition_penalty": 1.05},
    "depth": {"hidden": 32, "layers": 2, "heads": 4, "kv_heads": 2,
              "head_dim": 16, "intermediate": 64, "codebooks": 16,
              "vocab": 2048, "rope_theta": 1e6, "eps": 1e-6},
    "codec": {"codebook_dim": 32, "codebook_size": 2048, "latent_dim": 48,
              "decoder_dim": 64, "hidden": 32, "intermediate": 64,
              "head_dim": 16, "heads": 4, "kv_heads": 4, "layers": 2,
              "quantizers": 16, "eps": 1e-5, "rope_theta": 10000.0,
              "sliding_window": 48, "upsample_rates": [4, 3],
              "upsampling_ratios": [2, 2], "layer_scale": 0.01,
              "vq_dim": 16, "samples_per_frame": 48},
}


def _port_model(dtype):
    from vox_serve_tpu_torch.codecs.qwen3_codec import Qwen3CodecConfig
    from vox_serve_tpu_torch.models.backbone import BackboneConfig
    from vox_serve_tpu_torch.models.depth import DepthConfig
    from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM

    t, d, c = TINY["talker"], TINY["depth"], TINY["codec"]
    return Qwen3TTSLM(
        dtype=dtype, device="cpu", seed=SEED, detokenize_interval=4,
        debug_backbone=BackboneConfig(
            vocab_size=t["vocab"], hidden_size=t["hidden"],
            num_layers=t["layers"], num_heads=t["heads"],
            num_kv_heads=t["kv_heads"], head_dim=t["head_dim"],
            intermediate_size=t["intermediate"], qk_norm=True,
            rope_theta=t["rope_theta"], dtype=dtype),
        debug_depth=DepthConfig(
            hidden_size=d["hidden"], num_layers=d["layers"],
            num_heads=d["heads"], num_kv_heads=d["kv_heads"],
            head_dim=d["head_dim"], intermediate_size=d["intermediate"],
            max_seq=17, qk_norm=True, rope_theta=d["rope_theta"],
            dtype=dtype),
        debug_codec=Qwen3CodecConfig(
            codebook_dim=c["codebook_dim"], codebook_size=2048,
            latent_dim=c["latent_dim"], decoder_dim=c["decoder_dim"],
            hidden_size=c["hidden"], intermediate_size=c["intermediate"],
            head_dim=c["head_dim"], num_heads=c["heads"],
            num_kv_heads=c["kv_heads"], num_layers=c["layers"],
            num_quantizers=16, sliding_window=c["sliding_window"],
            upsample_rates=tuple(c["upsample_rates"]),
            upsampling_ratios=tuple(c["upsampling_ratios"]),
            vq_dim=c["vq_dim"]))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_weight_recipe_is_the_ports_bit_for_bit():
    torch.manual_seed(0)
    model = _port_model(torch.bfloat16)
    w = ref.make_weights(TINY, SEED, "cpu")
    p = model.params
    pairs = [
        (w["codec_embedding"], p["codec_embedding"]),
        (w["text_embedding"], p["text_embedding"]),
        (w["fc1"]["w"], p["text_projection"]["fc1"]["w"]),
        (w["fc2"]["w"], p["text_projection"]["fc2"]["w"]),
        (w["codec_head"], p["codec_head"]),
        (w["depth_proj"]["w"], p["depth"]["proj"]["w"]),
        (w["depth_embeds"], p["depth"]["embeds"]),
        (w["depth_heads"], p["depth"]["heads"]),
    ]
    for name in ("q", "k", "v", "o"):
        pairs.append((w["talker"][name]["w"],
                      p["backbone"]["layers"]["attn"][name]["w"]))
        pairs.append((w["depth"][name]["w"],
                      p["depth"]["backbone"]["layers"]["attn"][name]["w"]))
    for name in ("gate", "up", "down"):
        pairs.append((w["talker"][name]["w"],
                      p["backbone"]["layers"]["mlp"][name]["w"]))
        pairs.append((w["depth"][name]["w"],
                      p["depth"]["backbone"]["layers"]["mlp"][name]["w"]))
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the codec: every drawn tensor, in the port's tree order
    mine = [t for _, t in _leaves(w["codec"]) if t.numel() > 1
            and t.dtype == torch.float32 and t.std() > 0]
    port = [t for _, t in _leaves(model.codec_params) if t.numel() > 1
            and t.dtype == torch.float32 and t.std() > 0]
    assert sorted(float(t.double().sum()) for t in mine) == sorted(
        float(t.double().sum()) for t in port)


@pytest.fixture(scope="module")
def served():
    """Two greedy streams of the port's bf16 model through its worker and
    online scheduler on the CPU: their rows, windows and PCM."""
    return serve_small(_port_model(torch.bfloat16), TEXTS, 60, kwargs=KW)


def test_reference_agrees_with_the_served_greedy_stream(served):
    r = ref.make_reference(TINY, SEED, "cpu")
    for item in served:
        assert item["audio_tokens"] > 8
        out = judge([item], r)
        assert out["pcm_len_diff"] == 0
        # bf16 serving against a float32 reference: near ties may flip
        assert out["lm_gap"] < 0.05, out
        assert out["depth_gap"] < 0.05, out
        assert out["pcm_rmse"] < 1e-3, out


def test_an_altered_token_is_caught(served):
    r = ref.make_reference(TINY, SEED, "cpu")
    item = dict(served[0])
    tokens = [list(row) for row in item["tokens"]]
    logits = r.cb0_logits(item["prompt"], torch.tensor(tokens)[:, :16])[1]
    # the served token at frame 3 swapped for the reference's worst
    # allowed one
    worst = int(logits[3][:2048].argmin())
    tokens[3][0] = worst
    item["tokens"] = tokens
    assert r.judge(item)["lm_gap"] > 0.05
