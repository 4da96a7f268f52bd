"""The CosyVoice2 reference at a small size on the CPU, against the port
built at the same size: its greedy tokens and streamed PCM, served through
its worker and online scheduler, sit within rounding of the reference."""

import pytest
import torch

from portbench.run import judge
from portbench.tests.served import serve_small
from portbench.reference import cosyvoice2 as ref

SEED = 2**31 + 777
TEXTS = ["Hello there, how are you.", "The weather is fine."]

TINY = {
    "lm": {"hidden": 64, "layers": 2, "heads": 4, "kv_heads": 2,
           "head_dim": 16, "intermediate": 128, "text_vocab": 151936,
           "speech_vocab": 6564, "rope_theta": 1e6, "eps": 1e-6},
    "flow": {"input_size": 32, "output_size": 32, "heads": 4,
             "linear_units": 64, "num_blocks": 1, "up_blocks": 1,
             "vocab_size": 6561, "spk_dim": 8, "mel_dim": 16,
             "token_mel_ratio": 2, "pre_lookahead": 3,
             "static_chunk_size": 25, "est_channels": 16,
             "est_head_dim": 8, "est_heads": 2, "est_n_blocks": 1,
             "est_mid_blocks": 1, "est_static_chunk": 50, "n_timesteps": 2,
             "cfg_rate": 0.7},
    "hift": {"in_channels": 16, "base_channels": 32, "nb_harmonics": 4,
             "sampling_rate": 24000, "nsf_alpha": 0.1,
             "nsf_voiced_threshold": 10.0, "upsample_rates": [8, 5, 3],
             "upsample_kernel_sizes": [16, 11, 7], "n_fft": 16,
             "hop_len": 4, "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
             "source_resblock_kernel_sizes": [7, 7, 11],
             "lrelu_slope": 0.1, "audio_limit": 0.99,
             "f0_cond_channels": 16},
    "dev_s3v2": {"n_mels": 128, "n_state": 256, "layers": 2,
                 "fsmn_kernel": 31, "fsq_dim": 8},
    "dev_speaker": {"n_mels": 80, "channels": 512, "layers": 3,
                    "out_dim": 8},
}


def _port_model():
    from vox_serve_tpu_torch.codecs.cosyvoice_flow import CosyFlowConfig
    from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig
    from vox_serve_tpu_torch.models.backbone import BackboneConfig
    from vox_serve_tpu_torch.models.cosyvoice2 import CosyVoice2LM

    lm, f, h = TINY["lm"], TINY["flow"], TINY["hift"]
    flow = {k: v for k, v in f.items() if k not in ("token_mel_ratio",)}
    hift = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                if isinstance(v, list) else v)
            for k, v in h.items()}
    return CosyVoice2LM(
        dtype=torch.bfloat16, seed=SEED, device="cpu",
        debug_backbone=BackboneConfig(
            vocab_size=lm["text_vocab"], hidden_size=lm["hidden"],
            num_layers=lm["layers"], num_heads=lm["heads"],
            num_kv_heads=lm["kv_heads"], head_dim=lm["head_dim"],
            intermediate_size=lm["intermediate"], qkv_bias=True,
            rope_theta=lm["rope_theta"], dtype=torch.bfloat16),
        debug_flow=CosyFlowConfig(**flow), debug_hift=HiFTConfig(**hift))


@pytest.fixture(scope="module")
def served():
    """Two greedy streams of the port's model (bf16 LM, float32 flow and
    HiFT) through its worker and online scheduler on the CPU."""
    return serve_small(_port_model(), TEXTS, 100)


def test_reference_agrees_with_the_served_greedy_stream(served):
    r = ref.make_reference(TINY, SEED, "cpu")
    for item in served:
        assert item["audio_tokens"] > 30
        out = judge([item], r)
        assert out["pcm_len_diff"] == 0, out
        assert out["lm_gap"] < 0.05, out
        assert out["pcm_rmse"] < 1e-3, out
