"""Qwen3-TTS 12Hz (1.7B / 0.6B, CustomVoice) — the flagship (port of
vox_serve_tpu/models/qwen3_tts.py).

Talker transformer over dual-channel tokens (16 audio codebooks + 1 text
channel) + a 5-layer depth "code predictor". Per decode step the talker
samples codebook 0, then the depth loop samples codebooks 1..15 one after
another (15 sequential small forwards; on the card inside the worker's
captured decode graphs, so nothing here reads the device or shapes by
data), and the sum of their embeddings feeds back into the next step's
input features.

Ported: prompt construction for custom_voice (role tokens, codec think
prefix with language id, speaker token, text over codec_pad, tts_eos,
tts_pad + codec_bos; plus the input-streaming variant), the dual-channel
embed merge, the suppression bias over [vocab-1024, vocab) except codec
EOS, the depth step with feedback, and random init at the published widths
with the JAX init's shapes and scales. Checkpoint loaders, voice clone
(base) and voice design are not ported yet; without a checkpoint the model
serves random weights with the char-level dev tokenizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import get_logger

from ..codecs.qwen3_codec import (Qwen3CodecConfig, init_qwen3_codec,
                                  qwen3_codec_decode_chunk,
                                  qwen3_codec_init_cache)
from ..models.backbone import (BackboneConfig, _init_linear,
                               init_backbone_params, linear,
                               seeded_generator)
from ..models.base import BaseLMWithDepth, PreprocessOutput
from ..models.depth import (DepthConfig, depth_forward, init_depth_kv,
                            init_depth_params)
from ..sampling import SamplingConfig, sample
from ..weights import load_text_tokenizer

# special token ids
TTS_BOS = 151672
TTS_EOS = 151673
TTS_PAD = 151671
CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_PAD = 2148
CODEC_THINK = 2154
CODEC_NOTHINK = 2155
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157
LANGUAGE_IDS = {
    "chinese": 2055, "english": 2050, "german": 2053, "italian": 2070,
    "portuguese": 2071, "spanish": 2054, "japanese": 2058, "korean": 2064,
    "french": 2061, "russian": 2069,
}
TEXT_VOCAB = 151936
SAMPLES_PER_FRAME = 1920


def _normal(generator, shape, std, dtype, device):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)


class Qwen3TTSLM(BaseLMWithDepth):
    SAMPLE_RATE = 24000
    needs_input_features = True
    needs_input_masks = True
    supports_chained_detok = True  # sampled rows are audio-token rows
    supports_input_streaming = True
    text_channel_index = -1
    assets_available = False

    def __init__(self, model_name: str = "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 detokenize_interval=None, debug_backbone=None,
                 debug_depth=None, debug_codec=None, **_):
        super().__init__(model_name, dtype, device)
        name = model_name.lower()
        if "base" in name or "voicedesign" in name or "voice-design" in name:
            raise ValueError(
                f"{model_name}: only the CustomVoice variants are ported")
        self.tts_model_type = "custom_voice"
        self.tts_model_size = "0b6" if "0.6b" in name else "1b7"
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=3072, hidden_size=2048, num_layers=28, num_heads=16,
            num_kv_heads=8, head_dim=128, intermediate_size=6144,
            qk_norm=True, rope_theta=1_000_000.0, dtype=dtype,
        )
        self._depth_cfg = debug_depth or DepthConfig(
            hidden_size=1024, num_layers=5, num_heads=16, num_kv_heads=8,
            head_dim=128, intermediate_size=3072, max_seq=17, qk_norm=True,
            rope_theta=1_000_000.0, dtype=dtype,
        )
        self._codec_cfg = debug_codec or Qwen3CodecConfig()
        self._detok_interval = detokenize_interval or 10
        self.depth_vocab_size = 2048
        self.num_code_groups = 16
        self.logger = get_logger("qwen3_tts")
        self.spk_ids = {"ryan": 2090, "vivian": 2091, "serena": 2092}
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, TEXT_VOCAB)
        self._init_params(seed)
        self.sampling_config = self.default_sampling_config
        # suppress [vocab-1024, vocab) except codec EOS
        mask = torch.zeros((self._cfg.vocab_size,), dtype=torch.float32,
                           device=self.device)
        mask[self._cfg.vocab_size - 1024:] = float(
            np.finfo(np.float32).min)
        mask[CODEC_EOS] = 0.0
        self._suppress_bias = mask

    def _init_params(self, seed: int) -> None:
        """Random init at the configured widths (same shapes and scales as
        the JAX init; different bits, since the generators differ)."""
        cfg, dcfg, dev, dt = self._cfg, self._depth_cfg, self.device, self.dtype
        g = seeded_generator(dev, seed)
        H = cfg.hidden_size
        self.params = {
            "backbone": init_backbone_params(cfg, g, dev),
            "codec_embedding": _normal(g, (cfg.vocab_size, H), 0.02, dt, dev),
            "text_embedding": _normal(g, (TEXT_VOCAB, H), 0.02, dt, dev),
            "text_projection": {
                "fc1": _init_linear(g, H, H, dt, dev, bias=True),
                "fc2": _init_linear(g, H, H, dt, dev, bias=True),
            },
            "codec_head": _normal(g, (H, cfg.vocab_size), 0.02, dt, dev),
            "depth": {
                "backbone": init_depth_params(dcfg, g, dev),
                "proj": _init_linear(g, H, dcfg.hidden_size, dt, dev,
                                     bias=True),
                "embeds": _normal(g, (self.num_code_groups - 1,
                                      self.depth_vocab_size, H), 0.02, dt,
                                  dev),
                "heads": _normal(g, (self.num_code_groups - 1,
                                     dcfg.hidden_size, self.depth_vocab_size),
                                 0.02, dt, dev),
            },
        }
        self.codec_params = init_qwen3_codec(self._codec_cfg, g, dev)

    def set_params(self, params: dict, codec_params: dict) -> None:
        """Install parameters (e.g. converted by ``params.py``)."""
        self.params = params
        self.codec_params = codec_params

    # ---- metadata ----------------------------------------------------------
    @property
    def feedback_dim(self):
        return self._cfg.hidden_size

    @property
    def backbone_config(self):
        return self._cfg

    @property
    def depth_config(self):
        return self._depth_cfg

    @property
    def codec_config(self):
        return self._codec_cfg

    @property
    def n_codebooks(self):
        return self.num_code_groups + 1  # + text channel

    @property
    def vocab_size(self):
        return self._cfg.vocab_size

    @property
    def detokenize_interval(self):
        return self._detok_interval

    @property
    def detokenize_overlap(self):
        return 0

    @property
    def max_tokens(self):
        return 2048

    @property
    def output_audio_length(self):
        return self._detok_interval * self._codec_cfg.samples_per_frame

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_k=50, top_p=1.0, temperature=0.9,
                              repetition_penalty=1.05, repetition_window=-1,
                              max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def _encode_text(self, text: str) -> list[int]:
        return list(self.text_tokenizer.encode(text))

    def preprocess(self, prompt=None, audio_path=None, language="english",
                   speaker="ryan", instruct=None, streaming_first_token=None,
                   is_input_streaming=None, **kwargs) -> PreprocessOutput:
        """custom_voice prompt: [instruct] + role + codec think prefix +
        speaker + tts_bos + text over codec_pad (+ tts_eos, codec_bos)."""
        is_streaming = (streaming_first_token is not None
                        or bool(is_input_streaming))
        language = (language or "auto").lower()
        lang_id = LANGUAGE_IDS.get(language)
        if streaming_first_token is not None:
            text_ids = [int(streaming_first_token)]
        else:
            text_ids = self._encode_text(prompt or "")

        instruct_ids = None
        if instruct and self.tts_model_size != "0b6":
            instruct_ids = self._encode_text(
                f"<|im_start|>user\n{instruct}<|im_end|>\n")
        role_ids = self._encode_text("<|im_start|>assistant\n")[:3]
        while len(role_ids) < 3:
            role_ids.append(TTS_PAD)
        if lang_id is None:
            codec_prefix = [CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS]
        else:
            codec_prefix = [CODEC_THINK, CODEC_THINK_BOS, lang_id,
                            CODEC_THINK_EOS]

        rows = []  # (text_id, codec_id, needs_codec)
        for t in instruct_ids or ():
            rows.append((t, 0, False))
        for t in role_ids:
            rows.append((t, 0, False))
        for c in codec_prefix:
            rows.append((TTS_PAD, c, True))
        spk = (speaker or "ryan").lower()
        if spk not in self.spk_ids:
            fallback = next(iter(self.spk_ids))
            self.logger.warning("unknown speaker %r; falling back to %r "
                                "(known: %s)", spk, fallback,
                                sorted(self.spk_ids))
            spk = fallback
        rows.append((TTS_PAD, self.spk_ids[spk], True))
        rows.append((TTS_BOS, CODEC_PAD, True))
        for i, t in enumerate(text_ids):
            last = i == len(text_ids) - 1
            rows.append((t, CODEC_BOS if (is_streaming and last)
                         else CODEC_PAD, True))
        if not is_streaming:
            rows.append((TTS_EOS, CODEC_PAD, True))
            rows.append((TTS_PAD, CODEC_BOS, True))

        T, C = len(rows), self.n_codebooks
        input_tokens = np.zeros((T, C), np.int32)
        input_masks = np.zeros((T, C), bool)
        for i, (txt, codec, needs) in enumerate(rows):
            input_tokens[i, -1] = txt
            input_tokens[i, 0] = codec
            input_masks[i, -1] = needs
        return PreprocessOutput(
            input_tokens=input_tokens, input_masks=input_masks,
            input_features=np.zeros((T, self._cfg.hidden_size), np.float32))

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) == CODEC_EOS

    def text_stream_pad_token(self) -> int:
        return TTS_PAD

    def text_stream_eos_token(self) -> int:
        return TTS_EOS

    def tokenize_text_stream(self, text: str) -> list[int]:
        return self._encode_text(text)

    # ---- step functions ------------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        text_raw = params["text_embedding"][token_ids[:, -1].long()]
        tp = params["text_projection"]
        text_embeds = linear(tp["fc2"], F.silu(linear(tp["fc1"], text_raw)))
        codec_embeds = params["codec_embedding"][token_ids[:, 0].long()]
        if masks is None:
            x = text_embeds + codec_embeds  # decode: always text+codec
        else:
            needs = masks[:, -1:]
            x = torch.where(needs, text_embeds + codec_embeds, text_embeds)
        if features is not None:
            x = x + features.to(x.dtype)
        return x

    def logits(self, params, hidden):
        return (hidden @ params["codec_head"])[:, None, :]

    def adjust_logits(self, logits):
        return logits + self._suppress_bias[None, None, :]

    def depth_step(self, params, hidden, cb0, generator):
        """Sample codebooks 1..15 sequentially; returns ((B, 17) ids with
        the text column at TTS_PAD, (B, H) feedback = sum of the 15
        codebook embeddings)."""
        d = params["depth"]
        dcfg = self._depth_cfg
        B = hidden.shape[0]
        H = self._cfg.hidden_size
        cb0_embed = params["codec_embedding"][cb0.long()]
        x0 = torch.stack([hidden.to(self.dtype), cb0_embed], dim=1)
        x0p = linear(d["proj"], x0.reshape(B * 2, H)).reshape(B, 2, -1)
        kc, vc = init_depth_kv(dcfg, B, hidden.device)
        db = self.prepared_depth(d["backbone"])
        h = depth_forward(db, dcfg, x0p, 0, kc, vc)
        scfg = self.sampling_config
        feedback = torch.zeros((B, H), dtype=self.dtype, device=hidden.device)
        toks = []
        G = self.num_code_groups
        for i in range(1, G):
            logits = h.float() @ d["heads"][i - 1].float()
            tok = sample(logits[:, None, :], scfg, generator, None)[:, 0]
            toks.append(tok)
            ci = d["embeds"][i - 1][tok.long()]             # (B, H)
            feedback = feedback + ci
            if i < G - 1:  # the last codebook's forward would be unused
                x = linear(d["proj"], ci)[:, None, :]
                h = depth_forward(db, dcfg, x, i + 1, kc, vc)
        text_col = torch.full((B, 1), TTS_PAD, dtype=torch.int32,
                              device=hidden.device)
        all_ids = torch.cat([cb0[:, None].to(torch.int32),
                             torch.stack(toks, dim=1), text_col], dim=1)
        return all_ids, feedback

    # ---- codec ---------------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        codes = torch.clamp(token_ids[:, :, :-1], 0, self.depth_vocab_size - 1)
        codes = codes.transpose(1, 2)  # (B, 16, interval)
        return qwen3_codec_decode_chunk(codec_params, self._codec_cfg, codes,
                                        cache)

    def init_decoder_cache(self, batch):
        return qwen3_codec_init_cache(self._codec_cfg, batch, self.device)
