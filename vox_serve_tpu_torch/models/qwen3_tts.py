"""Qwen3-TTS 12Hz (1.7B / 0.6B x CustomVoice / Base / VoiceDesign) — the
flagship (port of vox_serve_tpu/models/qwen3_tts.py).

Talker transformer over dual-channel tokens (16 audio codebooks + 1 text
channel) + a 5-layer depth "code predictor". Per decode step the talker
samples codebook 0, then the depth loop samples codebooks 1..15 one after
another (15 sequential small forwards; on the card inside the worker's
captured decode graphs, so nothing here reads the device or shapes by
data), and the sum of their embeddings feeds back into the next step's
input features.

Prompts for the three variants: role tokens, the codec think prefix with a
language id (a Chinese dialect speaker's from ``config.json``), then a
preset speaker's token (CustomVoice), a speaker x-vector row (Base: the
ECAPA encoder's embedding of the uploaded reference, stored as
``x_vector - codec_embedding[CODEC_PAD]`` since ``embed`` adds the codec
embedding of column 0) or nothing (VoiceDesign, conditioned on its
``instruct`` text), then tts_bos and the text over codec_pad, tts_eos and
codec_bos; Base ICL voice cloning adds the reference transcript and the
reference's codec frames, their depth-codebook embeddings summed on the
device into the input features. The reference codes come from the codec
checkpoint's 32-quantizer Mimi encoder (the first 16 codebooks).

Weights come from the checkpoint when one resolves (``weights.py``:
``talker.model.*`` / ``talker.code_predictor.*``, the Base variant's
``speaker_encoder.*``; the Qwen/Qwen3-TTS-Tokenizer-12Hz snapshot's
``decoder.*`` and ``encoder.*``), else random init at the published widths
with the JAX init's shapes and scales and the char-level dev tokenizer.
Debug configurations never resolve a checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

import json
from typing import Optional

from ..utils import get_logger, load_audio_mono

from ..codecs.mimi import MimiConfig, load_mimi_encoder_params, mimi_encode
from ..codecs.qwen3_codec import (Qwen3CodecConfig, init_qwen3_codec,
                                  load_qwen3_codec_params,
                                  qwen3_codec_decode_chunk,
                                  qwen3_codec_init_cache)
from ..models.backbone import (BackboneConfig, _init_linear,
                               init_backbone_params, linear,
                               seeded_generator)
from ..encoders.ecapa import (EcapaConfig, ecapa_embed, load_ecapa_params,
                              qwen3_speaker_mel)
from ..models.base import BaseLMWithDepth, PreprocessOutput
from ..models.depth import (DepthConfig, depth_forward, init_depth_kv,
                            init_depth_params)
from ..sampling import SamplingConfig, sample
from ..weights import (_stack, load_llama_family_backbone,
                       load_safetensors_state, load_text_tokenizer,
                       resolve_model_dir, to_device)

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
        self.tts_model_type = ("base" if "base" in name else
                               "voice_design" if "voicedesign" in name or
                               "voice-design" in name else "custom_voice")
        self.tts_model_size = "0b6" if "0.6b" in name else "1b7"
        self._is_debug_config = any(
            x is not None for x in (debug_backbone, debug_depth, debug_codec))
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
        self.spk_dialects: dict = {}  # speaker -> dialect language name
        #: the Base variant's ECAPA speaker encoder (from the checkpoint)
        self._spk_enc_cfg: Optional[EcapaConfig] = None
        self._spk_enc_params: Optional[dict] = None
        #: the codec checkpoint's Mimi encoder (ICL reference codes)
        self._enc_mimi_cfg: Optional[MimiConfig] = None
        self._codec_encoder: Optional[dict] = None
        self._load_talker_tables()
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

    # ---- checkpoints -------------------------------------------------------
    def _load_talker_tables(self) -> None:
        """Speaker ids and dialects from the checkpoint's ``config.json``
        (``talker_config.spk_id`` / ``spk_is_dialect``); the built-in trio
        covers only the documented default speakers."""
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return
        try:
            raw = json.loads((model_dir / "config.json").read_text())
        except Exception:
            return
        talker = raw.get("talker_config", {}) or {}
        spk = talker.get("spk_id") or {}
        if isinstance(spk, dict) and spk:
            self.spk_ids = {str(k).lower(): int(v) for k, v in spk.items()}
        dial = talker.get("spk_is_dialect") or {}
        if isinstance(dial, dict):
            self.spk_dialects = {str(k).lower(): v for k, v in dial.items()
                                 if v}

    def _load_checkpoint(self) -> dict | None:
        """Map the HF checkpoint (``talker.model.*``,
        ``talker.code_predictor.*``, ``talker.text_projection.*``,
        ``talker.codec_head``; the Base variant's ``speaker_encoder.*``)
        into the parameter tree on the model's device; None (random init)
        when none resolves or the mapping fails."""
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            cfg, dcfg, dev, dt = (self._cfg, self._depth_cfg, self.device,
                                  self.dtype)
            t, cp = "talker.model.", "talker.code_predictor."
            n_cp = self.num_code_groups - 1

            def arr(n, transpose=False):
                return to_device(state[n], dev, dt, transpose=transpose)

            def stacked(template, transpose=False):
                return _stack(state, template, n_cp, dev,
                              transpose=transpose, dtype=dt)

            params = {
                "backbone": load_llama_family_backbone(
                    state, cfg.num_layers, prefix=t, qk_norm=True, dtype=dt,
                    device=dev),
                "codec_embedding": arr(t + "codec_embedding.weight"),
                "text_embedding": arr(t + "text_embedding.weight"),
                "text_projection": {
                    f"fc{i}": {
                        "w": arr(f"talker.text_projection.linear_fc{i}"
                                 ".weight", transpose=True),
                        "b": arr(f"talker.text_projection.linear_fc{i}"
                                 ".bias")}
                    for i in (1, 2)},
                "codec_head": arr("talker.codec_head.weight", transpose=True),
                "depth": {
                    "backbone": load_llama_family_backbone(
                        state, dcfg.num_layers, prefix=cp + "model.",
                        qk_norm=True, dtype=dt, device=dev),
                    "proj": {
                        "w": arr(cp + "small_to_mtp_projection.weight",
                                 transpose=True),
                        "b": arr(cp + "small_to_mtp_projection.bias"),
                    },
                    "embeds": stacked(cp + "model.codec_embedding.{i}.weight"),
                    "heads": stacked(cp + "lm_head.{i}.weight",
                                     transpose=True),
                },
            }
            # the Base variant ships the ECAPA speaker encoder in the same
            # checkpoint (mel_dim 128, the talker's width)
            if any(k.startswith("speaker_encoder.") for k in state):
                self._spk_enc_cfg = EcapaConfig(mel_dim=128,
                                                enc_dim=cfg.hidden_size)
                self._spk_enc_params = load_ecapa_params(
                    state, self._spk_enc_cfg, device=dev)
            return params
        except Exception as e:
            get_logger("qwen3").warning(
                "checkpoint mapping failed (%s); random init",
                type(e).__name__)
            return None

    #: the codec ships as its own HF repo
    CODEC_REPO = "Qwen/Qwen3-TTS-Tokenizer-12Hz"

    def _load_codec_params(self) -> dict | None:
        """The codec checkpoint's decoder (float32 on the device), and its
        ``encoder.*`` Mimi model for ICL reference codes; None when no
        snapshot resolves or the decoder's mapping fails."""
        model_dir = resolve_model_dir(self.CODEC_REPO)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            self._load_codec_encoder(state)
            return load_qwen3_codec_params(state, self._codec_cfg,
                                           device=self.device)
        except Exception as e:
            get_logger("qwen3").warning(
                "codec checkpoint mapping failed (%s); random init",
                type(e).__name__)
            return None

    def _init_codec_params(self, generator: torch.Generator) -> None:
        # real weights map only onto the real architecture, not debug dims
        codec = (self._load_codec_params()
                 if self._codec_cfg == Qwen3CodecConfig() else None)
        self.codec_assets_available = codec is not None
        self.codec_params = (codec if codec is not None else
                             init_qwen3_codec(self._codec_cfg, generator,
                                              self.device))

    def _init_params(self, seed: int) -> None:
        """The checkpoint when one resolves (never under a debug config:
        its shapes would not match), else random init at the configured
        widths (the JAX init's shapes and scales; different bits, since
        the generators differ); then the codec the same way."""
        loaded = None if self._is_debug_config else self._load_checkpoint()
        self.talker_loaded = loaded is not None
        if loaded is not None:
            self.params = loaded
            self._init_codec_params(seeded_generator(self.device, seed + 1))
            return
        self.assets_available = False
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
        self._init_codec_params(g)

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False); None where the variant has no such part."""
        base = self.tts_model_type == "base"
        return {"talker": self.talker_loaded,
                "codec": self.codec_assets_available,
                "codec_encoder": self._codec_encoder is not None,
                "speaker_encoder": (self._spk_enc_params is not None
                                    if base else None)}

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
    def supports_audio_input(self):
        return self.tts_model_type == "base"

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_k=50, top_p=1.0, temperature=0.9,
                              repetition_penalty=1.05, repetition_window=-1,
                              max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def _encode_text(self, text: str) -> list[int]:
        return list(self.text_tokenizer.encode(text))

    def preprocess(self, prompt=None, audio_path=None, language="english",
                   speaker="ryan", instruct=None, ref_text=None,
                   x_vector_only_mode=False, streaming_first_token=None,
                   is_input_streaming=None, **kwargs) -> PreprocessOutput:
        """[instruct] + role + codec think prefix + (preset speaker |
        x-vector | nothing) + tts_bos + text over codec_pad (+ tts_eos,
        codec_bos), or for ICL voice cloning ref_text + text + tts_eos +
        codec_bos + the reference's codec frames; the JAX package's rows,
        masks and features."""
        is_streaming = (streaming_first_token is not None
                        or bool(is_input_streaming))
        language = (language or "auto").lower()
        lang_id = LANGUAGE_IDS.get(language)
        if (self.tts_model_type == "custom_voice" and lang_id is None
                and language in ("chinese", "auto")):
            # a Chinese dialect speaker carries its dialect's language id
            # (the table from the checkpoint's config.json)
            d = self.spk_dialects.get((speaker or "").lower())
            if d:
                lang_id = LANGUAGE_IDS.get(str(d).lower())
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

        rows = []  # (text_id, codec_id, needs_codec, feature row or None)
        for t in instruct_ids or ():
            rows.append((t, 0, False, None))
        for t in role_ids:
            rows.append((t, 0, False, None))
        for c in codec_prefix:
            rows.append((TTS_PAD, c, True, None))

        base = self.tts_model_type == "base"
        ref_codes = kwargs.get("ref_codes")
        if ref_codes is None and base and not x_vector_only_mode \
                and audio_path:
            ref_codes = self._encode_audio_to_codes(audio_path)
        icl = base and not x_vector_only_mode and ref_codes is not None
        if icl and not (ref_text or kwargs.get("ref_codes") is not None):
            # the reference substitutes a default audio + ref_text pair
            # (downloaded); offline the JAX package falls back to x-vector
            # only: ref codes with an empty transcript is a prompt
            # structure the model never saw
            self.logger.warning(
                "voice clone without ref_text: falling back to x-vector-"
                "only conditioning (provide ref_text for full ICL cloning)")
            icl = False
            ref_codes = None
        if icl and is_streaming:
            raise ValueError("ICL voice clone is incompatible with input "
                             "streaming; use x_vector_only_mode=True")

        if base:
            # the x-vector row: text side tts_pad, codec side the speaker
            # embedding; embed() adds the codec embedding of column 0, so
            # the feature is x_vector - codec_embedding[CODEC_PAD]
            spk_vec = self._extract_speaker_embedding(audio_path)
            pad_embed = self.params["codec_embedding"][CODEC_PAD].float()
            rows.append((TTS_PAD, CODEC_PAD, True,
                         spk_vec - pad_embed.cpu().numpy()))
        elif self.tts_model_type == "custom_voice":
            spk = (speaker or "ryan").lower()
            if spk not in self.spk_ids:
                fallback = next(iter(self.spk_ids))
                self.logger.warning("unknown speaker %r; falling back to %r "
                                    "(known: %s)", spk, fallback,
                                    sorted(self.spk_ids))
                spk = fallback
            rows.append((TTS_PAD, self.spk_ids[spk], True, None))
        # voice_design: no speaker row

        rows.append((TTS_BOS, CODEC_PAD, True, None))
        if icl:
            ref_codes = np.asarray(ref_codes, np.int64)
            for t in self._encode_text(ref_text or ""):
                rows.append((t, CODEC_PAD, True, None))
            for t in text_ids:
                rows.append((t, CODEC_PAD, True, None))
            rows.append((TTS_EOS, CODEC_PAD, True, None))
            rows.append((TTS_PAD, CODEC_BOS, True, None))
            summed = self._depth_embedding_sums(ref_codes)
            for t in range(ref_codes.shape[0]):
                rows.append((TTS_PAD, int(ref_codes[t, 0]), True,
                             summed[t]))
        else:
            for i, t in enumerate(text_ids):
                last = i == len(text_ids) - 1
                rows.append((t, CODEC_BOS if (is_streaming and last)
                             else CODEC_PAD, True, None))
            if not is_streaming:
                rows.append((TTS_EOS, CODEC_PAD, True, None))
                rows.append((TTS_PAD, CODEC_BOS, True, None))

        T, C = len(rows), self.n_codebooks
        input_tokens = np.zeros((T, C), np.int32)
        input_masks = np.zeros((T, C), bool)
        input_features = np.zeros((T, self._cfg.hidden_size), np.float32)
        for i, (txt, codec, needs, feat) in enumerate(rows):
            input_tokens[i, -1] = txt
            input_tokens[i, 0] = codec
            input_masks[i, -1] = needs
            if feat is not None:
                input_features[i] = feat
        return PreprocessOutput(input_tokens=input_tokens,
                                input_masks=input_masks,
                                input_features=input_features)

    def _depth_embedding_sums(self, ref_codes: np.ndarray) -> np.ndarray:
        """(T, 16) reference codes -> (T, H) float32: the sum over
        codebooks 1..15 of their depth embeddings, gathered and summed on
        the device in the table's dtype (only the (T, H) result is copied
        to the host, never the (15, 2048, H) table)."""
        de = self.params["depth"]["embeds"]
        cb = np.clip(ref_codes[:, 1:self.num_code_groups], 0,
                     self.depth_vocab_size - 1)
        idx = torch.from_numpy(cb).to(de.device)
        books = torch.arange(cb.shape[1], device=de.device)[None, :]
        with torch.no_grad():
            summed = de[books, idx].sum(dim=1)
        return summed.float().cpu().numpy()

    def _extract_speaker_embedding(self, audio_path) -> np.ndarray:
        """ECAPA x-vector of the reference audio (24 kHz -> 128-bin log-mel
        -> the speaker encoder, float32 on the device); a zero vector
        without the encoder or audio."""
        if self._spk_enc_params is None or not audio_path:
            return np.zeros((self._cfg.hidden_size,), np.float32)
        audio = load_audio_mono(audio_path, target_sr=self.SAMPLE_RATE)
        mel = qwen3_speaker_mel(audio, n_mels=self._spk_enc_cfg.mel_dim)
        x = torch.from_numpy(mel.astype(np.float32))[None].to(self.device)
        with torch.no_grad():
            emb = ecapa_embed(self._spk_enc_params, self._spk_enc_cfg, x)
        return emb[0].float().cpu().numpy()

    #: valid quantizers of the 32-codebook encoder used for ICL codes
    ENCODER_VALID_QUANTIZERS = 16

    def _load_codec_encoder(self, state: dict) -> None:
        """The codec checkpoint's ``encoder.*`` Mimi model (32 codebooks of
        2048, vq_dim 256, at 24 kHz), float32 on the device; without it ICL
        needs explicit ``ref_codes``."""
        try:
            self._enc_mimi_cfg = MimiConfig(
                n_codebooks=32, codebook_size=2048, vq_dim=256,
                hidden_size=512, intermediate_size=2048, head_dim=64,
                num_heads=8, num_kv_heads=8, num_layers=8,
                sliding_window=250, num_filters=64)
            self._codec_encoder = load_mimi_encoder_params(
                state, self._enc_mimi_cfg, prefix="encoder.",
                device=self.device)
        except Exception as e:
            get_logger("qwen3").warning(
                "codec encoder mapping failed (%s); ICL needs explicit "
                "ref_codes", type(e).__name__)
            self._codec_encoder = None

    def _encode_audio_to_codes(self, audio_path) -> Optional[np.ndarray]:
        """Reference audio -> (T, 16) codec codes for ICL voice cloning:
        the 32-quantizer encoder at 24 kHz, its first 16 codebooks; None
        without the encoder (x-vector only)."""
        if self._codec_encoder is None or not audio_path:
            return None
        audio = load_audio_mono(audio_path, target_sr=self.SAMPLE_RATE)
        x = torch.from_numpy(audio)[None].to(self.device)
        with torch.no_grad():
            codes = mimi_encode(self._codec_encoder, None, self._enc_mimi_cfg,
                                x)
        return codes[0].cpu().numpy().T[:, :self.ENCODER_VALID_QUANTIZERS]

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
