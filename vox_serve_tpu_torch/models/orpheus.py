"""Orpheus-3B TTS: Llama-3.2-3B backbone -> SNAC 24 kHz decoder (port of
vox_serve_tpu/models/orpheus.py).

* prompt = [128259] + tokenize(f"{voice}: {text}") + [128009, 128260,
  128261, 128257]
* 1 codebook; stop id 128258 (the stop token is not emitted as audio);
  detokenize interval 28 / overlap 21, so consecutive windows start 7
  tokens (one SNAC frame of 2048 samples) apart
* detokenize regroups each 28-token window into 4 frames x 7 tokens, remaps
  ids with (x - 128256 - 10) mod 4096, splits them into the 3 SNAC streams
  (columns [0] | [1, 4] | [2, 3, 5, 6]) and keeps samples [2048:4096] of
  the 8192 decoded; the codec is stateless (no per-slot cache)
* sampling defaults: top_p 0.8, T 0.6, repetition 1.3 over a global window

The backbone is Llama-3.2-3B at its published widths (28 x 3072, 24 heads
over 8 KV heads, so a GQA group of 3; head dim 128, MLP 8192, vocab
156,940, rope theta 5e5 with Llama-3.1 scaling as the JAX package has it).
The backbone, embedding and head come from the checkpoint when one
resolves (HF Llama names; a checkpoint without ``lm_head`` ties the head
to the embedding), the SNAC decoder from the hubertsiuzdak/snac_24khz
snapshot (safetensors, or its ``pytorch_model.bin``); otherwise each
serves random weights from ``seed`` (a separate embedding and head, as the
JAX package's random branch has), with the dev tokenizer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.snac import (SNACConfig, init_snac_decoder, load_snac_params,
                           snac_decode)
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..params import tree_to_torch
from ..sampling import SamplingConfig
from ..utils import get_logger
from ..weights import (load_embedding, load_head, load_llama_family_backbone,
                       load_safetensors_state, load_text_tokenizer,
                       resolve_model_dir)

VOICES = ["tara", "leah", "jess", "leo", "dan", "mia", "zac", "zoe"]

AUDIO_TOKEN_OFFSET = 128256 + 10
STOP_TOKEN = 128258
PROMPT_START = 128259
PROMPT_END = [128009, 128260, 128261, 128257]
TEXT_VOCAB = 128256


class OrpheusLM(BaseLM):
    SAMPLE_RATE = 24000

    def __init__(self, model_name: str = "canopylabs/orpheus-3b-0.1-ft",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_codec=None, **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=156940, hidden_size=3072, num_layers=28, num_heads=24,
            num_kv_heads=8, head_dim=128, intermediate_size=8192,
            rope_theta=500000.0, llama31_rope_scaling=True, dtype=dtype,
        )
        self._snac_cfg = debug_codec or SNACConfig()
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, TEXT_VOCAB)
        self._init_params(seed)
        self.sampling_config = self.default_sampling_config

    def _init_params(self, seed: int) -> None:
        """The checkpoint when one resolves, else random init at the
        configured widths (the JAX random branch's shapes and scales; the
        numbers come from a torch generator); then the SNAC decoder the
        same way."""
        cfg, dev, dt = self._cfg, self.device, self.dtype
        g = seeded_generator(dev, seed)
        self.params = self._load_params()
        self.backbone_loaded = self.params is not None
        if self.params is None:
            def normal(shape):
                return (torch.randn(shape, generator=g, device=dev,
                                    dtype=torch.float32) * 0.02).to(dt)

            self.params = {
                "backbone": init_backbone_params(cfg, g, dev),
                "embed": normal((cfg.vocab_size, cfg.hidden_size)),
                "head": normal((cfg.hidden_size, cfg.vocab_size)),
            }
            self.assets_available = False
        snac = self._load_snac()
        self.codec_assets_available = snac is not None
        self.codec_params = (snac if snac is not None else
                             init_snac_decoder(self._snac_cfg, g, dev))

    def _load_params(self) -> dict | None:
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            dev, dt = self.device, self.dtype
            return {
                "backbone": load_llama_family_backbone(
                    state, self._cfg.num_layers, dtype=dt, device=dev),
                "embed": load_embedding(state, "model.embed_tokens.weight",
                                        dt, device=dev),
                "head": load_head(state, "lm_head.weight",
                                  "model.embed_tokens.weight", dt,
                                  device=dev),
            }
        except Exception as e:
            get_logger("orpheus").warning(
                "checkpoint mapping failed (%s); random init",
                type(e).__name__)
            return None

    def _load_snac(self) -> dict | None:
        """The published SNAC decoder (hubertsiuzdak/snac_24khz: safetensors
        or ``pytorch_model.bin``), float32 on the device; None under debug
        dims or without a snapshot."""
        if self._snac_cfg != SNACConfig():
            return None  # debug dims cannot take real weights
        model_dir = resolve_model_dir("hubertsiuzdak/snac_24khz")
        if model_dir is None:
            return None
        try:
            try:
                sd = load_safetensors_state(model_dir)
            except FileNotFoundError:
                sd = torch.load(str(model_dir / "pytorch_model.bin"),
                                map_location="cpu", weights_only=True)
            sd = {k: (v.float() if v.is_floating_point() else v).numpy()
                  for k, v in sd.items()}
            return tree_to_torch(load_snac_params(sd, self._snac_cfg),
                                 self.device)
        except Exception as e:
            get_logger("orpheus").warning(
                "snac checkpoint mapping failed (%s); random init",
                type(e).__name__)
            return None

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False)."""
        return {"backbone": self.backbone_loaded,
                "codec": self.codec_assets_available}

    # ---- metadata --------------------------------------------------------
    @property
    def backbone_config(self):
        return self._cfg

    @property
    def codec_config(self):
        return self._snac_cfg

    @property
    def n_codebooks(self):
        return 1

    @property
    def vocab_size(self):
        return self._cfg.vocab_size

    @property
    def detokenize_interval(self):
        return 28

    @property
    def detokenize_overlap(self):
        return 21

    @property
    def max_tokens(self):
        return 1024

    @property
    def _decoded_window_samples(self):
        # 4 coarse codes x stride 4 = 16 latents x hop samples
        return 16 * self._snac_cfg.hop_per_latent

    @property
    def output_audio_length(self):
        # the decoded window's second quarter ([2048:4096] of 8192)
        return self._decoded_window_samples // 4

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_p=0.8, temperature=0.6,
                              repetition_penalty=1.3, repetition_window=-1,
                              max_tokens=self.max_tokens)

    # ---- host-side -------------------------------------------------------
    def preprocess(self, prompt=None, audio_path=None, voice="tara",
                   **kwargs) -> PreprocessOutput:
        if audio_path is not None:
            raise ValueError("Orpheus is TTS-only")
        if voice and voice not in VOICES:
            raise ValueError(f"voice {voice!r} not in {VOICES}")
        text = f"{voice}: {prompt}" if voice else (prompt or "")
        ids = list(self.text_tokenizer.encode(text))
        all_ids = [PROMPT_START] + ids + PROMPT_END
        return PreprocessOutput(
            input_tokens=np.asarray(all_ids, np.int32)[:, None])

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) == STOP_TOKEN

    # ---- step functions --------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        return params["embed"][token_ids[:, 0].long()]

    def logits(self, params, hidden):
        return (hidden @ params["head"])[:, None, :]

    # ---- codec -----------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        """(B, 28, 1) -> ((B, 1, 2048), None). Stateless: the windows
        overlap instead. The stream split takes columns by slices (an index
        list would be a host-to-device copy inside a captured graph)."""
        B = token_ids.shape[0]
        mf = token_ids[:, :, 0].reshape(B, 4, 7)
        mf = torch.remainder(mf - AUDIO_TOKEN_OFFSET,
                             self._snac_cfg.codebook_size)
        codes_0 = mf[:, :, 0]                                    # (B, 4)
        codes_1 = torch.stack([mf[:, :, 1], mf[:, :, 4]], dim=2
                              ).reshape(B, 8)
        codes_2 = torch.stack([mf[:, :, c] for c in (2, 3, 5, 6)], dim=2
                              ).reshape(B, 16)
        audio = snac_decode(codec_params, self._snac_cfg,
                            [codes_0, codes_1, codes_2])
        lo = self._decoded_window_samples // 4
        return audio[:, :, lo:2 * lo], None
