"""DummyLM — a tiny, weight-free model exercising every framework path
(port of vox_serve_tpu/models/dummy.py).

Single codebook, random 2-layer backbone, a deterministic "codec" that maps
each token to a short sine burst (so audio output is checkable end to end),
and a stateful per-slot phase cache that exercises the slot-indexed codec
cache machinery.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..sampling import SamplingConfig


class DummyLM(BaseLM):
    STOP_TOKEN = 1
    SAMPLES_PER_TOKEN = 80
    #: class attr so launch's WAV-header rate resolution sees it without
    #: instantiating the model
    SAMPLE_RATE = 16000
    supports_chained_detok = True
    supports_input_streaming = True

    def __init__(self, model_name: str = "dummy",
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu", seed: int = 0,
                 max_tokens: int = 64, head_dim: int | None = None, **_):
        super().__init__(model_name, dtype, device)
        self._max_tokens = max_tokens
        self._cfg = BackboneConfig(
            vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, dtype=dtype,
            head_dim=head_dim,
        )
        g = seeded_generator(self.device, seed)
        self.params = {
            "backbone": init_backbone_params(self._cfg, g, self.device),
            "embed": (torch.randn((64, 64), generator=g, device=self.device)
                      * 0.3).to(dtype),
            "head": (torch.randn((64, 64), generator=g, device=self.device)
                     * 0.3).to(dtype),
        }
        self.codec_params = {}
        self.sampling_config = self.default_sampling_config

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_k=20, temperature=1.0,
                              max_tokens=self._max_tokens)

    # static metadata ----------------------------------------------------
    @property
    def backbone_config(self):
        return self._cfg

    @property
    def n_codebooks(self):
        return 1

    @property
    def vocab_size(self):
        return 64

    @property
    def detokenize_interval(self):
        return 4

    @property
    def detokenize_overlap(self):
        return 0

    @property
    def max_tokens(self):
        return self._max_tokens

    @property
    def output_audio_length(self):
        return self.detokenize_interval * self.SAMPLES_PER_TOKEN

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    # host-side ----------------------------------------------------------
    def preprocess(self, prompt=None, audio_path=None,
                   streaming_first_token=None, **kwargs):
        # map characters to token ids 2..63 (0 = pad, 1 = stop)
        if streaming_first_token is not None:
            ids = [int(streaming_first_token)]
        else:
            text = prompt or "hello"
            ids = [(2 + (ord(c) % 62)) for c in text][:48]
        return PreprocessOutput(
            input_tokens=np.asarray(ids, np.int32)[:, None])

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) == self.STOP_TOKEN

    def update_request_state(self, req, sampled):
        if req.is_input_streaming:
            # a streamed session ends two steps after its injected text EOS
            # (as Qwen3-TTS's trailing text does), not on a sampled stop
            req.lm_output_tokens.append(sampled)
            req.lm_output_audio_tokens.append(sampled)
            if req.eos_injected:
                req.extras["post_eos"] = req.extras.get("post_eos", 0) + 1
            if req.extras.get("post_eos", 0) >= 2:
                req.done_lm_generation = True
                req.finish_reason = "stop"
            elif self.hit_length_cap(req):
                req.done_lm_generation = True
                req.finish_reason = "length"
            return
        super().update_request_state(req, sampled)

    def text_stream_pad_token(self) -> int:
        return 0

    def text_stream_eos_token(self) -> int:
        return self.STOP_TOKEN

    def tokenize_text_stream(self, text: str) -> list[int]:
        return [(2 + (ord(c) % 62)) for c in text]

    # step functions -----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        return params["embed"][token_ids[:, 0].long()]

    def logits(self, params, hidden):
        return (hidden @ params["head"])[:, None, :]

    def detokenize(self, codec_params, token_ids, cache):
        """(B, I, 1) tokens -> sine bursts; the cache carries a running
        phase so the streaming-state path is exercised."""
        B, I, _ = token_ids.shape
        freqs = 100.0 + 20.0 * token_ids[:, :, 0].float()  # (B, I)
        freq_per_sample = torch.repeat_interleave(
            freqs, self.SAMPLES_PER_TOKEN, dim=1)
        phase0 = cache["phase"][:, None] if cache is not None else 0.0
        phase = phase0 + 2.0 * math.pi * torch.cumsum(
            freq_per_sample / self.sample_rate, dim=1)
        audio = 0.5 * torch.sin(phase)
        new_cache = None
        if cache is not None:
            new_cache = {"phase": torch.remainder(phase[:, -1],
                                                  2.0 * math.pi)}
        return audio[:, None, :], new_cache

    def init_decoder_cache(self, batch: int):
        return {"phase": torch.zeros((batch,), dtype=torch.float32,
                                     device=self.device)}
