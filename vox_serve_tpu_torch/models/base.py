"""Model abstraction (port of vox_serve_tpu/models/base.py).

A model contributes one step function ``lm_step`` (embed -> backbone ->
logits -> sampling [-> depth loop]), host-side request logic
(``preprocess``, ``update_request_state``), and a detokenize function
turning (B, chunk, C) token windows plus per-slot codec caches into PCM.
Parameters are dicts of tensors (``self.params`` for the LM,
``self.codec_params`` for the detokenizer), all on ``self.device``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..models.backbone import BackboneConfig, backbone_forward
from ..models.depth import prepare_depth_layers
from ..ops.attention import AttnMetadata
from ..requests import Request
from ..sampling import SamplingConfig, sample_and_update


@dataclasses.dataclass
class PreprocessOutput:
    """Host-side result of prompt preprocessing."""

    input_tokens: np.ndarray  # (seq, n_codebooks) int32
    input_features: Optional[np.ndarray] = None
    input_masks: Optional[np.ndarray] = None
    decoder_cache_init: Optional[Any] = None  # unbatched codec-cache row


@dataclasses.dataclass
class StepOutput:
    """Outputs of one LM step (device tensors). The KV pool is updated in
    place, so it is not returned."""

    sampled: torch.Tensor  # (B, n_codebooks) int32
    repetition_cache: Optional[torch.Tensor] = None
    feedback: Optional[torch.Tensor] = None  # (B, feedback_dim)


class BaseLM(abc.ABC):
    """Abstract model. Subclasses own their parameter dicts."""

    def __init__(self, model_name: str, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu"):
        self.model_name = model_name
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: dict = {}
        self.codec_params: dict = {}

    # ---- static metadata ------------------------------------------------
    @property
    @abc.abstractmethod
    def backbone_config(self) -> BackboneConfig: ...

    @property
    @abc.abstractmethod
    def n_codebooks(self) -> int: ...

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @property
    @abc.abstractmethod
    def detokenize_interval(self) -> int: ...

    @property
    @abc.abstractmethod
    def detokenize_overlap(self) -> int: ...

    @property
    @abc.abstractmethod
    def max_tokens(self) -> int: ...

    @property
    def n_channels(self) -> int:
        return 1

    @property
    @abc.abstractmethod
    def output_audio_length(self) -> int:
        """Samples emitted per detokenize chunk."""

    @property
    def sample_rate(self) -> int:
        return 24000

    @property
    def default_sampling_config(self) -> SamplingConfig:
        return SamplingConfig()

    # resolved by load_model (defaults + CLI overrides)
    sampling_config: SamplingConfig = SamplingConfig()

    # ---- capability flags ------------------------------------------------
    supports_audio_input: bool = False
    needs_input_features: bool = False
    needs_input_masks: bool = False
    #: dim of per-slot feedback features produced each step (0 = none)
    feedback_dim: int = 0
    #: the sampled rows ARE audio-token rows, so a fused decode can feed its
    #: frames straight into the codec (the cold-start chain)
    supports_chained_detok: bool = False
    #: serves the ``input_streaming`` scheduler (text arriving in pieces)
    supports_input_streaming: bool = False
    #: the worker watermarks every decoded chunk (``watermark/``), with the
    #: published marker of this name where its weights are loaded
    needs_watermarking: bool = False
    watermarker_type: Optional[str] = None
    #: set by the worker when the KV pool is quantized (int8/f8): static
    #: (k_scale, v_scale) dequant multipliers threaded into the backbone
    #: (ops/kv_cache.py KVCacheConfig.kv_scales)
    kv_quant_scales: Optional[tuple[float, float]] = None
    #: set by the worker of a tensor-parallel replica (``tp_size > 1``):
    #: this process's rank of the backbone (``parallel/ranks.py``
    #: ``TPGroup``), handed to ``backbone_forward``; None = whole
    tp: Any = None
    #: which parts of the model came from a checkpoint (True) and which
    #: from random init (False), by part name; empty for a weight-free model
    checkpoint_parts: dict = {}

    @property
    def use_repetition_penalty(self) -> bool:
        return self.sampling_config.uses_repetition_penalty

    # ---- host-side logic -------------------------------------------------
    @abc.abstractmethod
    def preprocess(self, prompt: str | None = None,
                   audio_path: str | None = None, **kwargs
                   ) -> PreprocessOutput:
        ...

    @abc.abstractmethod
    def is_stop(self, token_ids: np.ndarray) -> bool:
        """token_ids: (n_codebooks,) — stop-token test for one step."""

    def update_request_state(self, req: Request, sampled: np.ndarray) -> None:
        """Append one step's sampled tokens and update stop/audio state:
        every output token is an audio token; stop tokens end generation
        and are not emitted as audio."""
        req.lm_output_tokens.append(sampled)
        if self.is_stop(sampled):
            req.done_lm_generation = True
            req.finish_reason = "stop"
        else:
            # a cap-hitting token is a valid audio token — emit it
            req.lm_output_audio_tokens.append(sampled)
            if self.hit_length_cap(req):
                req.done_lm_generation = True
                req.finish_reason = "length"

    def effective_max_tokens(self, req: Request) -> int:
        mt = req.sampling_config.max_tokens if (
            req.sampling_config and req.sampling_config.max_tokens
        ) else self.sampling_config.max_tokens
        return mt or self.max_tokens

    def hit_length_cap(self, req: Request) -> bool:
        """Absolute-position length cap: stop once prompt + generated
        positions exceed max_tokens."""
        return req.next_position_id > self.effective_max_tokens(req)

    # ---- input streaming hooks ---------------------------------------------
    #: the token column that carries streamed text (Qwen3's dual channel:
    #: the last, -1)
    text_channel_index: int = 0

    def text_stream_pad_token(self) -> int:
        raise NotImplementedError

    def text_stream_eos_token(self) -> int:
        raise NotImplementedError

    def tokenize_text_stream(self, text: str) -> list[int]:
        raise NotImplementedError

    # ---- step functions -----------------------------------------------------
    @abc.abstractmethod
    def embed(self, params: dict, token_ids: torch.Tensor,
              features: torch.Tensor | None,
              masks: torch.Tensor | None) -> torch.Tensor:
        """(T, C) int [+ features/masks] -> (T, hidden)."""

    def embed_step(self, params: dict, token_ids: torch.Tensor,
                   features: torch.Tensor | None, masks: torch.Tensor | None,
                   positions: torch.Tensor,
                   gen_idx: torch.Tensor | None) -> torch.Tensor:
        """Position-aware embedding hook (Chatterbox adds its learned
        speech positions by ``gen_idx`` here); defaults to ``embed``."""
        return self.embed(params, token_ids, features, masks)

    @abc.abstractmethod
    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """(B, hidden) -> (B, C_logits, vocab)."""

    def adjust_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Hook for static logit masking (suppress tokens, EOS biasing)."""
        return logits

    def lm_step(
        self,
        params: dict,
        token_ids: torch.Tensor,          # (T, C) int
        positions: torch.Tensor,          # (T,) int
        features: torch.Tensor | None,    # (T, F) or None
        masks: torch.Tensor | None,
        meta: AttnMetadata,
        k_pages: torch.Tensor,
        v_pages: Optional[torch.Tensor],
        generator: Optional[torch.Generator],
        repetition_cache: torch.Tensor | None,
        last_token_idx: torch.Tensor | None = None,  # (B,) for prefill
        gen_idx: torch.Tensor | None = None,         # (B,) output index
    ) -> StepOutput:
        """One full LM step. Decode: T == B. Prefill: gather hidden at
        ``last_token_idx`` before the head. ``gen_idx``: each row's
        output-token index (zeros at prefill). Updates the KV pool(s) in
        place (``v_pages`` None for the combined pool)."""
        x = self.embed_step(params, token_ids, features, masks, positions,
                            gen_idx)
        h = backbone_forward(params["backbone"], self.backbone_config, x,
                             positions, meta, k_pages, v_pages,
                             kv_scales=self.kv_quant_scales, tp=self.tp)
        if last_token_idx is not None:
            h = h[last_token_idx.long()]  # (B, hidden)
        logits = self.adjust_logits(self.logits(params, h))
        ids, rep = sample_and_update(logits, self.sampling_config, generator,
                                     repetition_cache)
        out = self.post_sample(params, h, ids, generator, gen_idx=gen_idx)
        return StepOutput(sampled=out["sampled"], repetition_cache=rep,
                          feedback=out.get("feedback"))

    def post_sample(self, params: dict, hidden: torch.Tensor,
                    ids: torch.Tensor, generator: Optional[torch.Generator],
                    gen_idx: torch.Tensor | None = None) -> dict:
        """Hook for depth models (sample the remaining codebooks), feedback
        and delay patterns (by ``gen_idx``). ids: (B, C_logits) ->
        {"sampled": (B, C), ...}."""
        if ids.shape[1] == self.n_codebooks:
            return {"sampled": ids}
        pad = torch.zeros((ids.shape[0], self.n_codebooks - ids.shape[1]),
                          dtype=ids.dtype, device=ids.device)
        return {"sampled": torch.cat([ids, pad], dim=1)}

    # ---- detokenizer ---------------------------------------------------------
    @abc.abstractmethod
    def detokenize(self, codec_params: dict, token_ids: torch.Tensor,
                   cache: Any | None) -> tuple[torch.Tensor, Any | None]:
        """(B, interval, C) int + per-slot cache rows -> ((B, n_channels,
        output_audio_length) float in [-1, 1], new cache rows)."""

    def init_decoder_cache(self, batch: int) -> Any | None:
        """Batched codec cache (dict of tensors, leading dim = batch)."""
        return None


class BaseLMWithDepth(BaseLM):
    """Backbone + depth transformer over codebooks (Qwen3-TTS): depth
    "prefill" over [hidden; embed(cb0)] then one small decode per codebook,
    with a dense per-step KV (seq <= n_codebooks + 1). Logits cover
    codebook 0 only; the depth step samples the rest."""

    @property
    @abc.abstractmethod
    def depth_config(self): ...

    @abc.abstractmethod
    def depth_step(self, params: dict, hidden: torch.Tensor,
                   cb0: torch.Tensor, generator: Optional[torch.Generator]
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """hidden: (B, H) final backbone hidden; cb0: (B,) sampled codebook
        0. Returns ((B, n_codebooks) all codebook ids, feedback or None)."""

    def post_sample(self, params, hidden, ids, generator, gen_idx=None):
        all_ids, feedback = self.depth_step(params, hidden, ids[:, 0],
                                            generator)
        return {"sampled": all_ids, "feedback": feedback}

    _depth_src: Optional[dict] = None
    _depth_layers: Optional[dict] = None

    def prepared_depth(self, depth_params: dict) -> dict:
        """The depth stack with its fused q|k|v and gate|up weights,
        concatenated once per parameter set (the worker's warm-up call
        makes them before any graph capture)."""
        if self._depth_src is not depth_params:
            self._depth_layers = prepare_depth_layers(depth_params)
            self._depth_src = depth_params
        return self._depth_layers
