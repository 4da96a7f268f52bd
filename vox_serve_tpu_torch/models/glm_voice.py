"""GLM-4-Voice-9B speech-to-speech (port of
vox_serve_tpu/models/glm_voice.py).

* the GLM-4 9B backbone at its published widths: 40 x 4096, 32 query
  heads over 2 KV heads at head dim 128 (a GQA group of 16), ChatGLM's
  interleaved partial rope over the first 64 head dims, q/k/v biases, the
  fused gate/up MLP of 13,696, RMSNorm eps 1.5625e-7; vocabulary 168,960
* uploaded speech -> Whisper-VQ tokens (``encoders/whisper_exact.py``,
  eager on the model's device in ``preprocess``) inlined into the chat
  template as ``<|audio_k|>`` strings
* interleaved output: text and audio tokens in one stream; audio tokens
  sit at ids >= 151,343 and only they (minus the offset) reach the
  detokenizer (``sts_common.InterleavedAudioMixin``); stop ids {151329,
  151336, 151338}; top-p 0.8 at T 0.8, ``max_tokens`` 2048
* the decoder: the GLM flow (``codecs/glm_flow.py``, stateless per
  window) and streaming HiFT at 22,050 Hz (two upsample levels, 256
  samples per mel frame) with its cache in the slot, inside the worker's
  detokenize graphs; windows of 25 tokens with no overlap = 172 mel frames
  = 44,032 samples

Weights: the LM from the snapshot's safetensors (the ChatGLM layout,
``weights.load_glm_backbone``), the flow and HiFT from the decoder repo
(zai-org/glm-4-voice-decoder: ``flow.pt``, ``hift.pt`` under
``generator.``), the Whisper-VQ encoder from the tokenizer repo
(zai-org/glm-4-voice-tokenizer, safetensors). Each part that does not
resolve or map serves random weights (logged), as the JAX package falls
back; ``checkpoint_parts`` says which part came from where. The random
backbone is drawn layer by layer into its bf16 tensors, so no float32
temporary of a stacked 9B leaf is made.

The flow's start noise is drawn once per window length at build (the
interval and the worker's catch-up windows; any other length at the
warm-up call before its capture, never inside one) into a buffer the
detokenize graphs read. Every row of a batch starts from the same noise,
where the JAX package draws (B, mel, F) from ``jax.random.key(0)`` per
call: the tests hand both packages the same ``noise``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.glm_flow import (GLMFlowConfig, glm_flow_forward, init_glm_flow,
                               load_glm_flow_params)
from ..codecs.hifigan import (HiFTConfig, hift_decode_chunk, init_hift,
                              init_hift_cache, load_hift_params)
from ..encoders.whisper_exact import (GLMVQConfig, glm_vq_encode,
                                      init_glm_vq_params, load_glm_vq_params,
                                      whisper_log_mel)
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..models.flow_common import window_noise
from ..models.sts_common import InterleavedAudioMixin
from ..sampling import SamplingConfig
from ..utils import get_logger, load_audio_mono
from ..weights import (load_embedding, load_glm_backbone, load_head,
                       load_safetensors_state, load_text_tokenizer,
                       load_torch_part, resolve_model_dir)

STOP_IDS = (151329, 151336, 151338)
AUDIO_OFFSET = 151343  # the id of "<|audio_0|>" in the published vocabulary
AUDIO_VOCAB = 16384
#: the seed of the Whisper-VQ encoder's random init where no tokenizer
#: resolves (the JAX package's key 47); independent of ``--seed``
VQ_SEED = 47
#: the Whisper-VQ encoder at the debug widths (a debug backbone)
VQ_DEBUG = GLMVQConfig(n_mels=16, d_model=64, heads=4, ffn=128, layers=2,
                       block=8, vocab=16384, max_positions=256)

logger = get_logger("glm_voice")


def glm_prompt_text(prompt: str | None, speech_tokens=None) -> str:
    """The chat template: text mode, or audio mode with the speech tokens
    inlined as ``<|audio_k|>`` strings."""
    if speech_tokens is not None:
        user = ("<|begin_of_audio|>"
                + "".join(f"<|audio_{int(t)}|>" for t in speech_tokens)
                + "<|end_of_audio|>")
    else:
        user = prompt or ""
    system = ("User will provide you with a "
              f"{'speech' if speech_tokens is not None else 'text'} "
              "instruction. Do it step by step. First, think about the "
              "instruction and respond in a interleaved manner, with 13 "
              "text token followed by 26 audio tokens. ")
    return (f"<|system|>\n{system}<|user|>\n{user}"
            "<|assistant|>streaming_transcription\n")


@torch.no_grad()
def encode_speech_tokens(params: dict, cfg: GLMVQConfig, audio_path: str,
                         device) -> np.ndarray:
    """A WAV -> discrete speech tokens at 12.5 Hz through the Whisper-VQ
    encoder on ``device``: the mel frames padded to the x8 token stride,
    the padding masked as keys, the tokens trimmed back to the valid
    span."""
    wav = load_audio_mono(audio_path, 16000)
    mel = whisper_log_mel(wav, n_mels=cfg.n_mels)
    valid = mel.shape[1]
    pad = (-valid) % 8
    if pad:
        mel = np.pad(mel, ((0, 0), (0, pad)))
    tokens = glm_vq_encode(params, cfg, torch.from_numpy(mel)[None].to(device),
                           valid_frames=(valid + 1) // 2)
    return tokens[0, :(valid + 7) // 8].cpu().numpy().astype(np.int32)


class GLMVoiceLM(InterleavedAudioMixin, BaseLM):
    SAMPLE_RATE = 22050
    supports_audio_input = True
    stop_token_ids = STOP_IDS
    audio_offset = AUDIO_OFFSET
    #: the decoder's and the speech tokenizer's own repos
    DECODER_REPO = "zai-org/glm-4-voice-decoder"
    ENCODER_REPO = "zai-org/glm-4-voice-tokenizer"
    #: window lengths whose flow noise is drawn at build: the interval and
    #: the worker's default catch-up windows (multi-chunk k = 2 and 4)
    NOISE_WINDOWS = (25, 50, 100)

    def __init__(self, model_name: str = "zai-org/glm-4-voice-9b",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_flow=None, debug_hift=None,
                 **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=168960, hidden_size=4096, num_layers=40,
            num_heads=32, num_kv_heads=2, head_dim=128,
            intermediate_size=13696, qkv_bias=True, rope_theta=10000.0,
            rope_dim=64, rope_interleaved=True, rms_eps=1.5625e-07,
            dtype=dtype)
        self._flow_cfg = debug_flow or GLMFlowConfig(vocab_size=AUDIO_VOCAB)
        self._hift_cfg = debug_hift or HiFTConfig(
            sampling_rate=22050, upsample_rates=(8, 8),
            upsample_kernel_sizes=(16, 16),
            source_resblock_kernel_sizes=(7, 11))
        self._enc_cfg = (VQ_DEBUG if self._cfg.hidden_size < 1024
                         else GLMVQConfig())
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, self._cfg.vocab_size)
        self._init_params(seed, debug_backbone is None)
        self.sampling_config = self.default_sampling_config

    # ---- parameters --------------------------------------------------------
    def _init_params(self, seed: int, load_lm: bool) -> None:
        """Each part from its repo when one resolves and maps, else random
        init at the configured widths from ``seed`` (the Whisper-VQ encoder
        from ``VQ_SEED``); then the flow noise of the default window
        lengths. As in the JAX package, the LM loads only without a debug
        backbone, the decoder only at the published flow config, the
        encoder only at a backbone width of 1024 or more."""
        cfg, dev, dt = self._cfg, self.device, self.dtype
        g = seeded_generator(dev, seed)
        lm = self._load_lm() if load_lm else None
        self.parts = {"backbone": lm is not None}
        if lm is None:
            if load_lm:
                self.assets_available = False

            def normal(shape):
                out = torch.empty(shape, dtype=dt, device=dev)
                if dev.type != "meta":
                    out.copy_(torch.randn(shape, generator=g, device=dev)
                              * 0.02)
                return out

            lm = {"backbone": init_backbone_params(cfg, g, dev,
                                                   layerwise=True),
                  "embed": normal((cfg.vocab_size, cfg.hidden_size)),
                  "head": normal((cfg.hidden_size, cfg.vocab_size))}
        self.params = lm

        flow, hift = self._load_decoder()
        self.codec_params = {
            "flow": flow if flow is not None else init_glm_flow(
                self._flow_cfg, g, dev),
            "hift": hift if hift is not None else init_hift(
                self._hift_cfg, g, dev),
        }
        self.vq_params = self._load_vq()
        self._noise_generator = g
        self._flow_noise: dict = {}
        if dev.type != "meta":
            for n in self.NOISE_WINDOWS:
                self.flow_noise(n)
        if dev.type == "cuda":
            logger.info(
                "after init: max_memory_allocated %.2f GB, memory_reserved "
                "%.2f GB", torch.cuda.max_memory_allocated(dev) / 1e9,
                torch.cuda.memory_reserved(dev) / 1e9)

    def _load_lm(self) -> dict | None:
        """The LM from the snapshot's safetensors (the ChatGLM layout);
        None when nothing resolves or the mapping fails."""
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            cfg, dev, dt = self._cfg, self.device, self.dtype
            return {
                "backbone": load_glm_backbone(
                    state, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim, dtype=dt, device=dev),
                "embed": load_embedding(
                    state, "transformer.embedding.word_embeddings.weight",
                    dt, device=dev),
                "head": load_head(state, "transformer.output_layer.weight",
                                  dtype=dt, device=dev),
            }
        except Exception as e:
            logger.warning("LM checkpoint mapping failed (%s); random init",
                           type(e).__name__)
            return None

    def _load_decoder(self) -> tuple:
        """(flow, hift) from the decoder repo (each None where it does not
        resolve or map); only at the published flow config."""
        dev = self.device
        dec_dir = (resolve_model_dir(self.DECODER_REPO) if self._flow_cfg
                   == GLMFlowConfig(vocab_size=AUDIO_VOCAB) else None)
        flow = self._load_part("flow", dec_dir, "flow.pt",
                               lambda sd: load_glm_flow_params(
                                   sd, self._flow_cfg, device=dev))
        hift = self._load_part("hift", dec_dir, "hift.pt",
                               lambda sd: load_hift_params(
                                   {k.replace("generator.", ""): v
                                    for k, v in sd.items()},
                                   self._hift_cfg, device=dev))
        return flow, hift

    def _load_part(self, part: str, model_dir, filename: str, mapper):
        """One torch-format file of the decoder repo, recorded in
        ``parts``."""
        out = load_torch_part(model_dir, filename, mapper, part)
        self.parts[part] = out is not None
        return out

    def _load_vq(self) -> dict:
        """The Whisper-VQ encoder from the tokenizer repo's safetensors,
        else random init from ``VQ_SEED`` at ``self._enc_cfg``."""
        self.parts["vq_encoder"] = False
        model_dir = (resolve_model_dir(self.ENCODER_REPO)
                     if self._cfg.hidden_size >= 1024 else None)
        if model_dir is not None:
            try:
                params = load_glm_vq_params(load_safetensors_state(model_dir),
                                            self._enc_cfg, device=self.device)
                self.parts["vq_encoder"] = True
                return params
            except Exception as e:
                logger.warning("Whisper-VQ mapping failed (%s); random init",
                               type(e).__name__)
        return init_glm_vq_params(seeded_generator(self.device, VQ_SEED),
                                  self._enc_cfg, self.device)

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False): the backbone, flow, HiFT and the Whisper-VQ
        encoder."""
        return dict(self.parts)

    def flow_noise(self, n_tokens: int) -> torch.Tensor:
        """The solver's start noise (1, mel, feat_len(n_tokens)) of a
        window of ``n_tokens`` tokens: drawn on first use, outside a
        capture (the worker's warm-up call precedes every capture), then
        reused."""
        return window_noise(self, n_tokens, self._flow_cfg.feat_len(n_tokens))

    # ---- metadata ----------------------------------------------------------
    @property
    def backbone_config(self):
        return self._cfg

    @property
    def flow_config(self):
        return self._flow_cfg

    @property
    def hift_config(self):
        return self._hift_cfg

    @property
    def vq_config(self):
        return self._enc_cfg

    @property
    def n_codebooks(self):
        return 1

    @property
    def vocab_size(self):
        return self._cfg.vocab_size

    @property
    def detokenize_interval(self):
        return 25

    @property
    def detokenize_overlap(self):
        return 0

    @property
    def max_tokens(self):
        return 2048

    @property
    def output_audio_length(self):
        # feat_len(interval) mel frames x 256 samples a frame at 22.05 kHz
        return self._flow_cfg.feat_len(self.detokenize_interval) * \
            self._hift_cfg.total_upsample

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_p=0.8, temperature=0.8,
                              max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def preprocess(self, prompt=None, audio_path=None, **kwargs
                   ) -> PreprocessOutput:
        toks = (self._encode_audio_tokens(audio_path)
                if audio_path is not None else None)
        text = glm_prompt_text(prompt, toks)
        if hasattr(self.text_tokenizer, "encode"):
            ids = list(self.text_tokenizer.encode(text))
        else:
            ids = list(self.text_tokenizer(text))
        return PreprocessOutput(
            input_tokens=np.asarray(ids, np.int32)[:, None])

    def _encode_audio_tokens(self, audio_path) -> np.ndarray:
        return encode_speech_tokens(self.vq_params, self._enc_cfg,
                                    audio_path, self.device)

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        return params["embed"][token_ids[:, 0].long()]

    def logits(self, params, hidden):
        return (hidden @ params["head"])[:, None, :]

    # ---- codec -------------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        """Each window decodes on its own through the flow (stateless per
        window); phase continuity across windows comes from the streaming
        HiFT cache."""
        tokens = torch.clamp(token_ids[:, :, 0].long() - AUDIO_OFFSET, 0,
                             AUDIO_VOCAB - 1)
        B, W = tokens.shape
        spk = torch.zeros((B, self._flow_cfg.spk_dim), device=tokens.device)
        mel = glm_flow_forward(codec_params["flow"], self._flow_cfg, tokens,
                               spk, noise=self.flow_noise(W))
        wav, new_hift = hift_decode_chunk(codec_params["hift"],
                                          self._hift_cfg, mel, cache["hift"])
        return wav[:, None, :], {"hift": new_hift}

    def init_decoder_cache(self, batch):
        return {"hift": init_hift_cache(self._hift_cfg, batch, self.device)}
