"""Step-Audio-2-mini speech-to-speech (port of
vox_serve_tpu/models/step_audio_2.py).

* the Qwen2.5-7B-style backbone at its published widths: 28 x 3584, 28
  query heads over 4 KV heads at head dim 128 (a GQA group of 7), q/k/v
  biases, MLP 18,944, rope theta 1e6 (standard, not interleaved), RMSNorm
  eps 1e-6; vocabulary 158,720
* uploaded speech -> continuous features: the Whisper log-mel (479
  samples of right padding), the 32-layer encoder and the adaptor
  (``encoders/whisper_exact.py``, eager on the model's device in
  ``preprocess``, float32 with TF32 off) give one 3584-wide row per 80 ms;
  the prompt carries one ``<audio>`` marker (151688) per row inside the
  human turn, and the rows reach prefill through the ``input_features``
  / ``input_masks`` planes, spliced over the marker rows in ``embed``
* interleaved output: text and audio tokens in one stream; audio tokens
  sit at ids >= 151,696 and only they (minus the offset, clipped to the
  6,656-token flow vocabulary) reach the detokenizer
  (``sts_common.InterleavedAudioMixin``); stop ids {151643, 151645};
  top-p 0.9 at T 0.7 with a global repetition penalty of 1.05,
  ``max_tokens`` 2048
* the decoder: the DiT flow (``codecs/step_dit.py``, stateless per window,
  its last 3 tokens lookahead) and streaming HiFT at 24 kHz with its cache
  in the slot, inside the worker's detokenize graphs; windows of 28 tokens
  every 25 (overlap 3) = 50 mel frames = 24,000 samples

Weights: the LM (``model.*`` with q/k/v biases, ``model.embed_tokens``,
``lm_head`` or the tied embedding) and the audio encoder and adaptor
(``encoder.*``, ``adapter.*``) from the snapshot's safetensors; the flow
and HiFT from its ``token2wav/flow.pt`` and ``token2wav/hift.pt`` (under
``generator.``), the latter two only at the published flow config. As in
the JAX package, the encoder loads only where the LM maps (an LM that
does not map leaves the encoder random too), and each part that does not
resolve or map serves random weights (logged); ``checkpoint_parts`` says
which part came from where. The random backbone is drawn layer by layer
into its bf16 tensors, so no float32 temporary of a stacked 7.6B leaf is
made.

The flow's start noise is drawn once per window length at build (the
interval and the worker's catch-up windows; any other length at the
warm-up call before its capture, never inside one) into a buffer the
detokenize graphs read. Every row of a batch starts from the same noise,
where the JAX package draws (1, mel, F) from ``jax.random.key(0)`` per
call: the tests hand both packages the same ``noise``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.hifigan import (HiFTConfig, hift_decode_chunk, init_hift,
                              init_hift_cache, load_hift_params)
from ..codecs.step_dit import (StepFlowConfig, init_step_flow,
                               load_step_flow_params, step_flow_forward)
from ..encoders.whisper_exact import (StepEncConfig,
                                      init_step_encoder_params,
                                      load_step_encoder_params, step_adaptor,
                                      step_encode, whisper_log_mel)
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..models.flow_common import window_noise
from ..models.sts_common import InterleavedAudioMixin
from ..sampling import SamplingConfig
from ..utils import get_logger, load_audio_mono
from ..weights import (load_embedding, load_head, load_llama_family_backbone,
                       load_safetensors_state, load_text_tokenizer,
                       load_torch_part, resolve_model_dir)

AUDIO_MARKER = 151688
AUDIO_OFFSET = 151696
AUDIO_VOCAB = 6656
STOP_IDS = (151643, 151645)
#: the seed of the audio encoder's random init where the LM does not map
#: (the JAX package's key 41); independent of ``--seed``
ENC_SEED = 41
#: the samples of right padding before the log-mel
MEL_PADDING = 479
#: the chat template around the human turn's content
PROMPT_PRE = ("<|BOT|>system\nYou are a helpful assistant.<|EOT|>"
              "<|BOT|>human\n")
PROMPT_POST = "<|EOT|><|BOT|>assistant\n<tts_start>"

logger = get_logger("step_audio_2")


def step_audio_rows(n_samples_16k: int) -> int:
    """The adaptor rows (``<audio>`` markers) of a clip of
    ``n_samples_16k`` samples at 16 kHz: log-mel frames of the padded clip
    (less the dropped last one), conv k3 s2 pad 1, the x2 pool, the
    adaptor's conv k7 s4 pad 1."""
    frames = (n_samples_16k + MEL_PADDING) // 160
    enc = (frames - 1) // 2 + 1
    return (enc // 2 - 5) // 4 + 1


class StepAudio2LM(InterleavedAudioMixin, BaseLM):
    SAMPLE_RATE = 24000
    supports_audio_input = True
    needs_input_features = True
    needs_input_masks = True
    stop_token_ids = STOP_IDS
    audio_offset = AUDIO_OFFSET
    #: window lengths whose flow noise is drawn at build: the interval and
    #: the worker's default catch-up windows (multi-chunk k = 2 and 4)
    NOISE_WINDOWS = (28, 53, 103)

    def __init__(self, model_name: str = "stepfun-ai/Step-Audio-2-mini",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_flow=None, debug_hift=None,
                 **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=158720, hidden_size=3584, num_layers=28,
            num_heads=28, num_kv_heads=4, intermediate_size=18944,
            qkv_bias=True, rope_theta=1_000_000.0, dtype=dtype)
        self._flow_cfg = debug_flow or StepFlowConfig(vocab_size=AUDIO_VOCAB)
        self._hift_cfg = debug_hift or HiFTConfig()
        if self._cfg.hidden_size < 1024:  # debug dims
            self._enc_cfg = StepEncConfig(
                n_mels=16, d_model=64, heads=4, layers=2,
                llm_dim=self._cfg.hidden_size, adapter_hidden=32)
        else:  # the published audio_encoder_config
            self._enc_cfg = StepEncConfig(llm_dim=self._cfg.hidden_size)
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, self._cfg.vocab_size)
        self._init_params(seed, debug_backbone is None)
        self.sampling_config = self.default_sampling_config

    # ---- parameters --------------------------------------------------------
    def _init_params(self, seed: int, load_lm: bool) -> None:
        """Each part from the snapshot when it resolves and maps, else
        random init at the configured widths from ``seed`` (the encoder
        from ``ENC_SEED``); then the flow noise of the default window
        lengths. As in the JAX package, the LM (and with it the encoder)
        loads only without a debug backbone, the flow and HiFT only at the
        published flow config."""
        cfg, dev, dt = self._cfg, self.device, self.dtype
        g = seeded_generator(dev, seed)
        model_dir = resolve_model_dir(self.model_name)
        self.parts = {"backbone": False, "encoder": False}
        lm, enc = self._load_lm(model_dir) if load_lm else (None, None)
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
        self.enc_params = enc if enc is not None else \
            init_step_encoder_params(seeded_generator(dev, ENC_SEED),
                                     self._enc_cfg, dev)

        codec_dir = (model_dir if self._flow_cfg
                     == StepFlowConfig(vocab_size=AUDIO_VOCAB) else None)
        flow = self._load_part("flow", codec_dir, "token2wav/flow.pt",
                               lambda sd: load_step_flow_params(
                                   sd, self._flow_cfg, device=dev))
        hift = self._load_part("hift", codec_dir, "token2wav/hift.pt",
                               lambda sd: load_hift_params(
                                   {k.replace("generator.", ""): v
                                    for k, v in sd.items()},
                                   self._hift_cfg, device=dev))
        self.codec_params = {
            "flow": flow if flow is not None else init_step_flow(
                self._flow_cfg, g, dev),
            "hift": hift if hift is not None else init_hift(
                self._hift_cfg, g, dev),
        }
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

    def _load_lm(self, model_dir) -> tuple:
        """(LM, audio encoder): the LM from the snapshot's safetensors
        (Qwen2.5 names with q/k/v biases), then the encoder and adaptor
        from the same state; each None where it does not resolve or map,
        and the encoder is not tried where the LM does not map (as in
        JAX)."""
        if model_dir is None:
            return None, None
        try:
            state = load_safetensors_state(model_dir)
            cfg, dev, dt = self._cfg, self.device, self.dtype
            lm = {
                "backbone": load_llama_family_backbone(
                    state, cfg.num_layers, prefix="model.", qkv_bias=True,
                    dtype=dt, device=dev),
                "embed": load_embedding(state, "model.embed_tokens.weight",
                                        dt, device=dev),
                "head": load_head(state, "lm_head.weight",
                                  tied_embed="model.embed_tokens.weight",
                                  dtype=dt, device=dev),
            }
        except Exception as e:
            logger.warning("LM checkpoint mapping failed (%s); random init",
                           type(e).__name__)
            return None, None
        self.parts["backbone"] = True
        enc = None
        try:
            enc = load_step_encoder_params(state, self._enc_cfg, device=dev)
            self.parts["encoder"] = True
        except Exception as e:
            logger.warning("audio encoder mapping failed (%s); random init",
                           type(e).__name__)
        return lm, enc

    def _load_part(self, part: str, model_dir, filename: str, mapper):
        """One torch-format file of the snapshot, recorded in ``parts``."""
        out = load_torch_part(model_dir, filename, mapper, part)
        self.parts[part] = out is not None
        return out

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False): the backbone, the audio encoder (with its adaptor),
        the flow and HiFT."""
        return dict(self.parts)

    def flow_noise(self, n_tokens: int) -> torch.Tensor:
        """The solver's start noise (1, mel, 2 (n_tokens - overlap)) of a
        window of ``n_tokens`` tokens (``window_noise``)."""
        return window_noise(self, n_tokens, self._flow_cfg.token_mel_ratio
                            * (n_tokens - self.detokenize_overlap))

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
    def enc_config(self):
        return self._enc_cfg

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
        return 3

    @property
    def max_tokens(self):
        return 2048

    @property
    def output_audio_length(self):
        # (interval - overlap) tokens x 2 mel frames x 480 samples
        return (self.detokenize_interval - self.detokenize_overlap) * \
            self._flow_cfg.upsample * self._hift_cfg.total_upsample

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_p=0.9, temperature=0.7,
                              repetition_penalty=1.05, repetition_window=-1,
                              max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def _tokenize(self, text: str) -> list[int]:
        if hasattr(self.text_tokenizer, "encode"):
            return list(self.text_tokenizer.encode(text))
        return list(self.text_tokenizer(text))

    def preprocess(self, prompt=None, audio_path=None, **kwargs
                   ) -> PreprocessOutput:
        """The single-turn chat layout ``<|BOT|>system\\n...<|EOT|><|BOT|>
        human\\n{content}<|EOT|><|BOT|>assistant\\n<tts_start>``; with an
        upload the content is ``<audio_start>``, one marker per adaptor
        row, ``<audio_end>`` (any text is ignored), and the rows go into
        the feature plane under the markers."""
        enc = None
        if audio_path is not None:
            enc = self._encode_audio(audio_path)                # (T_a, H)
            mid = (self._tokenize("<audio_start>")
                   + [AUDIO_MARKER] * enc.shape[0]
                   + self._tokenize("<audio_end>"))
        else:
            mid = self._tokenize(prompt or "")
        ids = self._tokenize(PROMPT_PRE) + mid + self._tokenize(PROMPT_POST)
        T = len(ids)
        toks = np.asarray(ids, np.int32)[:, None]
        masks = np.zeros((T, 1), bool)
        feats = np.zeros((T, self._cfg.hidden_size), np.float32)
        if enc is not None:
            rows = np.nonzero(toks[:, 0] == AUDIO_MARKER)[0][:enc.shape[0]]
            feats[rows] = enc[:len(rows)]
            masks[rows] = True
        return PreprocessOutput(input_tokens=toks, input_masks=masks,
                                input_features=feats)

    @torch.no_grad()
    def _encode_audio(self, audio_path) -> np.ndarray:
        """A WAV -> (T_a, hidden) adaptor rows on the model's device."""
        wav = load_audio_mono(audio_path, 16000)
        mel = whisper_log_mel(wav, n_mels=self._enc_cfg.n_mels,
                              padding=MEL_PADDING)
        feats = step_encode(self.enc_params, self._enc_cfg,
                            torch.from_numpy(mel)[None].to(self.device),
                            valid_frames=mel.shape[1])
        out = step_adaptor(self.enc_params, self._enc_cfg, feats)[0]
        return out.float().cpu().numpy()

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        x = params["embed"][token_ids[:, 0].long()]
        if masks is None or features is None:
            return x
        # the adaptor rows over the <audio> marker rows
        return torch.where(masks[:, :1], features.to(x.dtype), x)

    def logits(self, params, hidden):
        return (hidden @ params["head"])[:, None, :]

    # ---- codec -------------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        """Each window decodes on its own through the flow, its last
        ``overlap`` tokens the pre-lookahead context; the mel of its first
        W - overlap tokens tiles the stream across windows, and phase
        continuity comes from the streaming HiFT cache."""
        tokens = torch.clamp(token_ids[:, :, 0].long() - AUDIO_OFFSET, 0,
                             AUDIO_VOCAB - 1)
        B, W = tokens.shape
        ctx = self.detokenize_overlap
        dev = tokens.device
        spk = torch.zeros((B, self._flow_cfg.spk_dim), device=dev)
        conds = torch.zeros((B, 2 * (W - ctx), self._flow_cfg.mel_dim),
                            device=dev)
        valid = torch.ones((B, W), dtype=torch.bool, device=dev)
        mel = step_flow_forward(codec_params["flow"], self._flow_cfg, tokens,
                                valid, spk, conds, noise=self.flow_noise(W),
                                context=ctx)
        wav, new_hift = hift_decode_chunk(codec_params["hift"],
                                          self._hift_cfg, mel, cache["hift"])
        return wav[:, None, :], {"hift": new_hift}

    def init_decoder_cache(self, batch):
        return {"hift": init_hift_cache(self._hift_cfg, batch, self.device)}
