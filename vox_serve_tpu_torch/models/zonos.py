"""Zonos-v0.1 TTS: a LayerNorm transformer backbone sampling 9 codebooks
under a delay pattern -> the DAC 44.1 kHz decoder -> a 24 kHz resample
(port of vox_serve_tpu/models/zonos.py).

* backbone: hidden 2048, 26 layers, 16 query heads over 16 KV heads at head
  dim 128, MLP 8192, LayerNorm with bias at eps 1e-5, rope theta 10,000;
  9 embedding tables of 1,026 rows (1,024 codes, EOS, the mask token),
  summed; 9 heads of 1,025 ids computed in float32 (the bf16 heads cast
  in each step)
* prompt: the prefix conditioner's rows (``zonos_conditioning.py``: the
  espeak phonemes between BOS and EOS, the speaker vector or its learned
  uncond row, emotion, fmax, pitch_std, speaking_rate, language), every
  one a host-made float32 feature row; tokens all 1025, masks all set. An
  uploaded ``audio`` WAV becomes the 128-d speaker vector through the
  ResNet293 speaker net on the model's device (``encoders/zonos_speaker``);
  an unreadable upload, or no speaker net, gives the learned uncond row
* the 9 codebooks are sampled together; EOS (1024) only on codebook 0
  (a logit bias); the delay pattern masks codebooks j > ``gen_idx`` with
  1025 in ``post_sample``, inside every graph, so the fed-back row is the
  masked one (prefill's ``gen_idx`` is zeros: output 0 keeps codebook 0)
* min_p 0.1, repetition penalty 3.0 over a window of 2; windows of 50
  tokens every 41 (overlap 9), ``max_tokens`` 2048
* detokenize reverts the delay (``codes[k] = tokens[:, k : T - 9 + k, k]``,
  clamped to [0, 1023]), decodes with DAC (decoder dim 1536, rates 8/8/4/2,
  hop 512; no cache) and resamples 44.1 -> 24 kHz (windowed sinc, ceil
  length): 11,425 samples a window

Checkpoints: Zyphra/Zonos-v0.1-transformer (``backbone.*`` through
``load_zonos_backbone``, ``embeddings.{i}``, ``heads.{i}``,
``prefix_conditioner.*`` with ``config.json``'s conditioner list),
descript/dac_44khz (``load_dac_params``) and
Zyphra/Zonos-v0.1-speaker-embedding (two ``torch.save`` files). As in the
JAX package, DAC and the speaker net load only when the LM loaded, and a
part that fails to map logs a warning and serves random weights from
``seed`` (no speaker net: uploads take the uncond row).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.snac import (SNACConfig, init_snac_decoder, load_dac_params,
                           snac_decode)
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..models.zonos_conditioning import (apply_prefix_conditioner,
                                         init_conditioner_params,
                                         load_conditioner_config,
                                         load_conditioner_params,
                                         make_cond_dict)
from ..params import tree_to_torch
from ..sampling import SamplingConfig
from ..utils import get_logger, load_audio_mono
from ..watermark.silentcipher import sinc_resample
from ..weights import (load_safetensors_state, load_torch_state,
                       load_zonos_backbone, resolve_model_dir)

N_CB = 9
EOS_TOKEN = 1024
MASKED_TOKEN = 1025
LM_VOCAB = 1025  # heads predict [0..1024]; the mask token is input-only
EMBED_ROWS = 1026
DAC_ID = "descript/dac_44khz"
SPEAKER_ID = "Zyphra/Zonos-v0.1-speaker-embedding"
SPEAKER_FILES = ("ResNet293_SimAM_ASP_base.pt",
                 "ResNet293_SimAM_ASP_base_LDA-128.pt")

#: DAC 44.1 kHz in the SNAC machinery: 9 residual codebooks at unit
#: stride, hop 512
DAC_CONFIG = SNACConfig(
    sampling_rate=44100, decoder_dim=1536, decoder_rates=(8, 8, 4, 2),
    latent_dim=1024, codebook_size=1024, codebook_dim=8,
    vq_strides=(1,) * 9, noise=False, depthwise=False, attn_window_size=None,
)

logger = get_logger("zonos")


class ZonosLM(BaseLM):
    SAMPLE_RATE = 24000
    needs_input_features = True
    needs_input_masks = True
    supports_audio_input = True  # the speaker's reference audio

    def __init__(self, model_name: str = "Zyphra/Zonos-v0.1-transformer",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_codec=None, **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=LM_VOCAB, hidden_size=2048, num_layers=26,
            num_heads=16, num_kv_heads=16, intermediate_size=8192,
            use_layer_norm=True, rope_theta=10000.0, rms_eps=1e-5,
            dtype=dtype,
        )
        self._dac_cfg = debug_codec or DAC_CONFIG
        self._init_params(seed)
        self.sampling_config = self.default_sampling_config
        bias = torch.zeros((N_CB, LM_VOCAB), dtype=torch.float32,
                           device=self.device)
        bias[1:, EOS_TOKEN] = float(np.finfo(np.float32).min)
        self._eos_bias = bias

    # ---- parameters --------------------------------------------------------
    def _init_params(self, seed: int) -> None:
        """The LM snapshot when one resolves and maps (then DAC and the
        speaker net, each from its snapshot when it maps), else random init
        at the configured widths (the JAX random branch's shapes and
        scales; the numbers come from a torch generator). The conditioner
        starts from the JAX package's numpy stream (``default_rng(17)``),
        so its random rows equal JAX's."""
        cfg, dev, dt = self._cfg, self.device, self.dtype
        H = cfg.hidden_size
        g = seeded_generator(dev, seed)
        self._conditioners = load_conditioner_config(None)
        self._cond_params = init_conditioner_params(
            self._conditioners, H, np.random.default_rng(17))
        self._speaker_params = None
        self.parts = dict.fromkeys(("backbone", "codec", "speaker_encoder"),
                                   False)
        loaded = self._load_checkpoint() if H >= 1024 else None
        if loaded is not None:
            self.params = loaded
            self.parts["backbone"] = True
            dac = self._load_dac()
            self.parts["codec"] = dac is not None
            self.codec_params = (dac if dac is not None else
                                 init_snac_decoder(self._dac_cfg, g, dev))
            self._speaker_params = self._load_speaker_encoder()
            self.parts["speaker_encoder"] = self._speaker_params is not None
            return

        def normal(shape):
            return (torch.randn(shape, generator=g, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        self.params = {
            "backbone": init_backbone_params(cfg, g, dev),
            "embeds": normal((N_CB, EMBED_ROWS, H)),
            "heads": normal((N_CB, H, LM_VOCAB)),
        }
        self.codec_params = init_snac_decoder(self._dac_cfg, g, dev)
        self.assets_available = False

    def _load_checkpoint(self) -> dict | None:
        """Zyphra/Zonos-v0.1-transformer: the LayerNorm backbone, the 9
        embedding tables and heads, and the prefix conditioner with its
        ``config.json`` list (both read before either is assigned). None
        when nothing resolves, or, with a warning, when it does not map."""
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            cfg, dev, dt = self._cfg, self.device, self.dtype
            H = cfg.hidden_size
            backbone = load_zonos_backbone(
                state, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, dtype=dt, device=dev)
            embeds = torch.empty((N_CB, EMBED_ROWS, H), dtype=dt, device=dev)
            heads = torch.empty((N_CB, H, LM_VOCAB), dtype=dt, device=dev)
            for i in range(N_CB):
                embeds[i].copy_(state[f"embeddings.{i}.weight"].to(dev))
                heads[i].copy_(state[f"heads.{i}.weight"].to(dev).T)
            conditioners = load_conditioner_config(model_dir)
            cond_params = load_conditioner_params(
                {k: v.float().numpy() for k, v in state.items()
                 if k.startswith("prefix_conditioner.")}, conditioners)
        except Exception as e:
            logger.warning("checkpoint mapping failed (%s: %s); random init",
                           type(e).__name__, e)
            return None
        self._conditioners = conditioners
        self._cond_params = cond_params
        return {"backbone": backbone, "embeds": embeds, "heads": heads}

    def _load_dac(self) -> dict | None:
        """descript/dac_44khz through ``load_dac_params``, float32 on the
        device."""
        model_dir = resolve_model_dir(DAC_ID)
        if model_dir is None:
            return None
        try:
            sd = {k: v.float().numpy()
                  for k, v in load_safetensors_state(model_dir).items()}
            return tree_to_torch(load_dac_params(sd, self._dac_cfg),
                                 self.device)
        except Exception as e:
            logger.warning("DAC mapping failed (%s); random init",
                           type(e).__name__)
            return None

    def _load_speaker_encoder(self) -> dict | None:
        """Zyphra/Zonos-v0.1-speaker-embedding: the ResNet293 base and the
        LDA-128 state dicts (``torch.load(..., weights_only=True)``)."""
        model_dir = resolve_model_dir(SPEAKER_ID)
        if model_dir is None:
            return None
        try:
            from ..encoders.zonos_speaker import load_zonos_speaker_params

            sd, lda = (load_torch_state(model_dir / f) for f in SPEAKER_FILES)
            return load_zonos_speaker_params(sd, lda, device=self.device)
        except Exception as e:
            logger.warning("speaker encoder load failed (%s); the learned "
                           "uncond vector will be used", type(e).__name__)
            return None

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False): the LM (with its conditioner), DAC and the speaker
        net."""
        return dict(self.parts)

    # ---- metadata ----------------------------------------------------------
    @property
    def backbone_config(self):
        return self._cfg

    @property
    def codec_config(self):
        return self._dac_cfg

    @property
    def n_codebooks(self):
        return N_CB

    @property
    def vocab_size(self):
        return LM_VOCAB

    @property
    def detokenize_interval(self):
        return 50

    @property
    def detokenize_overlap(self):
        return 9

    @property
    def max_tokens(self):
        return 2048

    @property
    def output_audio_length(self):
        # (50 - 9) frames x hop 512 at 44.1 kHz -> 24 kHz, ceil
        frames = self.detokenize_interval - N_CB
        n44 = frames * self._dac_cfg.hop_per_latent
        return -(-n44 * 80 // 147)

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(min_p=0.1, repetition_penalty=3.0,
                              repetition_window=2, max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def _speaker_vector(self, audio_path) -> np.ndarray | None:
        """Reference speech -> the 128-d LDA vector; None (the learned
        uncond row) without a speaker net or for an unreadable upload."""
        if audio_path is None or self._speaker_params is None:
            return None
        try:
            from ..encoders.zonos_speaker import extract_speaker_embedding

            wav, sr = load_audio_mono(audio_path, target_sr=None,
                                      return_sr=True)
            return extract_speaker_embedding(self._speaker_params, wav, sr)
        except Exception as e:
            logger.warning("speaker extraction failed (%s); uncond",
                           type(e).__name__)
            return None

    def preprocess(self, prompt=None, audio_path=None, language="en-us",
                   emotion=None, fmax=None, pitch_std=None,
                   speaking_rate=None, **kwargs) -> PreprocessOutput:
        cond = make_cond_dict(
            prompt or "", language=language,
            speaker=self._speaker_vector(audio_path),
            emotion=emotion,
            **{k: float(v) for k, v in
               (("fmax", fmax), ("pitch_std", pitch_std),
                ("speaking_rate", speaking_rate)) if v is not None})
        feats = apply_prefix_conditioner(
            self._cond_params, self._conditioners, cond)  # (T, H)
        T = feats.shape[0]
        return PreprocessOutput(
            input_tokens=np.full((T, N_CB), MASKED_TOKEN, np.int32),
            input_masks=np.ones((T, N_CB), bool),
            input_features=feats.astype(np.float32))

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) == EOS_TOKEN

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        ids = torch.clamp(token_ids.long(), 0, EMBED_ROWS - 1)  # (T, 9)
        cb = torch.arange(N_CB, device=ids.device)
        x = params["embeds"][cb[None, :], ids].sum(dim=1)  # (T, H)
        if masks is not None and features is not None:
            x = torch.where(masks[:, :1], features.to(x.dtype), x)
        return x

    def logits(self, params, hidden):
        # (B, H) x (9, H, V) -> (B, 9, V), the heads cast to float32 in
        # every step, as in the JAX package
        return torch.einsum("bh,chv->bcv", hidden.float(),
                            params["heads"].float())

    def adjust_logits(self, logits):
        return logits + self._eos_bias[None]

    def post_sample(self, params, hidden, ids, generator, gen_idx=None):
        """The delay pattern: at output index g, codebooks j > g emit the
        mask token; the masked row is what the step feeds back."""
        if gen_idx is None:
            return {"sampled": ids}
        col = torch.arange(N_CB, dtype=gen_idx.dtype, device=ids.device)
        masked = torch.where(col[None, :] > gen_idx[:, None],
                             torch.full_like(ids, MASKED_TOKEN), ids)
        return {"sampled": masked}

    # ---- codec -------------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        """(B, T, 9) -> revert the delay -> DAC -> 24 kHz: ((B, 1,
        ceil((T - 9) x hop x 80 / 147)), None)."""
        T = token_ids.shape[1]
        codes = [torch.clamp(token_ids[:, k:T - N_CB + k, k], 0, 1023)
                 for k in range(N_CB)]
        wav44 = snac_decode(codec_params, self._dac_cfg, codes)
        return sinc_resample(wav44, 44100, 24000, out_len="ceil"), None
