"""CosyVoice2-0.5B TTS: a Qwen2-0.5B backbone -> the causal flow (token ->
mel) -> the HiFT vocoder (port of vox_serve_tpu/models/cosyvoice2.py).

* prompt = [sos] + ref_text + text + [task_id] + ref_speech_tokens; every
  prompt row is embedded on the host into ``input_features`` (the LLM
  table for sos / task_id, the text table for text, the speech table for
  the reference's speech tokens) and masked so that the step takes the
  feature row
* vocab 6561 + 3; stop ids {6561, 6562, 6563}; top-k 25 at T 1.0;
  detokenize interval 28, overlap 3: 25 tokens = 50 mel frames = 24,000
  samples (1 s at 24 kHz) per window
* the decoder is the flow plus streaming HiFT with a per-slot cache
  (``models/flow_common.py``), inside the worker's detokenize graphs
* voice cloning: an uploaded reference is tokenized by S3 v2 (the prompt's
  speech tokens, at most 150) and embedded by CAMPPlus (the flow's
  x-vector); both are threaded into the slot's flow cache through
  ``decoder_cache_init``

The backbone is Qwen2-0.5B at its published widths (24 x 896, 14 query
heads over 2 KV heads, so a GQA group of 7 at head dim 64; MLP 4864; q/k/v
biases; rope theta 1e6). The LM comes from the snapshot's
``*.safetensors`` (``model.*`` layers; ``speech_embedding``,
``llm_embedding`` and ``llm_decoder`` tables), the flow from ``flow.pt``,
HiFT from ``hift.pt`` (its ``generator.`` prefix stripped), S3 v2 from
``speech_tokenizer_v2.onnx`` (else ``.safetensors``, else ``.pt``) and
CAMPPlus from ``campplus.safetensors`` (else ``.pt``, else ``.onnx``).
Each part that does not resolve or map serves random weights from
``seed`` (S3 v2 at its small dev config; without CAMPPlus the dev x-vector
encoder), as the JAX package falls back; ``checkpoint_parts`` says which
part came from where. The 151,936 x 896 text table is read on the host
only.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..codecs.cosyvoice_flow import (CosyFlowConfig, init_cosy_flow,
                                     load_cosy_flow_params)
from ..codecs.hifigan import HiFTConfig, init_hift, load_hift_params
from ..encoders.s3_exact import (S3V2Config, init_s3v2_params,
                                 load_s3v2_params)
from ..encoders.speaker import SpeakerEncoderConfig, init_speaker_encoder
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..models.flow_common import CosyFlowDecodeMixin
from ..sampling import SamplingConfig
from ..utils import get_logger, load_audio_mono
from ..weights import (load_embedding, load_head, load_llama_family_backbone,
                       load_safetensors_file, load_safetensors_state,
                       load_text_tokenizer, load_torch_part, load_torch_state,
                       resolve_model_dir, to_device)

SPEECH_TOKEN_SIZE = 6561
SOS = 0
TASK_ID = 1
STOP_IDS = (SPEECH_TOKEN_SIZE, SPEECH_TOKEN_SIZE + 1, SPEECH_TOKEN_SIZE + 2)
MAX_REF_TOKENS = 150  # the ICL prompt's speech tokens (~6 s at 25 Hz)
#: S3 v2 at the dev config serves a clone when no tokenizer resolves
S3V2_DEV = S3V2Config(n_state=256, heads=4, layers=2)

logger = get_logger("cosyvoice2")


class CosyVoice2LM(CosyFlowDecodeMixin, BaseLM):
    SAMPLE_RATE = 24000
    needs_input_features = True
    needs_input_masks = True
    supports_audio_input = True
    #: window lengths whose flow noise is drawn at build: the interval and
    #: the worker's default catch-up windows (multi-chunk k = 2 and 4)
    NOISE_WINDOWS = (28, 53, 103)

    def __init__(self, model_name: str = "FunAudioLLM/CosyVoice2-0.5B",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_flow=None, debug_hift=None,
                 **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=151936, hidden_size=896, num_layers=24, num_heads=14,
            num_kv_heads=2, intermediate_size=4864, qkv_bias=True,
            rope_theta=1_000_000.0, dtype=dtype,
        )
        self._flow_cfg = debug_flow or CosyFlowConfig()
        self._hift_cfg = debug_hift or HiFTConfig()
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, self._cfg.vocab_size)
        self._init_params(seed)
        self.sampling_config = self.default_sampling_config

    # ---- parameters --------------------------------------------------------
    def _init_params(self, seed: int) -> None:
        """Each part from the snapshot when one resolves and maps, else
        random init at the configured widths (the JAX random branch's
        shapes and scales; the numbers come from a torch generator), then
        the flow noise of the default window lengths from the same
        generator."""
        cfg, dev, dt = self._cfg, self.device, self.dtype
        g = seeded_generator(dev, seed)
        model_dir = resolve_model_dir(self.model_name)
        lm = self._load_lm(model_dir)
        self.parts = {"backbone": lm is not None}
        if lm is None:
            H = cfg.hidden_size

            def normal(shape):
                return (torch.randn(shape, generator=g, device=dev,
                                    dtype=torch.float32) * 0.02).to(dt)

            backbone = init_backbone_params(cfg, g, dev)
            text = normal((cfg.vocab_size, H))
            lm = {"backbone": backbone,
                  "speech_embed": normal((SPEECH_TOKEN_SIZE + 3, H)),
                  "llm_embed": normal((2, H)),
                  "head": normal((H, SPEECH_TOKEN_SIZE + 3))}
            lm["text_embed"] = text if dev.type == "meta" else text.cpu()
            del text
            self.assets_available = False
        #: the text table, on the host only (prompt rows are host features)
        self.text_embed = lm.pop("text_embed")
        self.params = lm

        flow = self._load_part("flow", model_dir, "flow.pt",
                               lambda sd: load_cosy_flow_params(
                                   sd, self._flow_cfg, device=dev))
        hift = self._load_part("hift", model_dir, "hift.pt",
                               lambda sd: load_hift_params(
                                   {k.replace("generator.", ""): v
                                    for k, v in sd.items()},
                                   self._hift_cfg, device=dev))
        self.codec_params = {
            "flow": flow if flow is not None else init_cosy_flow(
                self._flow_cfg, g, dev),
            "hift": hift if hift is not None else init_hift(
                self._hift_cfg, g, dev),
        }
        self._init_clone_encoders(model_dir, g)
        self._noise_generator = g
        self._flow_noise = {}
        if dev.type != "meta":
            for n in self.NOISE_WINDOWS:
                self.flow_noise(n)
        self.default_ref = {
            "ref_text_ids": np.zeros((0,), np.int32),
            "ref_speech_tokens": np.zeros((0,), np.int32),
            "spk": np.zeros((self._flow_cfg.spk_dim,), np.float32),
        }

    def _load_lm(self, model_dir) -> dict | None:
        """The LM from the snapshot's safetensors: the Qwen2 layers (q/k/v
        biases), the three speech-side tables and, on the host, the text
        table; None when nothing resolves or the mapping fails."""
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            dev, dt = self.device, self.dtype
            return {
                "backbone": load_llama_family_backbone(
                    state, self._cfg.num_layers, qkv_bias=True, dtype=dt,
                    device=dev),
                "speech_embed": load_embedding(
                    state, "speech_embedding.weight", dt, device=dev),
                "llm_embed": load_embedding(state, "llm_embedding.weight",
                                            dt, device=dev),
                "head": load_head(state, "llm_decoder.weight", dtype=dt,
                                  device=dev),
                "text_embed": to_device(state["model.embed_tokens.weight"],
                                        "cpu", dt),
            }
        except Exception as e:
            logger.warning("LM checkpoint mapping failed (%s); random init",
                           type(e).__name__)
            return None

    def _load_part(self, part: str, model_dir, filename: str, mapper):
        """One torch-format part of the snapshot, recorded in ``parts``."""
        out = load_torch_part(model_dir, filename, mapper, part)
        self.parts[part] = out is not None
        return out

    def _read_tensors(self, path: Path) -> dict:
        if path.suffix == ".onnx":
            from ..onnx_reader import load_onnx_initializers

            return load_onnx_initializers(path)
        if path.suffix == ".safetensors":
            return load_safetensors_file(path)
        return load_torch_state(path)

    def _init_clone_encoders(self, model_dir, g: torch.Generator) -> None:
        """S3 v2 (``speech_tokenizer_v2``: ``.onnx``, else ``.safetensors``,
        else ``.pt``) and CAMPPlus (``campplus``: ``.safetensors``, else
        ``.pt``, else ``.onnx``), each from the first file that maps, in the
        JAX package's order; else S3 v2's dev config and the dev x-vector
        encoder from ``g``."""
        from ..encoders.campplus import load_campplus_params

        dev = self.device
        self.s3v2 = self.campplus = None
        self.parts["s3v2"] = self.parts["campplus"] = False
        for part, stem, exts, load in (
                ("s3v2", "speech_tokenizer_v2",
                 (".onnx", ".safetensors", ".pt"),
                 lambda sd: (load_s3v2_params(sd, S3V2Config(), device=dev),
                             S3V2Config())),
                ("campplus", "campplus", (".safetensors", ".pt", ".onnx"),
                 lambda sd: load_campplus_params(sd, device=dev))):
            for ext in exts:
                path = None if model_dir is None else (
                    Path(model_dir) / (stem + ext))
                if path is None or not path.exists():
                    continue
                try:
                    setattr(self, part, load(self._read_tensors(path)))
                    self.parts[part] = True
                    break
                except Exception as e:
                    logger.warning("%s mapping from %s failed (%s)", part,
                                   path.name, type(e).__name__)
        if self.s3v2 is None:
            self.s3v2 = (init_s3v2_params(g, S3V2_DEV, dev), S3V2_DEV)
        self.spk_cfg = SpeakerEncoderConfig(n_mels=80,
                                            out_dim=self._flow_cfg.spk_dim)
        self.spk_params = None
        if self.campplus is None:
            self.spk_params = init_speaker_encoder(self.spk_cfg, g, dev)

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from the checkpoint (True) and which from random
        init (False): the LM, flow, HiFT, S3 v2 and CAMPPlus."""
        return dict(self.parts)

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
    def n_codebooks(self):
        return 1

    @property
    def vocab_size(self):
        return SPEECH_TOKEN_SIZE + 3

    @property
    def detokenize_interval(self):
        return 28

    @property
    def detokenize_overlap(self):
        return 3

    @property
    def max_tokens(self):
        return 4096

    @property
    def output_audio_length(self):
        # (interval - overlap) tokens x mel frames per token x 480 samples
        return (self.detokenize_interval - self.detokenize_overlap) * \
            self._flow_cfg.upsample * self._hift_cfg.total_upsample

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_k=25, temperature=1.0,
                              max_tokens=self.max_tokens)

    # ---- host-side ---------------------------------------------------------
    def _tokenize(self, text: str) -> list[int]:
        if hasattr(self.text_tokenizer, "encode"):
            return list(self.text_tokenizer.encode(text))
        return list(self.text_tokenizer(text))

    def preprocess(self, prompt=None, audio_path=None, ref_text=None,
                   **kwargs) -> PreprocessOutput:
        text_ids = self._tokenize(prompt or "")
        ref = self.default_ref
        if audio_path is not None:
            # a voice clone: S3 v2 prompt tokens and an x-vector; an
            # unreadable reference serves the neutral voice, as in JAX
            try:
                toks, spk = self._encode_reference(audio_path)
                ref = dict(ref, ref_speech_tokens=toks, spk=spk)
                if ref_text:
                    ref["ref_text_ids"] = np.asarray(
                        self._tokenize(ref_text), np.int32)
            except Exception as e:
                logger.warning("reference audio unreadable (%s); neutral "
                               "voice", type(e).__name__)
                ref = self.default_ref
        ref_text_ids = list(ref["ref_text_ids"])
        ref_speech = list(ref["ref_speech_tokens"])

        ids = [SOS] + ref_text_ids + text_ids + [TASK_ID] + ref_speech
        T = len(ids)
        feats = np.zeros((T, self._cfg.hidden_size), np.float32)
        llm_embed, text_tbl, speech_tbl = self._host_embed_tables
        feats[0] = llm_embed[SOS]
        pos = 1
        tids = np.asarray(ref_text_ids + text_ids, np.int64) % \
            text_tbl.shape[0]
        if len(tids):
            feats[pos:pos + len(tids)] = text_tbl[
                torch.from_numpy(tids)].float().numpy()
        pos += len(tids)
        feats[pos] = llm_embed[TASK_ID]
        pos += 1
        sids = np.asarray(ref_speech, np.int64)
        feats[pos:pos + len(sids)] = speech_tbl[sids]
        dci = None
        if np.any(np.asarray(ref["spk"])):
            dci = self.make_flow_cache_row(
                spk=ref["spk"],
                prompt_tokens=np.asarray(ref["ref_speech_tokens"],
                                         np.int64).reshape(-1))
        return PreprocessOutput(
            input_tokens=np.asarray(ids, np.int32)[:, None],
            input_masks=np.ones((T, 1), bool),  # every row takes its feature
            input_features=feats, decoder_cache_init=dci)

    @torch.no_grad()
    def _encode_reference(self, audio_path):
        """A reference WAV -> (speech tokens (<= 150,) int32, x-vector
        (spk_dim,) float32), on the model's device."""
        from ..encoders.whisper_exact import whisper_log_mel
        from ..encoders.s3_exact import s3v2_encode

        dev = self.device
        wav = load_audio_mono(audio_path, 16000)
        s3_params, s3_cfg = self.s3v2
        mel128 = torch.from_numpy(whisper_log_mel(wav, n_mels=s3_cfg.n_mels))
        toks = s3v2_encode(s3_params, s3_cfg, mel128[None].to(dev))[0]
        toks = toks.cpu().numpy().astype(np.int32) % SPEECH_TOKEN_SIZE
        if self.campplus is not None:
            from ..encoders.campplus import campplus_embed, kaldi_fbank

            feat = torch.from_numpy(kaldi_fbank(wav))[None].to(dev)
            spk = campplus_embed(self.campplus, feat)[0]
        else:
            from ..encoders.mel import MelConfig, log_mel_spectrogram
            from ..encoders.speaker import speaker_embed

            mel = log_mel_spectrogram(
                torch.from_numpy(wav)[None].to(dev),
                MelConfig(sample_rate=16000, n_mels=self.spk_cfg.n_mels))
            spk = speaker_embed(self.spk_params, self.spk_cfg, mel)[0]
        return toks[:MAX_REF_TOKENS], spk.float().cpu().numpy()

    @functools.cached_property
    def _host_embed_tables(self):
        """Host copies of the tables the prompt rows come from: the LLM and
        speech tables (float32, copied once) and the host text table."""
        return (self.params["llm_embed"].float().cpu().numpy(),
                self.text_embed,
                self.params["speech_embed"].float().cpu().numpy())

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) in STOP_IDS

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        ids = torch.clamp(token_ids[:, 0].long(), 0, SPEECH_TOKEN_SIZE + 2)
        speech = params["speech_embed"][ids]
        if masks is None or features is None:
            return speech
        return torch.where(masks[:, :1], features.to(speech.dtype), speech)

    def logits(self, params, hidden):
        return (hidden @ params["head"])[:, None, :]
