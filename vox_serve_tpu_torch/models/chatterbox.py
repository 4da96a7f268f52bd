"""Chatterbox TTS (ResembleAI): the T3 Llama backbone with learned text and
speech positions -> the S3 flow (token -> mel) -> 24 kHz HiFT, with the
Perth watermark (port of vox_serve_tpu/models/chatterbox.py).

* T3: hidden 1024, 30 layers, 16 query heads over 16 KV heads at head dim
  64, MLP 4096, Llama-3.1 rope scaling at theta 500,000; speech vocab
  6,563 (start 6561, stop 6562), text vocab 704 (start 255, stop 0);
  learned text positions (2,048 rows) and speech positions (4,096 rows)
* prompt rows = [conditioning x 34] + [start text] + text + [stop text] +
  [start speech]; every prompt row is a host-made feature row (a text row
  is ``text_emb + text_pos[i]``, the start row ``speech_emb[6561] +
  speech_pos[0]``), masked so that the step takes it; a decode step adds
  ``speech_pos[gen_idx + 1]`` to the sampled token's embedding
  (``embed_step``), inside every decode graph
* the conditioning rows: the default voice from ``conds.pt`` through the
  weight-exact encoder (``encoders/chatterbox_cond.py``); an upload's S3
  v2 tokens (at most 150) through it with the default speaker embedding;
  without ``cond_enc.*`` an upload takes the dev path (``_cond_fn``: the
  dev speaker encoder, the perceiver and the emotion row); zeros where
  neither applies
* top-p 0.95 at T 0.8 with a global repetition penalty of 1.2; windows of
  25 tokens every 22 (overlap 3): 22 tokens = 44 mel frames = 21,120
  samples; the decoder is the flow plus streaming HiFT with the flow
  cache in the slot (``models/flow_common.py``), and the worker marks
  every chunk with Perth inside the detokenize graphs

Checkpoints from the ResembleAI/chatterbox snapshot: ``t3_cfg.safetensors``
(``tfmr.*`` through the Llama mapper; ``text_emb``, ``speech_emb``,
``text_pos_emb.emb``, ``speech_pos_emb.emb``, ``speech_head``,
``cond_enc.*``), ``s3gen.safetensors`` (``flow.``, ``mel2wav.``,
``tokenizer.``, ``speaker_encoder.``) and ``conds.pt``. Each part that does
not resolve or map serves random weights from ``seed`` (S3 v2 at its dev
config; no CAMPPlus: a clone keeps the neutral decoder), as the JAX package
falls back; ``checkpoint_parts`` says which part came from where.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codecs.cosyvoice_flow import (CosyFlowConfig, init_cosy_flow,
                                     load_cosy_flow_params)
from ..codecs.hifigan import HiFTConfig, init_hift, load_hift_params
from ..encoders.chatterbox_cond import (chatterbox_cond_encode,
                                        load_chatterbox_cond_params)
from ..encoders.perceiver import (PerceiverConfig, init_perceiver,
                                  perceiver_resample)
from ..encoders.s3_exact import (S3V2Config, init_s3v2_params,
                                 load_s3v2_params)
from ..encoders.speaker import (SpeakerEncoderConfig, init_speaker_encoder,
                                speaker_embed)
from ..models.backbone import (BackboneConfig, init_backbone_params,
                               seeded_generator)
from ..models.base import BaseLM, PreprocessOutput
from ..models.flow_common import CosyFlowDecodeMixin
from ..sampling import SamplingConfig
from ..utils import get_logger, load_audio_mono
from ..weights import (load_embedding, load_head, load_llama_family_backbone,
                       load_safetensors_file, load_text_tokenizer,
                       resolve_model_dir)

SPEECH_VOCAB = 6563
START_SPEECH = 6561
STOP_SPEECH = 6562
TEXT_VOCAB = 704
START_TEXT = 255
STOP_TEXT = 0
COND_LEN = 34  # speaker + 32 prompt rows + emotion
TEXT_POS_ROWS = 2048
SPEECH_POS_ROWS = 4096
MAX_REF_TOKENS = 150  # the prompt's speech tokens (~6 s at 25 Hz)
#: the default voice's stored prompt, trimmed for constant decoder shapes
CONDS_PROMPT_TOKENS = 128
CONDS_PROMPT_FRAMES = 256
#: S3 v2 at the dev config serves a clone when no tokenizer resolves
S3V2_DEV = S3V2Config(n_state=256, heads=4, layers=2)

logger = get_logger("chatterbox")


class ChatterboxLM(CosyFlowDecodeMixin, BaseLM):
    SAMPLE_RATE = 24000
    supports_audio_input = True
    needs_input_features = True
    needs_input_masks = True
    needs_watermarking = True
    watermarker_type = "perth"
    #: window lengths whose flow noise is drawn at build: the interval and
    #: the worker's default catch-up windows (multi-chunk k = 2 and 4)
    NOISE_WINDOWS = (25, 47, 91)

    def __init__(self, model_name: str = "ResembleAI/chatterbox",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_flow=None, debug_hift=None,
                 debug_perceiver=None, **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=SPEECH_VOCAB, hidden_size=1024, num_layers=30,
            num_heads=16, num_kv_heads=16, intermediate_size=4096,
            llama31_rope_scaling=True, rope_theta=500_000.0, dtype=dtype,
        )
        self._flow_cfg = debug_flow or CosyFlowConfig(vocab_size=6561)
        self._hift_cfg = debug_hift or HiFTConfig()
        H = self._cfg.hidden_size
        self._perc_cfg = debug_perceiver or PerceiverConfig(
            in_dim=H, hidden=H, heads=self._cfg.num_heads,
            n_latents=COND_LEN - 2)
        self.spk_cfg = SpeakerEncoderConfig(out_dim=256)
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, TEXT_VOCAB)
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
        H = cfg.hidden_size
        g = seeded_generator(dev, seed)
        model_dir = resolve_model_dir(self.model_name)
        #: the weight-exact conditioning encoder (``cond_enc.*``) or None
        self.cond_enc = None
        lm = self._load_t3(model_dir)
        self.parts = {"backbone": lm is not None,
                      "cond_enc": self.cond_enc is not None}
        if lm is None:
            def normal(shape):
                return (torch.randn(shape, generator=g, device=dev,
                                    dtype=torch.float32) * 0.02).to(dt)

            lm = {"backbone": init_backbone_params(cfg, g, dev),
                  "text_embed": normal((TEXT_VOCAB, H)),
                  "speech_embed": normal((SPEECH_VOCAB, H)),
                  "text_pos": normal((TEXT_POS_ROWS, H)),
                  "speech_pos": normal((SPEECH_POS_ROWS, H)),
                  "speech_head": normal((H, SPEECH_VOCAB))}
            self.assets_available = False
        self.params = lm

        s3gen = self._read_s3gen(model_dir)
        flow = self._map_s3gen("flow", s3gen, lambda sd: load_cosy_flow_params(
            sd, self._flow_cfg, prefix="flow.", device=dev))
        hift = self._map_s3gen("hift", s3gen, lambda sd: load_hift_params(
            sd, self._hift_cfg, prefix="mel2wav.", device=dev))
        self.codec_params = {
            "flow": flow if flow is not None else init_cosy_flow(
                self._flow_cfg, g, dev),
            "hift": hift if hift is not None else init_hift(
                self._hift_cfg, g, dev),
        }
        s3 = self._map_s3gen("s3v2", s3gen, lambda sd: (load_s3v2_params(
            sd, S3V2Config(), prefix="tokenizer.", device=dev),
            S3V2Config()))
        self.s3v2 = s3 if s3 is not None else (
            init_s3v2_params(g, S3V2_DEV, dev), S3V2_DEV)
        from ..encoders.campplus import load_campplus_params

        self.campplus = self._map_s3gen(
            "campplus", s3gen, lambda sd: load_campplus_params(
                sd, prefix="speaker_encoder.", device=dev))
        del s3gen
        # the dev conditioning path (an upload without cond_enc.*)
        self.cond_params = {
            "perceiver": init_perceiver(self._perc_cfg, g, dev),
            "spk": init_speaker_encoder(self.spk_cfg, g, dev),
            "spk_proj": torch.randn((self.spk_cfg.out_dim, H), generator=g,
                                    device=dev) * 0.02,
            "emotion": torch.randn((1, H), generator=g, device=dev) * 0.02,
        }
        self.default_conds = self._load_default_conds(model_dir)
        self.parts["conds"] = self.default_conds is not None
        self._noise_generator = g
        self._flow_noise = {}
        if dev.type != "meta":
            for n in self.NOISE_WINDOWS:
                self.flow_noise(n)

    def _load_t3(self, model_dir) -> dict | None:
        """``t3_cfg.safetensors``: the backbone (``tfmr.*``), the tables and
        the head, on the device in the model's dtype; ``cond_enc.*`` into
        ``self.cond_enc`` (float32) where it maps. None when nothing
        resolves or the LM mapping fails."""
        if model_dir is None or not (model_dir / "t3_cfg.safetensors"
                                     ).exists():
            return None
        try:
            state = load_safetensors_file(model_dir / "t3_cfg.safetensors")
            dev, dt = self.device, self.dtype
            lm = {
                "backbone": load_llama_family_backbone(
                    state, self._cfg.num_layers, prefix="tfmr.", dtype=dt,
                    device=dev),
                "text_embed": load_embedding(state, "text_emb.weight", dt,
                                             device=dev),
                "speech_embed": load_embedding(state, "speech_emb.weight",
                                               dt, device=dev),
                "text_pos": load_embedding(state, "text_pos_emb.emb.weight",
                                           dt, device=dev),
                "speech_pos": load_embedding(
                    state, "speech_pos_emb.emb.weight", dt, device=dev),
                "speech_head": load_head(state, "speech_head.weight",
                                         dtype=dt, device=dev),
            }
        except Exception as e:
            logger.warning("t3 checkpoint mapping failed (%s); random init",
                           type(e).__name__)
            return None
        try:
            self.cond_enc = load_chatterbox_cond_params(state, device=dev)
        except Exception as e:
            logger.warning("cond_enc mapping failed (%s)", type(e).__name__)
        return lm

    @staticmethod
    def _read_s3gen(model_dir) -> dict | None:
        path = None if model_dir is None else model_dir / "s3gen.safetensors"
        if path is None or not path.exists():
            return None
        try:
            return load_safetensors_file(path)
        except Exception as e:
            logger.warning("s3gen.safetensors unreadable (%s)",
                           type(e).__name__)
            return None

    def _map_s3gen(self, part: str, state: dict | None, mapper):
        """One part of ``s3gen.safetensors`` through ``mapper``, recorded
        in ``parts``; None (with a warning when it does not map)."""
        out = None
        if state is not None:
            try:
                out = mapper(state)
            except Exception as e:
                logger.warning("%s mapping failed (%s); random init", part,
                               type(e).__name__)
        self.parts[part] = out is not None
        return out

    @staticmethod
    def _load_default_conds(model_dir) -> dict | None:
        """``conds.pt``: the packaged default voice ({"t3": speaker_emb,
        cond_prompt_speech_tokens, emotion_adv; "gen": prompt_token,
        prompt_feat, embedding}) as numpy, the decoder's prompt trimmed to
        128 tokens and 256 mel rows."""
        if model_dir is None or not (model_dir / "conds.pt").exists():
            return None
        try:
            kw = torch.load(model_dir / "conds.pt", map_location="cpu",
                            weights_only=True)

            def np_(d):
                return {k: (v.float().numpy() if torch.is_tensor(v)
                            and v.is_floating_point() else
                            v.numpy() if torch.is_tensor(v) else v)
                        for k, v in d.items()}

            t3, gen = np_(kw["t3"]), np_(kw["gen"])
            gen["prompt_token"] = np.asarray(
                gen["prompt_token"])[:, :CONDS_PROMPT_TOKENS]
            gen["prompt_feat"] = np.asarray(
                gen["prompt_feat"])[:, :CONDS_PROMPT_FRAMES, :]
            return {"t3": t3, "gen": gen}
        except Exception as e:
            logger.warning("conds.pt load failed (%s)", type(e).__name__)
            return None

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from the checkpoint (True) and which from random
        init (False): the T3 LM, its conditioning encoder, the flow, HiFT,
        S3 v2, CAMPPlus and the default voice (``conds``)."""
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
        return SPEECH_VOCAB

    @property
    def detokenize_interval(self):
        return 25

    @property
    def detokenize_overlap(self):
        return 3

    @property
    def max_tokens(self):
        return 1000

    @property
    def output_audio_length(self):
        return (self.detokenize_interval - self.detokenize_overlap) * \
            self._flow_cfg.upsample * self._hift_cfg.total_upsample

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_p=0.95, temperature=0.8,
                              repetition_penalty=1.2, repetition_window=-1,
                              max_tokens=self.max_tokens)

    # ---- conditioning --------------------------------------------------------
    @functools.cached_property
    def _host_embed_tables(self):
        """Host float32 copies of the four tables the prompt rows come
        from (text, text positions, speech, speech positions), made once."""
        p = self.params
        return tuple(p[k].float().cpu().numpy() for k in (
            "text_embed", "text_pos", "speech_embed", "speech_pos"))

    def _prompt_speech_rows(self, toks: np.ndarray) -> np.ndarray:
        """Speech tokens -> their embedding plus learned position rows."""
        _, _, spc, spos = self._host_embed_tables
        toks = np.asarray(toks).reshape(-1)
        return spc[toks % spc.shape[0]] + spos[:len(toks)]

    @property
    def _default_emo(self) -> float:
        if self.default_conds is None:
            return 0.5
        t3 = self.default_conds["t3"]
        return float(np.asarray(t3.get("emotion_adv", 0.5)).reshape(-1)[0])

    def _default_speaker(self) -> np.ndarray:
        t3 = (self.default_conds or {}).get("t3", {})
        return np.asarray(t3.get("speaker_emb", np.zeros(256)),
                          np.float32).reshape(-1)

    def _default_rows_for_emo(self, emo: float) -> np.ndarray:
        """(COND_LEN, H) rows of the default voice at exaggeration ``emo``:
        the stored prompt tokens (+ positions) and speaker embedding
        through the weight-exact encoder."""
        toks = self.default_conds["t3"]["cond_prompt_speech_tokens"]
        with torch.no_grad():
            rows = chatterbox_cond_encode(
                self.cond_enc, torch.from_numpy(self._default_speaker()),
                torch.from_numpy(self._prompt_speech_rows(toks)), emo)
        return rows.float().cpu().numpy()

    @functools.cached_property
    def _default_cond_rows(self) -> np.ndarray | None:
        """The default voice's rows at its stored exaggeration (served
        whenever no upload arrives); None without ``cond_enc.*`` or
        ``conds.pt``."""
        if self.cond_enc is None or self.default_conds is None:
            return None
        return self._default_rows_for_emo(self._default_emo)

    @torch.no_grad()
    def _ref_speech_tokens(self, audio_path: str) -> np.ndarray:
        """An upload -> its S3 v2 speech tokens (the snapshot's tokenizer,
        else the dev config), on the model's device."""
        from ..encoders.s3_exact import s3v2_encode
        from ..encoders.whisper_exact import whisper_log_mel

        s3_params, s3_cfg = self.s3v2
        wav16 = load_audio_mono(audio_path, 16000)
        mel = torch.from_numpy(whisper_log_mel(wav16, n_mels=s3_cfg.n_mels))
        toks = s3v2_encode(s3_params, s3_cfg, mel[None].to(self.device))
        return toks[0].cpu().numpy().astype(np.int64) % SPEECH_VOCAB

    @torch.no_grad()
    def _campplus_xvector(self, audio_path: str) -> np.ndarray | None:
        if self.campplus is None:
            return None
        from ..encoders.campplus import campplus_embed, kaldi_fbank

        feat = torch.from_numpy(kaldi_fbank(load_audio_mono(audio_path,
                                                            16000)))
        emb = campplus_embed(self.campplus, feat[None].to(self.device))[0]
        return emb.float().cpu().numpy()

    @torch.no_grad()
    def _load_ref(self, audio_path: str, toks: np.ndarray):
        """The dev path's inputs: the upload's log-mel at 24 kHz (1, 80, T)
        for the dev speaker encoder, and its first ``max_prompt`` speech
        tokens' embedding rows (1, T', H) with their mask."""
        from ..encoders.mel import MelConfig, log_mel_spectrogram

        dev = self.device
        wav = torch.from_numpy(load_audio_mono(audio_path, self.SAMPLE_RATE))
        mel = log_mel_spectrogram(wav[None].to(dev), MelConfig(
            sample_rate=self.SAMPLE_RATE, n_mels=self.spk_cfg.n_mels))
        toks = torch.from_numpy(np.asarray(toks)[:self._perc_cfg.max_prompt]
                                ).to(dev)
        feats = self.params["speech_embed"].float()[toks][None]
        return mel, feats, torch.ones(feats.shape[:2], dtype=torch.bool,
                                      device=dev)

    def _cond_fn(self, cond_params: dict, ref_mel: torch.Tensor,
                 ref_feats: torch.Tensor, ref_mask: torch.Tensor,
                 exaggeration: float) -> torch.Tensor:
        """The dev conditioning rows (COND_LEN, H) in the order [speaker,
        perceiver x n_latents, emotion]."""
        spk = speaker_embed(cond_params["spk"], self.spk_cfg, ref_mel)
        lat = perceiver_resample(cond_params["perceiver"], self._perc_cfg,
                                 ref_feats, ref_mask)[0]
        return torch.cat([spk @ cond_params["spk_proj"], lat,
                          exaggeration * cond_params["emotion"]], dim=0)

    # ---- host-side ---------------------------------------------------------
    @staticmethod
    def _punc_norm(text: str) -> str:
        if not text:
            return "You need to add some text for me to talk."
        if text[0].islower():
            text = text[0].upper() + text[1:]
        text = " ".join(text.split())
        for old, new in [("...", ", "), ("…", ", "), (":", ","), (" - ", ", "),
                         (";", ", "), ("—", "-"), ("–", "-"), (" ,", ","),
                         ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'")]:
            text = text.replace(old, new)
        text = text.rstrip(" ")
        if not any(text.endswith(p) for p in (".", "!", "?", "-", ",")):
            text += "."
        return text

    def text_ids(self, prompt: str | None) -> list[int]:
        """[start text] + the normalized text's ids (``[SPACE]`` for each
        space, modulo 704) + [stop text]."""
        text = self._punc_norm(prompt or "").replace(" ", "[SPACE]")
        enc = getattr(self.text_tokenizer, "encode", self.text_tokenizer)
        return [START_TEXT] + [t % TEXT_VOCAB for t in enc(text)] + \
            [STOP_TEXT]

    @torch.no_grad()
    def _upload_rows(self, audio_path: str, emo: float, feats: np.ndarray):
        """A voice clone: the conditioning rows into ``feats`` and the
        slot's flow cache row (None without CAMPPlus)."""
        toks = self._ref_speech_tokens(audio_path)
        if self.cond_enc is not None:
            # the upload's prompt tokens with the default voice's speaker
            # embedding (the reference never loads its own voice encoder)
            cond = chatterbox_cond_encode(
                self.cond_enc, torch.from_numpy(self._default_speaker()),
                torch.from_numpy(self._prompt_speech_rows(
                    toks[:MAX_REF_TOKENS])), emo)
        else:
            cond = self._cond_fn(self.cond_params,
                                 *self._load_ref(audio_path, toks), emo)
        feats[:COND_LEN] = cond.float().cpu().numpy()
        spk = self._campplus_xvector(audio_path)
        if spk is None:
            return None
        return self.make_flow_cache_row(spk=spk, prompt_tokens=toks)

    def preprocess(self, prompt=None, audio_path=None, exaggeration=None,
                   **kwargs) -> PreprocessOutput:
        text_ids = self.text_ids(prompt)
        T = COND_LEN + len(text_ids) + 1
        feats = np.zeros((T, self._cfg.hidden_size), np.float32)
        text_tbl, tpos_tbl, spc_tbl, spos_tbl = self._host_embed_tables
        emo = float(exaggeration if exaggeration is not None else 0.5)
        dci = None
        if audio_path is not None:
            try:
                dci = self._upload_rows(audio_path, emo, feats)
            except Exception as e:  # an unreadable upload: neutral voice
                logger.warning("reference audio unreadable (%s); neutral "
                               "voice", type(e).__name__)
        elif self._default_cond_rows is not None:
            feats[:COND_LEN] = (
                self._default_rows_for_emo(emo)
                if abs(emo - self._default_emo) > 1e-6
                else self._default_cond_rows)
            gen = self.default_conds["gen"]
            dci = self.make_flow_cache_row(
                spk=np.asarray(gen["embedding"], np.float32).reshape(-1),
                prompt_feat=np.asarray(gen["prompt_feat"], np.float32)[0],
                prompt_tokens=np.asarray(gen["prompt_token"]).reshape(-1))
        n = len(text_ids)
        feats[COND_LEN:COND_LEN + n] = text_tbl[text_ids] + tpos_tbl[:n]
        feats[COND_LEN + n] = spc_tbl[START_SPEECH] + spos_tbl[0]
        return PreprocessOutput(input_tokens=np.zeros((T, 1), np.int32),
                                input_masks=np.ones((T, 1), bool),
                                input_features=feats,
                                decoder_cache_init=dci)

    def is_stop(self, token_ids: np.ndarray) -> bool:
        return int(token_ids[0]) == STOP_SPEECH

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        ids = torch.clamp(token_ids[:, 0].long(), 0, SPEECH_VOCAB - 1)
        x = params["speech_embed"][ids]
        if masks is None or features is None:
            return x
        return torch.where(masks[:, :1], features.to(x.dtype), x)

    def embed_step(self, params, token_ids, features, masks, positions,
                   gen_idx):
        x = self.embed(params, token_ids, features, masks)
        if masks is None and gen_idx is not None:
            # decode: generated speech token g sits at speech position g + 1
            # (the start token holds position 0)
            spos = params["speech_pos"][torch.clamp(
                gen_idx.long() + 1, 0, SPEECH_POS_ROWS - 1)]
            x = x + spos.to(x.dtype)
        return x

    def logits(self, params, hidden):
        return (hidden @ params["speech_head"])[:, None, :]
