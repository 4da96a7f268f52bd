"""CSM-1B TTS: a Llama-3.2-1B backbone and a 100M depth decoder over 32
Mimi codebooks (port of vox_serve_tpu/models/csm.py).

* 33 token channels (32 audio + 1 text); each step's input embedding is
  the masked sum of the per-channel embeddings: prefill text rows enable
  only the text channel, audio-context rows the 32 audio channels, decode
  steps the audio channels only
* the audio embedding is one table of 32 x 2051 rows indexed with
  codebook offsets
* the backbone samples codebook 0; the depth decoder (input projector
  2048 -> 1024, 31 per-position codebook heads applied in float32) samples
  codebooks 1..31 one after another, on the card inside the worker's
  captured decode graphs
* stop: the last audio codebook samples 0; detokenize interval 10, no
  overlap; sampling top-k 50 at T 0.9; the worker watermarks every chunk

The backbone is Llama-3.2-1B at its published widths (16 x 2048, 32 heads
over 8 KV heads, so a GQA group of 4 at head dim 64; MLP 8192, rope theta
5e5 with Llama-3.1 scaling), the depth decoder 4 x 1024 (8 heads over 2,
head dim 128), the codec Mimi at its defaults. Weights come from the
checkpoint when one resolves (the transformers ``CsmForConditionalGeneration``
layout: ``backbone_model.*``, ``depth_decoder.*``, ``embed_text_tokens``,
``lm_head``, and the Mimi codec and encoder under ``codec_model.*``), and
then the default two-speaker context is built from the snapshot's
``prompts/conversational_{a,b}.wav`` through the Mimi encoder on the
model's device. Otherwise the model serves random weights from ``seed``
with the dev tokenizer and no default context.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..codecs.mimi import (MimiConfig, init_mimi, load_mimi_encoder_params,
                           load_mimi_params, mimi_decode_chunk, mimi_encode,
                           mimi_init_cache)
from ..models.backbone import (BackboneConfig, _init_linear,
                               init_backbone_params, linear,
                               seeded_generator)
from ..models.base import BaseLMWithDepth, PreprocessOutput
from ..models.depth import (DepthConfig, depth_forward, init_depth_kv,
                            init_depth_params)
from ..sampling import SamplingConfig, sample
from ..utils import get_logger, load_audio_mono
from ..weights import (load_llama_family_backbone, load_safetensors_state,
                       load_text_tokenizer, resolve_model_dir, to_device)

AUDIO_VOCAB = 2051
TEXT_VOCAB = 128256
N_AUDIO_CB = 32
STOP_TOKEN = 0


class CSMLM(BaseLMWithDepth):
    SAMPLE_RATE = 24000
    needs_input_masks = True
    needs_watermarking = True
    watermarker_type = "silentcipher"

    def __init__(self, model_name: str = "sesame/csm-1b",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int = 0,
                 debug_backbone=None, debug_depth=None, debug_codec=None,
                 **_):
        super().__init__(model_name, dtype, device)
        self._cfg = debug_backbone or BackboneConfig(
            vocab_size=AUDIO_VOCAB, hidden_size=2048, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64,
            intermediate_size=8192, rope_theta=500_000.0,
            llama31_rope_scaling=True, dtype=dtype,
        )
        self._depth_cfg = debug_depth or DepthConfig(
            hidden_size=1024, num_layers=4, num_heads=8, num_kv_heads=2,
            head_dim=128, intermediate_size=8192, max_seq=33,
            rope_theta=500_000.0, dtype=dtype,
        )
        self._mimi_cfg = debug_codec or MimiConfig()
        self.text_tokenizer, self.assets_available = load_text_tokenizer(
            model_name, TEXT_VOCAB)
        #: Mimi encoder params (audio context); none without a checkpoint
        self.encoder_params: Optional[dict] = None
        #: default 2-speaker audio context (token rows, masks)
        self.default_context: Optional[tuple] = None
        self._init_params(seed)
        self.sampling_config = self.default_sampling_config

    def _load_checkpoint(self) -> dict | None:
        """Map the sesame/csm-1b checkpoint into the parameter tree on the
        model's device, with the Mimi codec and encoder when the snapshot
        has ``codec_model.*``; None (random init) when none resolves or the
        mapping fails."""
        model_dir = resolve_model_dir(self.model_name)
        if model_dir is None:
            return None
        try:
            state = load_safetensors_state(model_dir)
            cfg, dcfg, dev, dt = (self._cfg, self._depth_cfg, self.device,
                                  self.dtype)

            def arr(n, transpose=False):
                return to_device(state[n], dev, dt, transpose=transpose)

            params = {
                "backbone": load_llama_family_backbone(
                    state, cfg.num_layers, prefix="backbone_model.",
                    dtype=dt, device=dev),
                "audio_embed": arr(
                    "backbone_model.embed_tokens.embed_audio_tokens.weight"),
                "text_embed": arr("embed_text_tokens.weight"),
                "lm_head": arr("lm_head.weight", transpose=True),
                "depth": {
                    "backbone": load_llama_family_backbone(
                        state, dcfg.num_layers,
                        prefix="depth_decoder.model.", dtype=dt,
                        device=dev),
                    "proj": {"w": arr("depth_decoder.model."
                                      "inputs_embeds_projector.weight",
                                      transpose=True)},
                    "embeds": arr("depth_decoder.model.embed_tokens.weight"),
                    # (n_cb - 1, depth_hidden, vocab), applied as h @ W[i]
                    "heads": arr("depth_decoder.codebooks_head.weight"),
                },
            }
            codec = encoder = None
            if any(k.startswith("codec_model.") for k in state):
                try:
                    codec = load_mimi_params(state, self._mimi_cfg,
                                             prefix="codec_model.",
                                             device=dev)
                    encoder = load_mimi_encoder_params(
                        state, self._mimi_cfg, prefix="codec_model.",
                        device=dev)
                except Exception as e:
                    get_logger("csm").warning(
                        "mimi codec mapping failed (%s); random init",
                        type(e).__name__)
                    codec = encoder = None
            return {"params": params, "codec": codec, "encoder": encoder,
                    "model_dir": model_dir}
        except Exception as e:
            get_logger("csm").warning(
                "checkpoint mapping failed (%s); random init",
                type(e).__name__)
            return None

    def _init_params(self, seed: int) -> None:
        """The checkpoint when one resolves (then the default context from
        its prompt WAVs), else random init at the configured widths (the
        JAX random branch's shapes and scales; the numbers come from a
        torch generator)."""
        cfg, dcfg = self._cfg, self._depth_cfg
        dev, dt = self.device, self.dtype
        g = seeded_generator(dev, seed)
        loaded = self._load_checkpoint()
        self.backbone_loaded = loaded is not None
        if loaded is not None:
            self.params = loaded["params"]
            self.codec_assets_available = loaded["codec"] is not None
            self.codec_params = (loaded["codec"] if loaded["codec"]
                                 is not None else
                                 init_mimi(self._mimi_cfg, g, dev))
            self.encoder_params = loaded["encoder"]
            if self.encoder_params is not None:
                self.set_default_context(loaded["model_dir"])
            return
        self.assets_available = False
        self.codec_assets_available = False
        H = cfg.hidden_size

        def normal(shape):
            return (torch.randn(shape, generator=g, device=dev,
                                dtype=torch.float32) * 0.02).to(dt)

        self.params = {
            "backbone": init_backbone_params(cfg, g, dev),
            # one fused audio table (32 codebooks x 2051), backbone hidden
            "audio_embed": normal((N_AUDIO_CB * AUDIO_VOCAB, H)),
            "text_embed": normal((TEXT_VOCAB, H)),
            "lm_head": normal((H, AUDIO_VOCAB)),
            "depth": {
                "backbone": init_depth_params(dcfg, g, dev),
                "proj": _init_linear(g, H, dcfg.hidden_size, dt, dev),
                # the depth decoder's own audio table (offset codebook_idx
                # x vocab, as the backbone's), backbone hidden wide
                "embeds": normal((N_AUDIO_CB * AUDIO_VOCAB, H)),
                # per-position heads for codebooks 1..31
                "heads": normal((N_AUDIO_CB - 1, dcfg.hidden_size,
                                 AUDIO_VOCAB)),
            },
        }
        self.codec_params = init_mimi(self._mimi_cfg, g, dev)

    @property
    def checkpoint_parts(self) -> dict:
        """Which parts came from a checkpoint (True) and which from random
        init (False)."""
        return {"backbone": self.backbone_loaded,
                "codec": self.codec_assets_available,
                "codec_encoder": self.encoder_params is not None}

    # ---- metadata ----------------------------------------------------------
    @property
    def backbone_config(self):
        return self._cfg

    @property
    def depth_config(self):
        return self._depth_cfg

    @property
    def codec_config(self):
        return self._mimi_cfg

    @property
    def n_codebooks(self):
        return N_AUDIO_CB + 1

    @property
    def vocab_size(self):
        return AUDIO_VOCAB

    @property
    def detokenize_interval(self):
        return 10

    @property
    def detokenize_overlap(self):
        return 0

    @property
    def max_tokens(self):
        return 1200

    @property
    def output_audio_length(self):
        return self.detokenize_interval * self._mimi_cfg.frame_samples

    @property
    def sample_rate(self):
        return self.SAMPLE_RATE

    @property
    def default_sampling_config(self):
        return SamplingConfig(top_k=50, temperature=0.9,
                              max_tokens=self.max_tokens)

    # ---- audio context -----------------------------------------------------
    #: transcripts of the official sesame/csm-1b speaker prompts
    #: (prompts/conversational_{a,b}.wav in the snapshot)
    _PROMPT_TEXTS = (
        "like revising for an exam I'd have to try and like keep up the "
        "momentum because I'd start really early I'd be like okay I'm gonna "
        "start revising now and then like you're revising for ages and then "
        "I just like start losing steam I didn't do that for the exam we had "
        "recently to be fair that was a more of a last minute scenario but "
        "like yeah I'm trying to like yeah I noticed this yesterday that "
        "like Mondays I sort of start the day with this not like a panic "
        "but like a",
        "like a super Mario level. Like it's very like high detail. And "
        "like, once you get into the park, it just like, everything looks "
        "like a computer game and they have all these, like, you know, if, "
        "if there's like a, you know, like in a Mario game, they will have "
        "like a question block. And if you like, you know, punch it, a coin "
        "will come out. So like everyone, when they come into the park, "
        "they get like this little bracelet and then you can go punching "
        "question blocks around.",
    )

    def _encode_text_segment(self, text: str, speaker: int) -> tuple:
        ids = list(self.text_tokenizer.encode(f"[{speaker}]{text}"))
        toks = np.zeros((len(ids), 33), np.int32)
        masks = np.zeros((len(ids), 33), bool)
        toks[:, -1] = ids
        masks[:, -1] = True
        return toks, masks

    def _tokenize_audio_segment(self, audio: np.ndarray) -> tuple:
        """audio (S,) 24 kHz -> (T+1, 33) rows: Mimi codes on the 32 audio
        channels plus a trailing zero EOS frame."""
        x = torch.from_numpy(np.asarray(audio, np.float32))[None]
        with torch.no_grad():
            codes = mimi_encode(self.encoder_params, self.codec_params,
                                self._mimi_cfg, x.to(self.device))
        codes = codes[0].T.cpu().numpy()                  # (T, 32)
        codes = np.concatenate([codes, np.zeros((1, 32), codes.dtype)])
        toks = np.zeros((len(codes), 33), np.int32)
        masks = np.zeros((len(codes), 33), bool)
        toks[:, :-1] = codes
        masks[:, :-1] = True
        return toks, masks

    def set_default_context(self, model_dir) -> None:
        """The default 2-speaker context from the prompt WAVs a
        sesame/csm-1b snapshot ships (``prompts/``); nothing when a WAV is
        missing."""
        try:
            segs_t, segs_m = [], []
            for spk, name in enumerate(("conversational_a",
                                        "conversational_b")):
                wav = Path(model_dir) / "prompts" / f"{name}.wav"
                if not wav.exists():
                    return
                tt, tm = self._encode_text_segment(self._PROMPT_TEXTS[spk],
                                                   speaker=spk)
                at, am = self._tokenize_audio_segment(
                    load_audio_mono(str(wav), target_sr=self.SAMPLE_RATE))
                segs_t += [tt, at]
                segs_m += [tm, am]
            self.default_context = (np.concatenate(segs_t),
                                    np.concatenate(segs_m))
        except Exception as e:
            get_logger("csm").warning(
                "default context build failed (%s); text-only prompts",
                type(e).__name__)

    # ---- host-side ---------------------------------------------------------
    def preprocess(self, prompt=None, audio_path=None, speaker=0, **kwargs
                   ) -> PreprocessOutput:
        toks, masks = self._encode_text_segment(prompt or "", int(speaker))
        if audio_path and self.encoder_params is not None:
            at, am = self._tokenize_audio_segment(
                load_audio_mono(audio_path, target_sr=self.SAMPLE_RATE))
            toks = np.concatenate([toks, at])
            masks = np.concatenate([masks, am])
        if self.default_context is not None:
            ct, cm = self.default_context
            toks = np.concatenate([ct, toks])
            masks = np.concatenate([cm, masks])
        return PreprocessOutput(input_tokens=toks, input_masks=masks)

    def is_stop(self, token_ids: np.ndarray) -> bool:
        # the last audio codebook (index -2, before the text channel)
        return int(token_ids[-2]) == STOP_TOKEN

    # ---- step functions ----------------------------------------------------
    def embed(self, params, token_ids, features, masks):
        audio_ids = torch.clamp(token_ids[:, :-1].long(), 0, AUDIO_VOCAB - 1)
        offsets = torch.arange(N_AUDIO_CB, device=token_ids.device
                               ) * AUDIO_VOCAB
        audio_emb = params["audio_embed"][audio_ids + offsets]  # (T, 32, H)
        if masks is None:
            # decode: the audio channels only
            return audio_emb.sum(dim=1)
        text_ids = torch.clamp(token_ids[:, -1].long(), 0, TEXT_VOCAB - 1)
        text_emb = params["text_embed"][text_ids][:, None]
        all_emb = torch.cat([audio_emb, text_emb], dim=1)       # (T, 33, H)
        return torch.sum(all_emb * masks[:, :, None], dim=1)

    def logits(self, params, hidden):
        return (hidden @ params["lm_head"])[:, None, :]

    def depth_step(self, params, hidden, cb0, generator):
        """Sample codebooks 1..31 one after another; returns ((B, 33) ids
        with a zero text column, None)."""
        d = params["depth"]
        dcfg = self._depth_cfg
        B = hidden.shape[0]
        c0_embed = d["embeds"][torch.clamp(cb0.long(), 0, AUDIO_VOCAB - 1)]
        x0 = torch.stack([hidden.to(self.dtype), c0_embed], dim=1)
        x0p = linear(d["proj"], x0.reshape(B * 2, -1)).reshape(B, 2, -1)
        kc, vc = init_depth_kv(dcfg, B, hidden.device)
        db = self.prepared_depth(d["backbone"])
        h = depth_forward(db, dcfg, x0p, 0, kc, vc)
        scfg = self.sampling_config
        toks = []
        for i in range(1, N_AUDIO_CB):
            logits = h.float() @ d["heads"][i - 1].float()
            tok = sample(logits[:, None, :], scfg, generator, None)[:, 0]
            toks.append(tok)
            if i < N_AUDIO_CB - 1:  # the last codebook's forward is unused
                ci = d["embeds"][torch.clamp(tok.long(), 0, AUDIO_VOCAB - 1)
                                 + i * AUDIO_VOCAB]
                h = depth_forward(db, dcfg, linear(d["proj"], ci)[:, None],
                                  i + 1, kc, vc)
        text_col = torch.zeros((B, 1), dtype=torch.int32, device=hidden.device)
        return torch.cat([cb0[:, None].to(torch.int32),
                          torch.stack(toks, dim=1).to(torch.int32), text_col],
                         dim=1), None

    # ---- codec -------------------------------------------------------------
    def detokenize(self, codec_params, token_ids, cache):
        codes = torch.clamp(token_ids[:, :, :-1], 0, 2047).transpose(1, 2)
        return mimi_decode_chunk(codec_params, self._mimi_cfg, codes, cache)

    def init_decoder_cache(self, batch):
        return mimi_init_cache(self._mimi_cfg, batch, self.device)
