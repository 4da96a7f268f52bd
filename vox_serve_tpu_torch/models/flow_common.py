"""The detokenize path of models whose decoder is the CosyVoice flow (port of
vox_serve_tpu/models/flow_common.py): the flow (``codecs/cosyvoice_flow.py``)
and streaming HiFT (``codecs/hifigan.py``), with left-context recompute.

Per-slot codec cache (one row per slot, leading axis = slot):
  ctx_tokens (K,) int32   the rolling left context (right-aligned)
  tok_pos    ()   int32   stream tokens emitted so far
  spk        (spk_dim,)   the raw x-vector (the flow normalizes it)
  prompt_feat (P, mel)    prompt-mel anchor rows (the CFM cond); zeros
                          without a voice clone
  prompt_len ()   int32
  hift       {...}        the streaming HiFT cache

Each window re-decodes [context, window] under the streaming masks and
emits the audio of its first ``W - overlap`` tokens, so windows tile the
stream from token 0 and a window's trailing ``overlap`` tokens are real
lookahead; a catch-up window of length L (the worker's multi-chunk
windows) advances ``tok_pos`` and the context by ``L - overlap``.

The solver's start noise is drawn once per window length from the
model's seeded generator, outside any capture, into a buffer the
detokenize graphs read (``flow_noise``): no random op sits inside a graph,
and every window of one length starts from the same noise, as in the JAX
package (which draws it from ``jax.random.key(0)`` on every call).
"""

from __future__ import annotations

import torch

from ..codecs.cosyvoice_flow import CosyFlowConfig, cosy_flow_forward
from ..codecs.hifigan import hift_decode_chunk, init_hift_cache
from ..params import tree_map


def window_noise(model, n_tokens: int, frames: int) -> torch.Tensor:
    """A flow model's solver start noise (1, mel, ``frames``) for windows
    of ``n_tokens`` tokens: drawn from ``model._noise_generator`` on first
    use, outside a capture (the worker's warm-up call precedes every
    capture), kept in ``model._flow_noise`` by frame count, then reused."""
    noise = model._flow_noise.get(frames)
    if noise is None:
        if (model.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"flow noise for {n_tokens}-token windows "
                               "drawn inside a capture")
        noise = torch.randn((1, model._flow_cfg.mel_dim, frames),
                            generator=model._noise_generator,
                            device=model.device)
        # a worker that runs the codec on another card says which
        noise = noise.to(getattr(model, "codec_device", model.device))
        model._flow_noise[frames] = noise
    return noise


class CosyFlowDecodeMixin:
    """Requires: ``self._flow_cfg`` (CosyFlowConfig), ``self._hift_cfg``,
    ``self.detokenize_overlap``, ``self.device``, ``self._noise_generator``
    (a seeded generator on the device), and codec_params {"flow",
    "hift"}."""

    #: left-context tokens carried between windows (one encoder chunk)
    FLOW_CTX_TOKENS = 25
    #: static prompt-feat rows per slot (the cond anchor of a voice clone)
    FLOW_PROMPT_FRAMES = 300

    _flow_noise: dict

    def flow_noise(self, n_tokens: int) -> torch.Tensor:
        """The start noise (1, mel, 2 (K + n_tokens)) of a window of
        ``n_tokens`` tokens (``window_noise``)."""
        return window_noise(self, n_tokens, self._flow_cfg.token_mel_ratio
                            * (self.FLOW_CTX_TOKENS + n_tokens))

    def _flow_token_column(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B, W, C) -> (B, W) flow-vocab token ids."""
        return torch.clamp(token_ids[:, :, 0], 0,
                           self._flow_cfg.vocab_size - 1)

    def detokenize(self, codec_params, token_ids, cache):
        cfg: CosyFlowConfig = self._flow_cfg
        tokens = self._flow_token_column(token_ids)              # (B, W)
        B, W = tokens.shape
        K = self.FLOW_CTX_TOKENS
        step = W - self.detokenize_overlap
        r = cfg.token_mel_ratio
        dev = tokens.device

        ctx = cache["ctx_tokens"]                                # (B, K)
        tok_pos = cache["tok_pos"]                               # (B,)
        toks_in = torch.cat([ctx.to(tokens.dtype), tokens], dim=1)
        pos_tok = (tok_pos[:, None].long()
                   + torch.arange(K + W, device=dev)[None] - K)
        valid = pos_tok >= 0

        # prompt-mel cond rows where the stream's mel frame < prompt_len
        pos_mel = (torch.repeat_interleave(pos_tok, r, dim=1) * r
                   + torch.arange(r, device=dev).repeat(K + W)[None])
        pf = cache["prompt_feat"]                                # (B, P, mel)
        idx = torch.clamp(pos_mel, 0, pf.shape[1] - 1)
        conds = torch.gather(pf, 1, idx[:, :, None].expand(-1, -1,
                                                            pf.shape[2]))
        in_prompt = (pos_mel >= 0) & (pos_mel < cache["prompt_len"][:, None])
        conds = conds * in_prompt[:, :, None].to(conds.dtype)

        mel = cosy_flow_forward(codec_params["flow"], cfg, toks_in, valid,
                                cache["spk"], conds,
                                noise=self.flow_noise(W), streaming=True)
        # the window's first `step` tokens, after the K context tokens
        mel = mel[:, :, K * r: K * r + step * r]
        wav, new_hift = hift_decode_chunk(codec_params["hift"],
                                          self._hift_cfg, mel, cache["hift"])

        new_cache = dict(cache)
        new_cache["ctx_tokens"] = torch.cat(
            [ctx, tokens[:, :step].to(ctx.dtype)], dim=1)[:, -K:]
        new_cache["tok_pos"] = tok_pos + step
        new_cache["hift"] = new_hift
        return wav[:, None, :], new_cache

    def _flow_cache(self, batch: int, device) -> dict:
        cfg: CosyFlowConfig = self._flow_cfg
        return {
            "ctx_tokens": torch.zeros((batch, self.FLOW_CTX_TOKENS),
                                      dtype=torch.int32, device=device),
            "tok_pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "spk": torch.zeros((batch, cfg.spk_dim), device=device),
            "prompt_feat": torch.zeros(
                (batch, self.FLOW_PROMPT_FRAMES, cfg.mel_dim), device=device),
            "prompt_len": torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
            "hift": init_hift_cache(self._hift_cfg, batch, device),
        }

    def init_decoder_cache(self, batch):
        return self._flow_cache(batch, self.device)

    def make_flow_cache_row(self, spk=None, prompt_feat=None,
                            prompt_tokens=None) -> dict:
        """A slot's initial cache row (``PreprocessOutput.
        decoder_cache_init``, host tensors): the zero cache with the
        request's x-vector, prompt-mel anchor and prompt speech tokens.
        The prompt tokens seed the token context and offset ``tok_pos``, so
        the prompt mel rows anchor the prompt's own positions and
        generation follows them."""
        row = tree_map(lambda a: a[0], self._flow_cache(1, "cpu"))
        if spk is not None:
            row["spk"] = torch.as_tensor(spk, dtype=torch.float32
                                         ).reshape(-1)
        if prompt_tokens is not None:
            pt = torch.as_tensor(prompt_tokens).reshape(-1).long()
            pt = torch.clamp(pt, 0, self._flow_cfg.vocab_size - 1)
            K = self.FLOW_CTX_TOKENS
            k = min(pt.shape[0], K)
            if k:
                row["ctx_tokens"][K - k:] = pt[-k:].to(torch.int32)
            row["tok_pos"] = torch.tensor(int(pt.shape[0]),
                                          dtype=torch.int32)
        if prompt_feat is not None:
            pf = torch.as_tensor(prompt_feat, dtype=torch.float32)
            n = min(pf.shape[0], self.FLOW_PROMPT_FRAMES)
            row["prompt_feat"][:n] = pf[:n]
            row["prompt_len"] = torch.tensor(n, dtype=torch.int32)
        return row
