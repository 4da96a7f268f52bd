"""Checkpoint loading (port of vox_serve_tpu/weights.py): finding a
checkpoint, reading safetensors, mapping Hugging Face layouts into the
port's stacked parameter trees, and the text tokenizer.

* ``resolve_model_dir``: a local directory, else the snapshot of the
  Hugging Face hub cache (``HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
  ``~/.cache/huggingface/hub``): ``models--{org}--{name}/refs/main`` names
  a commit and ``snapshots/<commit>/`` is its snapshot, which is what
  ``huggingface_hub.snapshot_download(local_files_only=True)`` returns.
  The cache is read directly, so ``huggingface_hub`` is not needed. The
  JAX package's ``VOX_ALLOW_DOWNLOAD`` branch is left out on purpose: the
  card has no network.
* ``load_safetensors_state`` / ``load_safetensors_file``: the port's own
  reader (an 8-byte little-endian header length, a JSON header of
  ``dtype`` / ``shape`` / ``data_offsets``, ``__metadata__`` ignored).
  Each tensor is a view over a private ``mmap`` of its file
  (``torch.frombuffer``), so nothing is read until a mapper copies it, once,
  to the model's device; BF16 is read as ``torch.bfloat16`` directly and
  never goes through numpy (which has no bfloat16 without ml_dtypes).
  ``save_safetensors`` writes the same format.
* ``load_llama_family_backbone``, ``load_embedding``, ``load_head``: HF
  Llama / Qwen2 / Qwen3 names into the tree ``init_backbone_params`` makes.
  Each stacked leaf is preallocated on the device and filled layer by
  layer; the ``(out, in)`` -> ``(in, out)`` transposes and the dtype casts
  run on the device.
* ``load_text_tokenizer``: ``transformers.AutoTokenizer`` from local files
  when ``transformers`` can be imported, else the char-level
  ``DevTokenizer`` and ``assets_available = False``.

None of ``safetensors``, ``huggingface_hub``, ``transformers``, ``yaml`` or
``ml_dtypes`` is imported at module level.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Optional

import torch

from .utils import get_logger

logger = get_logger("weights")

# ---------------------------------------------------------------------------
# finding a checkpoint
# ---------------------------------------------------------------------------


def hub_cache_dir() -> Path:
    """The Hugging Face hub cache: ``HF_HUB_CACHE``, else ``$HF_HOME/hub``,
    else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return Path(home) / "hub"


def _cached_snapshot(model_id: str) -> Optional[Path]:
    repo = hub_cache_dir() / ("models--" + model_id.replace("/", "--"))
    try:
        commit = (repo / "refs" / "main").read_text().strip()
    except OSError:
        return None
    snap = repo / "snapshots" / commit
    return snap if commit and snap.is_dir() else None


def resolve_model_dir(model_id: str) -> Optional[Path]:
    """A local directory, else the hub cache's snapshot of ``model_id``,
    else None (with the JAX package's warning: the model serves random
    init)."""
    p = Path(model_id)
    if p.is_dir():
        return p
    snap = _cached_snapshot(model_id)
    if snap is not None:
        return snap
    logger.warning("checkpoint %s unavailable locally; using random init",
                   model_id)
    return None


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_safetensors_file(path) -> dict[str, torch.Tensor]:
    """One safetensors file -> name -> CPU tensor, each a view over a
    private (copy-on-write) mmap of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        lo, hi = info["data_offsets"]
        count = (hi - lo) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                     offset=base + lo).view(shape)
    return out


def load_safetensors_state(model_dir) -> dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard of a directory, merged in sorted
    order, into one flat dict of mmap views."""
    files = sorted(Path(model_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    state: dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_safetensors_file(f))
    return state


def save_safetensors(tensors: dict[str, torch.Tensor], path) -> int:
    """Write ``tensors`` (any device) as one safetensors file, names in
    sorted order, the header padded with spaces to 8 bytes; returns the
    bytes written."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


# ---------------------------------------------------------------------------
# mappers
# ---------------------------------------------------------------------------


def to_device(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None,
              transpose: bool = False) -> torch.Tensor:
    """Copy one host tensor to ``device``, then transpose (2-D) and cast
    there; floating tensors only are cast."""
    d = t.to(device, copy=True)
    if transpose:
        d = d.T
    if dtype is not None and d.is_floating_point():
        d = d.to(dtype)
    return d.contiguous()


def _stack(state: dict, template: str, n_layers: int, device,
           transpose: bool = False, dtype=torch.bfloat16) -> torch.Tensor:
    """Stack ``template.format(i=i)`` over layers into one tensor
    preallocated on ``device``, filled layer by layer."""
    first = state[template.format(i=0)]
    shape = tuple(first.shape[::-1]) if transpose else tuple(first.shape)
    out = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
    for i in range(n_layers):
        a = state[template.format(i=i)].to(device)
        out[i].copy_(a.T if transpose else a)
    return out


def load_llama_family_backbone(state: dict, num_layers: int,
                               prefix: str = "model.",
                               qkv_bias: bool = False,
                               qk_norm: bool = False,
                               dtype: torch.dtype = torch.bfloat16, *,
                               device) -> dict:
    """Map HF Llama / Qwen2 / Qwen3 weights into the stacked backbone tree
    (``(d_in, d_out)`` linear weights, layers on a leading axis)."""
    L, p = num_layers, prefix

    def stack(name, transpose=False):
        return _stack(state, p + "layers.{i}." + name, L, device,
                      transpose=transpose, dtype=dtype)

    def lin(name, bias=False):
        d = {"w": stack(name + ".weight", transpose=True)}
        if bias:
            d["b"] = stack(name + ".bias")
        return d

    attn = {
        "q": lin("self_attn.q_proj", qkv_bias),
        "k": lin("self_attn.k_proj", qkv_bias),
        "v": lin("self_attn.v_proj", qkv_bias),
        "o": lin("self_attn.o_proj"),
    }
    if qk_norm:
        attn["q_norm"] = stack("self_attn.q_norm.weight")
        attn["k_norm"] = stack("self_attn.k_norm.weight")
    return {
        "layers": {
            "attn": attn,
            "mlp": {
                "gate": lin("mlp.gate_proj"),
                "up": lin("mlp.up_proj"),
                "down": lin("mlp.down_proj"),
            },
            "input_norm": stack("input_layernorm.weight"),
            "post_norm": stack("post_attention_layernorm.weight"),
        },
        "final_norm": to_device(state[p + "norm.weight"], device, dtype),
    }


def load_embedding(state: dict, name: str,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device) -> torch.Tensor:
    return to_device(state[name], device, dtype)


def load_head(state: dict, name: str, tied_embed: Optional[str] = None,
              dtype: torch.dtype = torch.bfloat16, *,
              device) -> torch.Tensor:
    """(V, H) HF head -> (H, V); a checkpoint without one ties it to the
    embedding."""
    if name in state:
        return to_device(state[name], device, dtype, transpose=True)
    if tied_embed is not None:
        return to_device(state[tied_embed], device, dtype, transpose=True)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


class DevTokenizer:
    """Deterministic char-level fallback tokenizer (the JAX package's
    ``DevTokenizer``). NOT the production path: models expose
    ``assets_available`` so the server can warn."""

    def __init__(self, vocab_size: int = 128000, offset: int = 64):
        self.vocab_size = vocab_size
        self.offset = offset

    def encode(self, text: str) -> list[int]:
        return [self.offset + (ord(c) * 2654435761)
                % (self.vocab_size - self.offset - 1) for c in text]

    def __call__(self, text: str):
        return self.encode(text)


#: files of which a local Hugging Face tokenizer has at least one
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                    "tokenizer.model")


def load_text_tokenizer(model_id: str, vocab_size: int):
    """(tokenizer, assets_available): the checkpoint's Hugging Face
    tokenizer from local files when ``transformers`` can be imported and
    has them, else the dev tokenizer over ``vocab_size`` ids and False.
    Where no local directory or cached snapshot holds a tokenizer file,
    ``transformers`` (whose import takes seconds) is not imported at all:
    ``from_pretrained(local_files_only=True)`` could only fail there."""
    p = Path(model_id)
    local = p if p.is_dir() else _cached_snapshot(model_id)
    if local is not None and any((local / f).exists()
                                 for f in _TOKENIZER_FILES):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_id,
                                                local_files_only=True)
            logger.info("loaded tokenizer for %s (local)", model_id)
            return tok, True
        except Exception:
            pass
    logger.warning("tokenizer for %s unavailable; dev fallback", model_id)
    return DevTokenizer(vocab_size), False
