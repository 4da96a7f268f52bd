"""Parameter conversion from the JAX package's pytrees into the port's.

Input: nested dicts/lists of numpy arrays (``np.asarray`` of each JAX leaf;
bfloat16 leaves arrive as ml_dtypes arrays). The port keeps the JAX
package's parameter layouts for every module it has — the backbone and
depth stacks (layers stacked on a leading axis, ``(d_in, d_out)`` linear
weights), the model trees around them (Qwen3-TTS, GLM-4-Voice's embedding
and head), the codecs and flows (torch conv layouts; the GLM flow's lists
of conformer and U-Net blocks; Step-Audio 2's flow: the Cosy encoder
section and the DiT's list of blocks) and the encoders (the Whisper-VQ
encoder's and Step-Audio 2's audio encoder's lists of layers with ``(out,
in)`` linear weights, the adaptor) — so one leaf-wise copy converts all
of them:
``tree_to_torch(tree, device, dtype)``, with floating leaves cast to
``dtype`` (bf16 for the LM on the card; the codec stays float32) but for
the float32 scales of an int8-quantized linear (``w_s``). Used by the
tests so that both packages compute from the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_tensor(a: Any, device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """One numpy leaf -> torch tensor on ``device``; floating leaves are
    cast to ``dtype`` when given, integer/bool leaves keep theirs."""
    a = np.array(a)  # a writable, contiguous copy (JAX leaves are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of equally shaped dict/list/tuple trees
    (None leaves stay None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree (None leaves skipped), in tree_map order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_to_torch(tree: Any, device, dtype: torch.dtype | None = None) -> Any:
    """Convert every leaf of a nested dict/list/tuple tree (None kept);
    floating leaves are cast to ``dtype``, except an int8-quantized
    linear's ``w_s`` (its per-channel scales, float32 in JAX whatever the
    model's dtype), and integer leaves (``w_q``) keep theirs."""
    if isinstance(tree, dict):
        return {k: (to_tensor(v, device) if k == "w_s" and v is not None
                    else tree_to_torch(v, device, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return to_tensor(tree, device, dtype)
