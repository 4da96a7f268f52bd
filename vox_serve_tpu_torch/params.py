"""Parameter conversion from the JAX package's pytrees into the port's.

Input: nested dicts/lists of numpy arrays (``np.asarray`` of each JAX leaf;
bfloat16 leaves arrive as ml_dtypes arrays). The port keeps the JAX
package's parameter layouts for every module it has — the backbone and
depth stacks (layers stacked on a leading axis, ``(d_in, d_out)`` linear
weights), the Qwen3-TTS tree around them, and the codec (torch conv
layouts) — so one leaf-wise copy converts all four:
``tree_to_torch(tree, device, dtype)``, with floating leaves cast to
``dtype`` (bf16 for the LM on the card; the codec stays float32). Used by
the tests so that both packages compute from the same weights.
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
    """Convert every leaf of a nested dict/list/tuple tree (None kept)."""
    return tree_map(lambda a: to_tensor(a, device, dtype), tree)
