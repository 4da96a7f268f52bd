"""Tensor-parallel rules for the backbone's parameter tree (port of
vox_serve_tpu/parallel/sharding.py).

Megatron-style, as in the JAX package: attention q/k/v and MLP gate/up
split their *output* features over the ``tp`` ranks (each rank owns a
slice of the heads and of the MLP width), o and down their *input*
features, so each layer needs one all-reduce after o and one after down
(``models/backbone.py``). Per-output scales and biases follow their
features: split with q/k/v and gate/up, whole on every rank for o and
down (a row-parallel bias is added once, after the reduce). Norms, q/k
norms, LayerNorm biases and every other leaf are whole on every rank.
Stacked leaves keep their leading layer axis whole.

The rules are a tree of the parameter tree's structure whose leaves name
the axis a leaf splits on, or None (``backbone_param_shardings``), where
the JAX package gives ``NamedSharding``s. ``shard_params`` cuts one rank's
tree from them.

The KV heads (``tp_heads``, ``kv_heads_of``): with ``KH % tp == 0`` each
rank holds ``KH / tp`` of them, the JAX package's sharded pool. With ``tp
% KH == 0`` (fewer KV heads than ranks) rank r holds the one KV head its
``H / tp`` query heads read, ``r // (tp / KH)``, with its k/v projection
columns; the JAX package replicates the whole pool there instead. Every
other ``tp`` raises, as does ``H % tp != 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: the linears of a layer by part, and whether each is column-parallel
LINEARS = {"attn": {"q": True, "k": True, "v": True, "o": False},
           "mlp": {"gate": True, "up": True, "down": False}}


def tp_heads(num_heads: int, num_kv_heads: int, tp: int) -> tuple[int, int]:
    """(query heads, KV heads) of one rank of ``tp``."""
    H, KH = num_heads, num_kv_heads
    if tp < 1:
        raise ValueError(f"tp={tp}: needs at least one rank")
    if H % tp:
        raise ValueError(f"tp={tp} does not divide the {H} query heads "
                         f"(H={H}, KH={KH})")
    if KH % tp == 0:
        return H // tp, KH // tp
    if tp % KH == 0:
        return H // tp, 1
    raise ValueError(f"tp={tp} unsupported for H={H} query heads over "
                     f"KH={KH} KV heads: needs KH % tp == 0 or tp % KH == 0")


def kv_heads_of(rank: int, num_heads: int, num_kv_heads: int,
                tp: int) -> list[int]:
    """The global KV heads rank ``rank`` of ``tp`` holds."""
    _, local = tp_heads(num_heads, num_kv_heads, tp)
    if num_kv_heads % tp == 0:
        return list(range(rank * local, (rank + 1) * local))
    return [rank // (tp // num_kv_heads)]


def shard_config(cfg, tp: int):
    """One rank's backbone config: its query and KV heads and MLP width;
    the head dim stays explicit (the global one)."""
    if tp == 1:
        return cfg
    H, KH = tp_heads(cfg.num_heads, cfg.num_kv_heads, tp)
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} does not divide the MLP width "
                         f"{cfg.intermediate_size}")
    return dataclasses.replace(
        cfg, num_heads=H, num_kv_heads=KH, head_dim=cfg.resolved_head_dim,
        intermediate_size=cfg.intermediate_size // tp)


def _linear_rules(p: dict, column: bool) -> dict:
    """One linear leaf's rules: full precision (``w``, ``b``) or int8
    (``w_q``, ``w_s``, ``b``), weights stacked (L, d_in, d_out)."""
    out = {}
    for key in p:
        if key in ("w", "w_q"):
            out[key] = 2 if column else 1
        elif key in ("w_s", "b"):
            out[key] = 1 if column else None
        elif key == "w_p":
            raise ValueError("a packed leaf (w_p) cannot be split: shard "
                             "the quantized tree, then pack each shard")
        else:
            raise ValueError(f"unknown linear leaf {key!r}")
    return out


def backbone_param_shardings(params: dict) -> dict:
    """The rules tree of a backbone tree (``init_backbone_params``, or its
    int8 form): each leaf the axis it splits on over the ranks, or None
    (whole on every rank)."""
    layers = params["layers"]
    rules = {k: None for k in params if k != "layers"}
    rules["layers"] = {k: None for k in layers}
    for part, names in LINEARS.items():
        rules["layers"][part] = {k: None for k in layers[part]}
        for name, column in names.items():
            rules["layers"][part][name] = _linear_rules(layers[part][name],
                                                       column)
    return rules


def shard_params(params: dict, rank: int, tp: int,
                 num_kv_heads: Optional[int] = None) -> dict:
    """Rank ``rank``'s backbone tree of ``tp``: every split leaf cut to its
    slice (a contiguous copy), every whole leaf shared with ``params``.
    ``num_kv_heads`` below ``tp`` gives the k/v leaves the ``tp % KH ==
    0`` cut: the columns of KV head ``rank // (tp / KH)``."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} out of range for tp={tp}")
    rules = backbone_param_shardings(params)

    def cut(a: torch.Tensor, axis: Optional[int], pieces: int,
            index: int) -> torch.Tensor:
        if axis is None or tp == 1:
            return a
        n = a.shape[axis]
        if n % pieces:
            raise ValueError(f"axis {axis} of {tuple(a.shape)} does not "
                             f"split {pieces} ways")
        w = n // pieces
        return a.narrow(axis, index * w, w).contiguous()

    def walk(p, r, kv: bool):
        if isinstance(p, dict):
            return {k: walk(p[k], r[k], kv) for k in p}
        if kv and num_kv_heads is not None and num_kv_heads < tp:
            return cut(p, r, num_kv_heads, rank // (tp // num_kv_heads))
        return cut(p, r, tp, rank)

    out = {k: walk(v, rules[k], False) for k, v in params.items()
           if k != "layers"}
    layers = params["layers"]
    out["layers"] = {}
    for k, v in layers.items():
        if k in LINEARS:
            out["layers"][k] = {
                n: walk(leaf, rules["layers"][k][n], n in ("k", "v"))
                for n, leaf in v.items()}
        else:
            out["layers"][k] = walk(v, rules["layers"][k], False)
    return out
