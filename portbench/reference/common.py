"""Plain PyTorch building blocks of the references, in float32 (TF32 off on
the card: ``no_tf32``), with one switch, ``Precision``, for the control's
lower precision: float8 e4m3 with a per-tensor scale on both operands of
every matrix product and convolution (weights and activations).

Also the frozen copy of the port's random-weight recipe: the same
``torch.Generator`` calls, in the same order, with the same shapes, scales
and dtypes as ``vox_serve_tpu_torch`` makes them from ``--seed`` (the
normal and uniform draws of its ``_init_linear``, ``_normal``,
``init_conv1d`` and ``init_conv_transpose1d``), so the reference holds the
weights the served model holds without reading them from it.

Nothing here imports the port or JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products on the card (no TF32)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Precision:
    """``float32``: operands as they are. ``fp8``: each operand of a matrix
    product or convolution rounded to float8 e4m3 under a per-tensor scale
    (amax / 448), the product taken in float32."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.name == "float32":
            return t
        s = torch.clamp(t.abs().amax(), min=1e-12) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)

    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = self.mm(x, p["w"])
        return y + p["b"].float() if "b" in p else y

    def conv1d(self, p: dict, x: torch.Tensor, dilation: int = 1,
               groups: int = 1) -> torch.Tensor:
        return F.conv1d(self.q(x), self.q(p["w"]),
                        None if "b" not in p else p["b"].float(),
                        dilation=dilation, groups=groups)

    def conv_transpose1d(self, p: dict, x: torch.Tensor,
                         stride: int) -> torch.Tensor:
        return F.conv_transpose1d(self.q(x), self.q(p["w"]),
                                  None if "b" not in p else p["b"].float(),
                                  stride=stride)


# ---------------------------------------------------------------------------
# the port's random-weight recipe (frozen copy)
# ---------------------------------------------------------------------------


class Recipe:
    """Draws from one ``torch.Generator`` seeded with ``seed`` on
    ``device``, in the port's call order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.device,
                           dtype=F32)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.g, device=self.device,
                          dtype=F32)

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        """The port's ``_normal``."""
        return (self.randn(shape) * std).to(dtype)

    def linear(self, d_in: int, d_out: int, dtype, bias: bool = False,
               stack=None) -> dict:
        """The port's ``_init_linear`` (not layerwise): Normal(0,
        d_in^-1/2) weight (d_in, d_out), zero bias."""
        lead = () if stack is None else (stack,)
        p = {"w": (self.randn(lead + (d_in, d_out)) * d_in ** -0.5
                   ).to(dtype)}
        if bias:
            p["b"] = torch.zeros(lead + (d_out,), dtype=dtype,
                                 device=self.device)
        return p

    def _uniform(self, shape, scale: float) -> torch.Tensor:
        return ((self.rand(shape) * 2.0 - 1.0) * scale).to(F32)

    def conv(self, cin: int, cout: int, k: int, groups: int = 1,
             bias: bool = True) -> dict:
        """The port's ``init_conv1d``: weight (out, in/groups, k)."""
        s = 1.0 / math.sqrt(cin // groups * k)
        p = {"w": self._uniform((cout, cin // groups, k), s)}
        if bias:
            p["b"] = self._uniform((cout,), s)
        return p

    def tconv(self, cin: int, cout: int, k: int) -> dict:
        """The port's ``init_conv_transpose1d``: weight (in, out, k)."""
        s = 1.0 / math.sqrt(cout * k)
        return {"w": self._uniform((cin, cout, k), s),
                "b": self._uniform((cout,), s)}

    def ones(self, *shape, dtype=F32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def full(self, v: float, *shape) -> torch.Tensor:
        return torch.full(shape, v, dtype=F32, device=self.device)

    def zeros(self, *shape, dtype=F32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def decoder_stack(self, layers: int, hidden: int, heads: int,
                      kv_heads: int, head_dim: int, inter: int, dtype,
                      qkv_bias: bool = False, qk_norm: bool = False) -> dict:
        """The port's ``init_backbone_params`` / ``init_depth_params``:
        q, k, v, o, gate, up, down stacked over the layers, in that
        order; norms at one."""
        def lin(d_in, d_out, bias=False):
            return self.linear(d_in, d_out, dtype, bias, stack=layers)

        p = {"q": lin(hidden, heads * head_dim, qkv_bias),
             "k": lin(hidden, kv_heads * head_dim, qkv_bias),
             "v": lin(hidden, kv_heads * head_dim, qkv_bias),
             "o": lin(heads * head_dim, hidden)}
        if qk_norm:
            p["q_norm"] = self.ones(layers, head_dim, dtype=dtype)
            p["k_norm"] = self.ones(layers, head_dim, dtype=dtype)
        p.update(gate=lin(hidden, inter), up=lin(hidden, inter),
                 down=lin(inter, hidden))
        p["input_norm"] = self.ones(layers, hidden, dtype=dtype)
        p["post_norm"] = self.ones(layers, hidden, dtype=dtype)
        p["final_norm"] = self.ones(hidden, dtype=dtype)
        return p


# ---------------------------------------------------------------------------
# plain float32 ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def layer_norm(x, w, b, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                        eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Split-half rotary embedding over the last axis of x (..., T, H, D)
    at ``positions`` (T,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mask) -> torch.Tensor:
    """q (B, T, H, D), k and v (B, S, KH, D), mask (T, S) or (B, T, S)
    bool (True: attend); grouped query heads share their KV head."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    m = mask[None, None] if mask.dim() == 2 else mask[:, None]
    s = s.masked_fill(~m, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


def decoder_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: dict, prec: Precision) -> torch.Tensor:
    """A pre-norm decoder stack with RMSNorm and a SiLU-gated MLP over x
    (B, T, hidden), causal over its T positions; returns the final-norm
    hidden. ``cfg``: layers, heads, kv_heads, head_dim, rope_theta, eps,
    qk_norm."""
    B, T, _ = x.shape
    H, KH, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    eps = cfg["eps"]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    h = x.float()
    for i in range(cfg["layers"]):
        def lin(name, t):
            leaf = {kk: vv[i] for kk, vv in p[name].items()}
            return prec.linear(leaf, t)

        xin = rms_norm(h, p["input_norm"][i], eps)
        q = lin("q", xin).reshape(B, T, H, D)
        k = lin("k", xin).reshape(B, T, KH, D)
        v = lin("v", xin).reshape(B, T, KH, D)
        if cfg.get("qk_norm"):
            q = rms_norm(q, p["q_norm"][i], eps)
            k = rms_norm(k, p["k_norm"][i], eps)
        q, k = rope(q, positions, cfg["rope_theta"]), rope(
            k, positions, cfg["rope_theta"])
        h = h + lin("o", attention(q, k, v, mask).reshape(B, T, H * D))
        xin = rms_norm(h, p["post_norm"][i], eps)
        h = h + lin("down", F.silu(lin("gate", xin)) * lin("up", xin))
    return rms_norm(h, p["final_norm"], eps)


def widest_gap(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per row, how far the chosen token's logit lies below the row's best
    (0 where it is the best). logits (N, V) float32, chosen (N,) int."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, chosen.long()[:, None])[:, 0]


def pcm_sums(served: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(sum of squared differences, samples) of the served PCM against the
    reference's (both float, full scale 1); the judge pools them over the
    sample into ``pcm_rmse``, their root mean square."""
    d = served.double() - ref.double()
    return float((d * d).sum()), float(d.numel())
