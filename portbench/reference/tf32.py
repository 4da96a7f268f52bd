"""The TF32 control: the step below float32 for the configurations whose
detokenizer is stated in float32 (CosyVoice2's flow and HiFT). Each
operand of a matrix product or convolution is rounded to TF32 (float32's
sign and 8-bit exponent, 10 of its 23 mantissa bits) to nearest, ties away
from zero (PTX ``cvt.rna.tf32.f32``), and the product is taken in float32,
as a tensor core does with TF32 on.

Nothing here imports the port or JAX.
"""

from __future__ import annotations

import torch

from .common import Precision

#: the mantissa bits TF32 drops, and half of its last kept bit
_DROPPED = (1 << 13) - 1
_HALF = 1 << 12


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to the nearest TF32 value, ties away from
    zero (the sign bit is left alone, so the magnitude rounds)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + _HALF) & ~_DROPPED).view(torch.float32)


class TF32(Precision):
    """``Precision`` whose matrix products and convolutions take TF32
    operands."""

    def __init__(self):
        self.name = "tf32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t)
