"""Quantizers for BrainTTA's operand precisions — the serve half of
`repro.core.quantize` (int8 and s4 integer codes and the per-row ternary
cut; the straight-through estimators of the training path are not ported
yet).

Rounding is `torch.round`, half-to-even like `jnp.round`, and every scale
is applied as a division `x / scale`, as in the reference, so the codes are
bit-identical on identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Precision = Literal["binary", "ternary", "int4", "int8", "none"]

#: bits per operand for each precision (paper Table I / §IV-B)
BITS = {"binary": 1, "ternary": 2, "int4": 4, "int8": 8, "none": 16}

#: packing density: operands per 32-bit word (paper's v_C for a 32-bit lane)
PACK_FACTOR = {"binary": 32, "ternary": 16, "int4": 8, "int8": 4}


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, keepdim, summed in float64 and rounded to
    x's dtype. On CUDA, torch splits a row reduction across threads by a
    plan that depends on the number of rows, so an f32 sum of the same row
    can differ by an ulp between a batch of 4 and a batch of 1; summed in
    float64 the rounded result is the same, which keeps a batched server
    token-equal to a one-slot server. (The reference sums in f32 in XLA's
    order; the two agree to within its rounding.)"""
    return x.to(torch.float64).mean(dim=-1, keepdim=True).to(x.dtype)


def _mean(x: torch.Tensor, axis) -> torch.Tensor:
    if axis is None:
        return x.mean()
    if axis != -1:
        raise ValueError(f"axis={axis!r}: None or -1")
    return row_mean(x)


def ternary_cut(x: torch.Tensor, threshold: float = 0.05, axis=None) -> torch.Tensor:
    """The cut of `ternarize`: t = threshold * mean(|x|) + 1e-8 over `axis`."""
    return threshold * _mean(torch.abs(x), axis) + 1e-8


def ternarize(x: torch.Tensor, threshold: float = 0.05, axis=None, *,
              cut: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric-threshold ternarization: 0 where |x| <= t, else sign(x).

    `t = threshold * mean(|x|) + 1e-8` over `axis` (None => per tensor, as
    weight packing uses; the activation prep passes axis=-1 so each batched
    row is cut on its own statistics), or `cut` when given (a block of rows
    of a tensor cut as a whole)."""
    t = ternary_cut(x, threshold, axis) if cut is None else cut
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > t, one, torch.where(x < -t, -one, 0 * one))


def int8_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric per-channel scale: max|x| / 127 (axis=None => per-tensor)."""
    a = torch.abs(x)
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return amax / 127.0 + 1e-12


def int8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Integer int8 codes for the serve path: clip(round(x / s), ±127)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int4_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric per-channel scale: max|x| / 7 (axis=None => per-tensor).
    The ±7 range keeps the s4 codec sign-symmetric like int8."""
    a = torch.abs(x)
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return amax / 7.0 + 1e-12


def int4_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """s4 codes clip(round(x / s), ±7), held in int8 until `pack.pack_int4`."""
    return torch.clamp(torch.round(x / scale), -7, 7).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How one tensor class (weights or activations of a layer) is quantized."""
    precision: Precision = "none"
    ternary_threshold: float = 0.05
    per_channel: bool = True  # int8 only; channel = last axis

    @property
    def bits(self) -> int:
        return BITS[self.precision]
