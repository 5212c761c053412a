"""QuantizedLinear, serve half — counterpart of `repro.core.qlinear`.

`init` draws the train-layout weight w[in, out] ~ normal / sqrt(in_dim) like
the reference; `pack_params` converts it to the packed serve layout of every
weight precision (binary, ternary, int4, int8, none); `apply(mode="serve")` runs the
layer through `kernels.dispatch.qgemm`. Packed words are int32 with the
bits of the reference's uint32 words (see `core.pack`). An expert-stacked
layer (`experts = E`) carries a leading E on every weight leaf, in the
train and in the serve layout.
"""
from __future__ import annotations

import dataclasses

import torch

from . import pack
from .precision import LayerQuant
from .quantize import (int4_codes, int4_scale, int8_codes, int8_scale, ternarize,
                       ternary_cut)

Params = dict[str, torch.Tensor]

#: a ternary weight of more elements is cut, packed and scaled a block of
#: rows at a time after its one whole-tensor cut: nemotron-4-340b's 18432 x
#: 256000 head is 18.9 GB in f32, and the whole-tensor passes would hold
#: five such copies at once, more than one 80 GB card
TERNARY_ROW_BLOCK_ELEMS = 1 << 31


@dataclasses.dataclass(frozen=True)
class QLinearSpec:
    in_dim: int
    out_dim: int
    lq: LayerQuant = LayerQuant()
    use_bias: bool = False
    experts: int = 0           # 0 = dense; >0 = leading expert axis on weights
    name: str = "qlinear"


def init(generator: torch.Generator, spec: QLinearSpec, dtype=torch.float32,
         device="cpu") -> Params:
    """Train-layout params: w ((E,) in, out) ~ N(0, 1) / sqrt(in_dim), zero
    bias ((E,) out)."""
    e = (spec.experts,) if spec.experts else ()
    w = torch.randn(e + (spec.in_dim, spec.out_dim), generator=generator,
                    dtype=torch.float32, device=device)
    p: Params = {"w": (w * (1.0 / spec.in_dim ** 0.5)).to(dtype)}
    if spec.use_bias:
        p["b"] = torch.zeros(e + (spec.out_dim,), dtype=dtype, device=device)
    return p


def pack_params(p: Params, spec: QLinearSpec) -> Params:
    """Convert train-layout params to the packed serve layout.

    binary : w_packed  int32[(E,) out, in/32]   (bit = +1)
             w_scale   f32[(E,) out]            (XNOR-Net per-channel alpha)
    ternary: w_mask/w_sign int32[(E,) out, in/32]
             w_scale   f32[(E,) out]
    int4   : w_q4      int32[(E,) out, in/8]    (s4 nibble codes)
             w_scale   f32[(E,) out]
    int8   : w_q       int8[(E,) in, out]       (K-major per expert)
             w_scale   f32[(E,) out]
    int4/int8 weights with int8 acts and word-aligned in_dim also carry the
    stacked bit-plane twin of the same codes, feeding the plane-composed
    cells (impl="planes") and their truncated-plane drafts:
             w_planes  int32[(E,) bits, out, in/32]  (MSB-first 2c planes)
    none   : w         bf16[(E,) in, out]       (dense weights, cast)
    `a_scale` (f32 scalar) is the calibrated activation scale for int8 acts,
    one scalar shared by every expert of a stack. As in the reference, a
    ternary stack is cut at one threshold over the whole stack.
    """
    prec = spec.lq.weights.precision
    out: Params = {}
    # out, in (K last), transposed before the f32 cast so that no f32 copy
    # in the train layout is held beside it
    wt = p["w"].transpose(-1, -2).contiguous().to(torch.float32)
    if prec == "binary":
        out["w_packed"] = pack.pack_binary(torch.sign(wt) + (wt == 0))
        out["w_scale"] = torch.abs(wt).mean(dim=-1)
    elif prec == "ternary":
        out["w_mask"], out["w_sign"], out["w_scale"] = _pack_ternary(
            wt, spec.lq.weights.ternary_threshold)
    elif prec == "int4":
        s = int4_scale(wt, axis=-1)                # per out-channel, reduce in
        codes = int4_codes(wt, s)
        out["w_q4"] = pack.pack_int4(codes)
        if _plane_twin(spec):
            out["w_planes"] = pack.pack_planes(codes, pack.PLANE_BITS[prec])
        out["w_scale"] = s.squeeze(-1)
    elif prec == "int8":
        w = p["w"].to(torch.float32)
        s = int8_scale(w, axis=(w.ndim - 2,))      # reduce in_dim
        codes = int8_codes(w, s)
        out["w_q"] = codes
        if _plane_twin(spec):
            out["w_planes"] = pack.pack_planes(codes.transpose(-1, -2),
                                               pack.PLANE_BITS[prec])
        out["w_scale"] = s.squeeze(w.ndim - 2)
    else:
        out["w"] = p["w"].to(torch.bfloat16)
    if spec.lq.acts.precision == "int8":
        out["a_scale"] = torch.tensor(0.05, dtype=torch.float32, device=wt.device)
    if "b" in p:
        out["b"] = p["b"].to(torch.float32)
    return out


def _pack_ternary(wt: torch.Tensor, threshold: float):
    """(w_mask, w_sign, w_scale) of a ternary weight wt ((E,) out, in): one
    cut over the whole stack, then per row the trits, their planes and the
    scale mean(|w|) over the row's non-zero trits. Past
    TERNARY_ROW_BLOCK_ELEMS elements the row-local part runs a block of rows
    at a time (the same cut, the same per-row arithmetic)."""
    cut = ternary_cut(wt, threshold)

    def rows(w):
        q = ternarize(w, cut=cut)
        mask, sign = pack.pack_ternary(q)
        nz = torch.abs(q).sum(dim=-1) + 1e-6
        return mask, sign, (torch.abs(w) * torch.abs(q)).sum(dim=-1) / nz

    if wt.numel() <= TERNARY_ROW_BLOCK_ELEMS:
        return rows(wt)
    flat = wt.reshape(-1, wt.shape[-1])
    step = max(1, TERNARY_ROW_BLOCK_ELEMS // 8 // wt.shape[-1])
    parts = [rows(flat[a:a + step]) for a in range(0, flat.shape[0], step)]
    return tuple(torch.cat(leaf).reshape(wt.shape[:-1] + leaf[0].shape[1:])
                 for leaf in zip(*parts))


def _plane_twin(spec: QLinearSpec) -> bool:
    """int4/int8 weights get the plane twin under int8 acts, word-aligned K."""
    return spec.lq.acts.precision == "int8" and spec.in_dim % pack.WORD == 0


def apply(p: Params, x: torch.Tensor, spec: QLinearSpec, *,
          mode: str = "serve", op=None) -> torch.Tensor:
    """Apply the packed layer: one dispatch into the precision-keyed GEMM
    registry (`op` is a `kernels.dispatch.OperatingPoint`; None derives it
    from the spec). Only mode="serve" is ported; QAT training is not."""
    if mode != "serve":
        raise NotImplementedError(f"mode={mode!r} is not yet ported")
    from repro_torch.kernels.dispatch import qgemm
    return qgemm(p, x, spec, op)
