"""Precision-keyed GEMM dispatch — counterpart of `repro.kernels.dispatch`,
single device.

Every serve GEMM funnels through

    qgemm(p, x, spec, op)

where `op` is an `OperatingPoint` (weight precision, activation precision,
kernel formulation). The registry maps an operating point to a `GemmCell`:
its activation prep (quantize + pack, torch ops, as the reference keeps it
outside the kernel) and its `MacBody`, which `harness.gemm` runs as the CUDA
kernel for CUDA tensors and as the body's plain version for CPU tensors.

Ported cells: binary/binary/popcount, ternary/ternary/popcount and
int8/int8/*. The other cells of the reference (mxu, mixed w/a, int4,
planes, weight-only, dense) are not yet ported, nor are tensor and expert
parallelism; asking for one raises. There is no tune table: the CUDA tile
is compile-time (`harness.Tile`), and the reference's `tune_cpu.json` holds
interpret-mode CPU picks that say nothing about the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import pack
from repro_torch.core.quantize import int8_codes, row_mean, ternarize

from . import bgemm, harness, i8gemm, tgemm


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One configuration of the datapath: wprec/aprec name the registry
    cell, impl the kernel formulation ("popcount", or "*" when the cell is
    formulation-agnostic). Where the cell runs follows from the device of
    its tensors."""
    wprec: str = "none"
    aprec: str = "none"
    impl: str = "popcount"

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.wprec, self.aprec, self.impl)

    @property
    def tag(self) -> str:
        return f"w{self.wprec[:4]}/a{self.aprec[:4]}/{self.impl}"

    @classmethod
    def for_spec(cls, spec) -> "OperatingPoint":
        """The per-layer operating point: precisions from the layer's
        `LayerQuant`, the popcount formulation (the only one ported)."""
        return cls(spec.lq.weights.precision, spec.lq.acts.precision)


@dataclasses.dataclass(frozen=True)
class GemmCell:
    """One registered operating point of the datapath."""
    op: OperatingPoint
    weight_names: tuple[str, ...]   # packed-param entries feeding the GEMM
    prep: Callable                  # (x2d, p, spec) -> (x_ops, a_scale)
    body: harness.MacBody

    @property
    def key(self) -> tuple[str, str, str]:
        return self.op.key


_REGISTRY: dict[tuple[str, str, str], GemmCell] = {}


def register(cell: GemmCell) -> GemmCell:
    if cell.key in _REGISTRY:
        raise ValueError(f"duplicate GEMM registration for {cell.key}")
    _REGISTRY[cell.key] = cell
    return cell


def lookup(op: OperatingPoint) -> GemmCell:
    """Resolve an operating point to its cell; impl falls back to '*'."""
    for k in (op.key, (op.wprec, op.aprec, "*")):
        if k in _REGISTRY:
            return _REGISTRY[k]
    raise KeyError(
        f"no GEMM for (wprec={op.wprec!r}, aprec={op.aprec!r}, "
        f"impl={op.impl!r}) in the PyTorch port: not yet ported (ported "
        f"cells: {sorted(_REGISTRY)})")


# ---------------------------------------------------------------------------
# activation prep — ONE quantize+pack per activation precision
# ---------------------------------------------------------------------------

def _prep_binary(x2d, p, spec):
    xf = x2d.to(torch.float32)
    a_scale = row_mean(torch.abs(xf))[:, 0]             # XNOR-Net per-row alpha
    return (pack.pack_binary(xf),), a_scale


def _prep_ternary(x2d, p, spec):
    xf = x2d.to(torch.float32)
    a_scale = row_mean(torch.abs(xf))[:, 0]
    # per-row threshold: a per-tensor cut would couple co-batched requests
    xq = ternarize(xf, spec.lq.acts.ternary_threshold, axis=-1)
    return pack.pack_ternary(xq), a_scale


def _prep_int8(x2d, p, spec):
    a_s = p["a_scale"]     # calibrated constant; KeyError = packing bug
    xq = int8_codes(x2d.to(torch.float32), a_s)
    return (xq,), a_s.to(torch.float32).expand(x2d.shape[0]).contiguous()


def _op(wprec, aprec, impl):
    return OperatingPoint(wprec, aprec, impl)


register(GemmCell(_op("binary", "binary", "popcount"), ("w_packed",),
                  _prep_binary, bgemm.BINARY_POPCOUNT))
register(GemmCell(_op("ternary", "ternary", "popcount"), ("w_mask", "w_sign"),
                  _prep_ternary, tgemm.TERNARY_POPCOUNT))
register(GemmCell(_op("int8", "int8", "*"), ("w_q",),
                  _prep_int8, i8gemm.I8_DOT))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def qgemm(p: dict, x: torch.Tensor, spec,
          op: OperatingPoint | None = None) -> torch.Tensor:
    """The serve-mode quantized GEMM: (..., K) -> (..., N) bf16.

    p: packed params from `core.qlinear.pack_params`; spec: QLinearSpec; op:
    the `OperatingPoint` to run (None = the spec's precisions with the
    popcount formulation); its precisions must match the spec's LayerQuant."""
    if op is None:
        op = OperatingPoint.for_spec(spec)
    if (op.wprec, op.aprec) != (spec.lq.weights.precision,
                                spec.lq.acts.precision):
        raise ValueError(
            f"OperatingPoint {op.tag} does not match the layer's policy "
            f"assignment {spec.lq.tag} for {spec.name!r}")
    cell = lookup(op)
    k, n = spec.in_dim, spec.out_dim
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    x_ops, a_scale = cell.prep(x2d, p, spec)
    w_ops = tuple(p[nm] for nm in cell.weight_names)
    y = harness.gemm(cell.body, x_ops, w_ops, p.get("w_scale"), a_scale,
                     p.get("b"), k=k)
    return y.reshape(*lead, n)
