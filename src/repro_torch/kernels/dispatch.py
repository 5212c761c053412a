"""Precision-keyed GEMM dispatch — counterpart of `repro.kernels.dispatch`,
single device.

Every serve GEMM funnels through

    qgemm(p, x, spec, op)

where `op` is an `OperatingPoint` (weight precision, activation precision,
kernel formulation). The registry maps an operating point to a `GemmCell`:
its activation prep (quantize + pack, torch ops, as the reference keeps it
outside the kernel) and either

  * a `MacBody` (the weight-and-activation cells), which `harness.gemm`
    runs as the CUDA kernel for CUDA tensors and as the body's plain
    version for CPU tensors, with the fused f32 requant (`wide=True`); or
  * a torch accumulator (`acc`, the weight-only and dense cells, whose
    activations stay bf16): the reference has no Pallas body for these
    (its `_acc_wonly_*` run through XLA), so the port runs them as torch
    ops — unpack the packed weights, one `torch.matmul` — with the narrow
    epilogue of `_requant_narrow` (`wide=False`).

All single-device cells of the reference are registered: binary and
ternary (popcount and mxu), int8, the mixed w-ternary/w-int4 x a-int8
cells, the plane-composed int4/int8 x int8 cells (`impl="planes"`, with
`OperatingPoint.planes` truncating the stack), and the weight-only and
dense cells. An expert-stacked layer (`spec.experts = E`, every weight
leaf with a leading E) runs as the reference's vmap over the experts does:
one prep over all (E·M, K) rows, then for a weight-and-activation cell ONE
`harness.gemm_grouped` launch (K11; for a plane cell K10 over the expert
stacks, a truncated stack read in place) over the E weight stacks, and for
a weight-only or dense cell one batched torch product. Not ported: tensor
and expert parallelism. There is no tune table: the CUDA tiles are
compile-time constants of `csrc/gemm.cu`, and the reference's
`tune_cpu.json` holds interpret-mode CPU picks that say nothing about the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import pack
from repro_torch.core.quantize import int8_codes, row_mean, ternarize

from . import bgemm, harness, i4gemm, i8gemm, pgemm, tgemm


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One configuration of the datapath: wprec/aprec name the registry
    cell, impl the kernel formulation ("popcount" | "mxu" | "planes", or "*"
    when the cell is formulation-agnostic). Where the cell runs follows from
    the device of its tensors.

    planes: the leading (MSB-first) plane count a plane-composed cell
    contracts; None = the full stack. An execution choice, not part of the
    registry key: the self-speculative draft runs the same cell over the
    same weights with fewer planes."""
    wprec: str = "none"
    aprec: str = "none"
    impl: str = "popcount"
    planes: int | None = None

    def __post_init__(self):
        if self.planes is not None and self.planes < 1:
            raise ValueError(f"planes={self.planes!r}: need >= 1 or None")

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.wprec, self.aprec, self.impl)

    @property
    def tag(self) -> str:
        trunc = "" if self.planes is None else f":p{self.planes}"
        return f"w{self.wprec[:4]}/a{self.aprec[:4]}/{self.impl}{trunc}"

    @classmethod
    def for_spec(cls, spec, *, impl: str = "popcount") -> "OperatingPoint":
        """The per-layer operating point: precisions from the layer's
        `LayerQuant`, the formulation from the execution context."""
        return cls(spec.lq.weights.precision, spec.lq.acts.precision, impl)


@dataclasses.dataclass(frozen=True)
class GemmCell:
    """One registered operating point of the datapath."""
    op: OperatingPoint
    weight_names: tuple[str, ...]   # packed-param entries feeding the GEMM
    prep: Callable                  # (x2d, p, spec) -> (x_ops, a_scale|None)
    body: harness.MacBody | None = None  # CUDA kernel body (None: torch acc)
    acc: Callable | None = None     # (x_ops, w_ops, k) -> (M, N) f32 (no body)
    wide: bool = True               # f32 requant (W&A) vs narrow (weight-only)

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
    """Resolve an operating point to its cell; impl falls back to '*'. An
    unregistered key raises KeyError, as in the reference."""
    for k in (op.key, (op.wprec, op.aprec, "*")):
        if k in _REGISTRY:
            return _REGISTRY[k]
    raise KeyError(
        f"no GEMM registered for (wprec={op.wprec!r}, aprec={op.aprec!r}, "
        f"impl={op.impl!r}) (registered cells: {sorted(_REGISTRY)})")


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


def _prep_bf16(x2d, p, spec):
    """Weight-only / dense: activations stay bf16."""
    return (x2d.to(torch.bfloat16),), None


# ---------------------------------------------------------------------------
# torch accumulators of the weight-only and dense cells
# ---------------------------------------------------------------------------

#: weight-only products pad their rows to a multiple of this, so that the
#: library runs one algorithm for every batch size it meets at decode (1..64
#: slots): a row's result then cannot depend on how many rows came with it
ROW_QUANTUM = 64


def _matmul_nk(x: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """bf16 activations (M, K) x integer or bf16 weights (N, K) -> (M, N)
    f32: the bf16 product with an f32 accumulator, as XLA computes the
    reference's bf16 dot. Every operand value is exact in f32, so this is
    that product up to the order of the f32 sum (TF32 stays off: torch's
    default `allow_tf32 = False` for matmul). An expert stack, (E, M, K) x
    (E, N, K) -> (E, M, N), pads each expert's slab of rows."""
    m = x.shape[-2]
    pad = (-m) % ROW_QUANTUM
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 0, pad))
    return (xf @ w_nk.to(torch.float32).transpose(-1, -2))[..., :m, :]


def _acc_wonly_binary(x_ops, w_ops, k):
    return _matmul_nk(x_ops[0], pack.unpack_pm1_i8(w_ops[0], k))


def _acc_wonly_ternary(x_ops, w_ops, k):
    return _matmul_nk(x_ops[0], pack.unpack_ternary_i8(w_ops[0], w_ops[1], k))


def _acc_wonly_int4(x_ops, w_ops, k):
    return _matmul_nk(x_ops[0], pack.unpack_int4_i8(w_ops[0], k))


def _acc_wonly_int8(x_ops, w_ops, k):
    return _matmul_nk(x_ops[0], w_ops[0].transpose(-1, -2))   # w_q is (K, N)


def _acc_dense(x_ops, w_ops, k):
    return _matmul_nk(x_ops[0], w_ops[0].transpose(-1, -2))   # w is (K, N) bf16


def _requant_narrow(acc, w_scale, bias):
    """Weight-only epilogue, as the reference's: the accumulator rounded to
    bf16 and scaled in bf16, the bias (if any) added in f32."""
    y = acc.to(torch.bfloat16)
    if w_scale is not None:
        y = y * w_scale.to(torch.bfloat16)
    if bias is not None:
        y = y.to(torch.float32) + bias
    return y


# ---------------------------------------------------------------------------
# the registry — every single-device operating point of the POLICIES table
# ---------------------------------------------------------------------------

def _op(wprec, aprec, impl):
    return OperatingPoint(wprec, aprec, impl)


# W&A-quantized cells: packed operands, int32 accumulators, CUDA bodies
register(GemmCell(_op("binary", "binary", "popcount"), ("w_packed",),
                  _prep_binary, bgemm.BINARY_POPCOUNT))
register(GemmCell(_op("binary", "binary", "mxu"), ("w_packed",),
                  _prep_binary, bgemm.BINARY_MXU))
register(GemmCell(_op("ternary", "ternary", "popcount"), ("w_mask", "w_sign"),
                  _prep_ternary, tgemm.TERNARY_POPCOUNT))
register(GemmCell(_op("ternary", "ternary", "mxu"), ("w_mask", "w_sign"),
                  _prep_ternary, tgemm.TERNARY_MXU))
register(GemmCell(_op("int8", "int8", "*"), ("w_q",),
                  _prep_int8, i8gemm.I8_DOT))

# mixed w/a cells: packed weights against int8 activation codes; the shared
# requant composes the per-channel weight scale with the activation scale
register(GemmCell(_op("ternary", "int8", "*"), ("w_mask", "w_sign"),
                  _prep_int8, tgemm.TERNARY_W_I8A))
register(GemmCell(_op("int4", "int8", "*"), ("w_q4",),
                  _prep_int8, i4gemm.INT4_W_I8A))

# plane-composed cells: int4/int8 weights as stacked binary planes, composed
# by coefficient inside the int32 accumulator — bit-exact vs the direct
# cells above; the exact key wins in lookup, so a pair resolves to these
# only when impl="planes" asks
register(GemmCell(_op("int4", "int8", "planes"), ("w_planes",),
                  _prep_int8, pgemm.PLANES_W4_I8A))
register(GemmCell(_op("int8", "int8", "planes"), ("w_planes",),
                  _prep_int8, pgemm.PLANES_W8_I8A))

# weight-only and dense cells: bf16 activations, torch ops (no kernel body
# in the reference either), narrow epilogue
register(GemmCell(_op("binary", "none", "*"), ("w_packed",), _prep_bf16,
                  acc=_acc_wonly_binary, wide=False))
register(GemmCell(_op("ternary", "none", "*"), ("w_mask", "w_sign"), _prep_bf16,
                  acc=_acc_wonly_ternary, wide=False))
register(GemmCell(_op("int4", "none", "*"), ("w_q4",), _prep_bf16,
                  acc=_acc_wonly_int4, wide=False))
register(GemmCell(_op("int8", "none", "*"), ("w_q",), _prep_bf16,
                  acc=_acc_wonly_int8, wide=False))
register(GemmCell(_op("none", "none", "*"), ("w",), _prep_bf16,
                  acc=_acc_dense, wide=False))


def cells() -> dict[tuple[str, str, str], GemmCell]:
    """Snapshot of the registry."""
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _weight_ops(cell: GemmCell, op: OperatingPoint, p: dict) -> tuple:
    """The cell's weight operands, with the operating point's plane
    truncation (a leading MSB-first slice; the coefficients are positional,
    so the slice needs no rescaling). planes on a cell without a stacked
    leaf raises: running full precision instead would make a draft pass lie
    about its cost."""
    missing = [nm for nm in cell.weight_names if nm not in p]
    if missing:
        hint = (" (pack with transformer.pack_for_serve(..., plane_twins=True))"
                if "w_planes" in missing else "")
        raise KeyError(f"{cell.op.tag} needs packed weights {missing}{hint}")
    w_ops = tuple(p[nm] for nm in cell.weight_names)
    if op.planes is None:
        return w_ops
    if "w_planes" not in cell.weight_names:
        raise ValueError(f"OperatingPoint planes={op.planes} needs a "
                         f"plane-composed cell; {cell.key} has no stacked "
                         f"w_planes leaf")
    out = []
    for nm, wv in zip(cell.weight_names, w_ops):
        if nm == "w_planes":
            if not 1 <= op.planes <= wv.shape[-3]:
                raise ValueError(f"planes={op.planes} outside the stored stack "
                                 f"depth {wv.shape[-3]} for {cell.key}")
            wv = wv[..., :op.planes, :, :]
        out.append(wv)
    return tuple(out)


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
    if spec.experts:
        return _qgemm_experts(cell, op, p, x, spec)
    k, n = spec.in_dim, spec.out_dim
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    x_ops, a_scale = cell.prep(x2d, p, spec)
    w_ops = _weight_ops(cell, op, p)
    if cell.body is not None:
        y = harness.gemm(cell.body, x_ops, w_ops, p.get("w_scale"), a_scale,
                         p.get("b"), k=k)
    else:
        y = _requant_narrow(cell.acc(x_ops, w_ops, k), p.get("w_scale"),
                            p.get("b")).to(torch.bfloat16)
    return y.reshape(*lead, n)


def _qgemm_experts(cell: GemmCell, op: OperatingPoint, p: dict,
                   x: torch.Tensor, spec) -> torch.Tensor:
    """An expert-stacked layer: x (E, ..., K) -> (E, ..., N) bf16, expert e
    through weight slice e; the reference vmaps `qgemm` over the experts,
    with `a_scale` shared.

    Every prep is row-local (the binary/ternary per-row means, the int8
    constant scale), so one prep over the (E·M, K) rows gives each expert
    the operands its own call would. A weight-and-activation cell then
    runs ONE grouped launch (K11) over the E stacks; a plane cell's
    `OperatingPoint.planes` truncation is the (E, P, N, K/32) view
    `w_planes[:, :P]`, which that launch reads in place (no copy of the
    live planes). A weight-only or dense cell runs one batched product,
    each expert's slab padded to ROW_QUANTUM rows so that its rows do not
    depend on how many came with them."""
    e, k, n = spec.experts, spec.in_dim, spec.out_dim
    if x.shape[0] != e:
        raise ValueError(f"{spec.name!r}: activations {tuple(x.shape)} need a "
                         f"leading expert axis of {e}")
    lead = x.shape[1:-1]
    x2d = x.reshape(-1, k)
    m = x2d.shape[0] // e
    x_ops, a_scale = cell.prep(x2d, p, spec)
    x_ops = tuple(t.reshape(e, m, -1) for t in x_ops)
    w_ops = _weight_ops(cell, op, p)
    w_scale, bias = p.get("w_scale"), p.get("b")
    if cell.body is not None:
        y = harness.gemm_grouped(cell.body, x_ops, w_ops, w_scale,
                                 a_scale.reshape(e, m), bias, k=k)
    else:
        y = _requant_narrow(cell.acc(x_ops, w_ops, k),
                            None if w_scale is None else w_scale[:, None, :],
                            None if bias is None else bias[:, None, :]
                            ).to(torch.bfloat16)
    return y.reshape(e, *lead, n)
