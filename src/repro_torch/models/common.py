"""Shared model components — counterpart of `repro.models.common` (serve
path): the execution context, the quantized-linear helpers, norms, RoPE,
activations, embeddings and host-side sampling.

Compute dtype is bf16 on the card; norms, softmax and the requant run in
f32 (BrainTTA keeps accumulators wide and requantizes at operator egress,
§IV-B). The tests run the same code in f32 on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import qlinear
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.qlinear import QLinearSpec
from repro_torch.core.quantize import row_mean


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Execution context threaded through every block. Of the reference's
    fields the port has the compute dtype, `impl`, the GEMM formulation
    ("popcount" | "mxu" | "planes"; a pair without a cell of that
    formulation runs its default cell), and `draft_planes`, the leading
    plane count the self-speculative draft's plane-composed layers contract
    (None = full precision), and `moe_stats`: the serve entry points
    (`transformer.prefill`, `decode_step`, `decode_verify`) return a third
    value, the MoE routing counters {"expert_tokens": (E,) int32,
    "dropped": int32} summed over the MoE blocks (off: 2-tuples, so
    non-MoE callers keep their shapes). Only the serve mode is ported, and
    where a GEMM runs follows from the device of its tensors."""
    dtype: torch.dtype = torch.bfloat16
    impl: str = "popcount"
    draft_planes: int | None = None
    moe_stats: bool = False


# -- linear helper ------------------------------------------------------------

def lspec(pol: PrecisionPolicy, layer_class: str, in_dim: int, out_dim: int, *,
          first: bool = False, last: bool = False, bias: bool = False,
          experts: int = 0, name: str = "") -> QLinearSpec:
    lq = pol.lookup(layer_class, is_first=first, is_last=last)
    return QLinearSpec(in_dim, out_dim, lq, use_bias=bias, experts=experts,
                       name=name or layer_class)


def operating_point(spec: QLinearSpec, ctx: ModelCtx):
    """This layer's `dispatch.OperatingPoint`: the precisions of the layer's
    policy assignment, the formulation from the context.

    As in the reference, a formulation only some pairs have (impl="planes"
    exists for int4/int8 x int8 only) resolves per layer: a pair without it
    runs its popcount (or formulation-agnostic) cell, so one `--impl planes`
    serves a heterogeneous policy. A draft context truncates every
    plane-composed layer to min(draft_planes, its bits) planes."""
    from repro_torch.core import pack
    from repro_torch.kernels import dispatch
    op = dispatch.OperatingPoint.for_spec(spec, impl=ctx.impl)
    try:
        cell = dispatch.lookup(op)
    except KeyError:
        op = dataclasses.replace(op, impl="popcount")
        cell = dispatch.lookup(op)
    if ctx.draft_planes is not None and "w_planes" in cell.weight_names:
        op = dataclasses.replace(
            op, planes=min(ctx.draft_planes, pack.PLANE_BITS[op.wprec]))
    return op


def linear_apply(p, x, spec: QLinearSpec, ctx: ModelCtx):
    return qlinear.apply(p, x, spec, op=operating_point(spec, ctx)).to(ctx.dtype)


def tree_nbytes(tree) -> int:
    """Bytes held by the tensors of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


# -- norms --------------------------------------------------------------------

def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32, device="cpu"):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not yet ported")
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not yet ported")
    xf = x.to(torch.float32)
    inv = torch.rsqrt(row_mean(xf * xf) + eps)   # batch-invariant, see row_mean
    return (xf * inv * p["scale"]).to(x.dtype)


# -- activations ----------------------------------------------------------------

def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# -- rotary embeddings ----------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: (B, T, H, dh), positions: (B, T) or (T,)."""
    dh = x.shape[-1]
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs          # (..., T, dh/2)
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding ------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device="cpu"):
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return {"w": (w * 0.02).to(dtype)}


def embed_apply(p, tokens: torch.Tensor, dtype=torch.bfloat16):
    return p["w"][tokens.long()].to(dtype)


# -- serve-side token sampling ----------------------------------------------------

def sample_token(logits_row, temperature: float, seed: int, index: int) -> int:
    """Host-side next-token draw for the serving loop (and its test oracles).

    temperature <= 0 is greedy argmax. Otherwise a categorical draw from
    softmax(logits / T) using a STATELESS numpy rng keyed by (seed, index) —
    no mutable stream, so token `index` of a request reproduces bit-exactly
    no matter how the request was batched, preempted/resumed, or
    prefix-shared in between. That determinism is what lets the scheduler
    tests demand token-exact equality against a sequential oracle, and what
    makes copy-on-write observable at all: two requests sharing a prompt
    prefix diverge only through (seed, temperature).

    Runs on host float64 from the f32 logits — identical logits therefore
    always give identical tokens (argmax ties break to the lowest index on
    both np and jnp).
    """
    row = np.asarray(logits_row, np.float64).reshape(-1)
    if temperature <= 0.0:
        return int(np.argmax(row))
    z = row / float(temperature)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    rng = np.random.default_rng((int(seed) & 0x7FFFFFFF, int(index)))
    return int(rng.choice(row.shape[0], p=p))
