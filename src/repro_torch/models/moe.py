"""Mixture-of-Experts with GShard-style capacity dispatch, serve path —
counterpart of `repro.models.moe` on one device.

Serves phi3.5-moe (16 experts, top-2) and deepseek-moe (2 shared + 64
routed, top-6, fine-grained d_ff). The expert FFN weights carry a leading
expert axis; each projection is one expert-stacked `qgemm`, which runs a
weight-and-activation cell as one grouped launch (K11) over the experts.

The contract of the reference (docs/MOE.md) holds:
  * the router is f32-accumulated and unquantized (`moe_router` is in
    `core.precision.ALWAYS_WIDE`), softmax over E in f32;
  * top-k breaks gate ties toward the lowest expert index (a stable
    descending sort sliced to k, as `jax.lax.top_k`), and the k gates are
    renormalised;
  * capacity C = `_capacity(S)` per expert and batch row, from the call's
    own S (the prefill bucket, 1 at decode); each assignment takes the next
    free slot of its expert in flat (s·k) order, and those past C drop;
  * shared experts are added after the combine.
Where the reference multiplies dense (B, S, E, C) one-hot tensors, the port
gathers each kept assignment's token into its slot of the (E, B·C, D) slab
and gathers the expert outputs back: the same slots, the same drops, and a
token's k contributions summed in the fixed order k = 0, 1, ... in f32. The
slab has zero rows in its empty slots, as the reference's has, so the
expert GEMMs see the reference's shapes. The train-only load-balancing loss
is not ported; `aux` carries the routing counters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qlinear
from repro_torch.core.precision import PrecisionPolicy

from . import common, ffn
from .common import ModelCtx


@dataclasses.dataclass(frozen=True)
class MoESpecs:
    router: Any
    up: Any
    down: Any
    shared: Any            # FFNSpecs | None
    n_experts: int
    top_k: int
    capacity_factor: float
    gated: bool
    act: str


def moe_specs(cfg: ArchConfig, pol: PrecisionPolicy, *, first=False,
              last=False) -> MoESpecs:
    e, f, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    up_out = 2 * f if cfg.gated_ffn else f
    return MoESpecs(
        router=common.lspec(pol, "moe_router", d, e),
        up=common.lspec(pol, "moe_expert", d, up_out, first=first, last=last,
                        experts=e),
        down=common.lspec(pol, "moe_expert", f, d, first=first, last=last,
                          experts=e),
        shared=(ffn.ffn_specs(cfg, pol, first=first, last=last,
                              d_ff=cfg.n_shared_experts * f)
                if cfg.n_shared_experts else None),
        n_experts=e, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        gated=cfg.gated_ffn, act=cfg.act_fn,
    )


def moe_init(generator: torch.Generator, specs: MoESpecs, dtype=torch.float32,
             device="cpu") -> dict:
    """Train-layout params: the router, the expert stacks, and the shared
    FFN (if any), drawn in that order from `generator`."""
    p = {nm: qlinear.init(generator, getattr(specs, nm), dtype, device)
         for nm in ("router", "up", "down")}
    if specs.shared is not None:
        p["shared"] = {nm: qlinear.init(generator, getattr(specs.shared, nm),
                                        dtype, device) for nm in ("up", "down")}
    return p


def moe_pack(p: dict, specs: MoESpecs) -> dict:
    """Train-layout MoE params -> packed serve layout."""
    out = {nm: qlinear.pack_params(p[nm], getattr(specs, nm))
           for nm in ("router", "up", "down")}
    if specs.shared is not None:
        out["shared"] = {nm: qlinear.pack_params(p["shared"][nm],
                                                 getattr(specs.shared, nm))
                         for nm in ("up", "down")}
    return out


def _capacity(s: int, specs: MoESpecs) -> int:
    c = int(s * specs.top_k / specs.n_experts * specs.capacity_factor)
    return max(4, (c + 3) // 4 * 4)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, ties to the lowest index (as `jax.lax.top_k`; `torch.topk` does
    not promise an order among ties)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_apply(p, x: torch.Tensor, specs: MoESpecs, ctx: ModelCtx):
    """x: (B, S, D) -> (y (B, S, D), aux). aux: "expert_tokens", (E,)
    int32, the assignments that landed a capacity slot on each expert this
    call; "dropped", int32, the assignments past capacity."""
    b, s, d = x.shape
    e, k = specs.n_experts, specs.top_k
    c = _capacity(s, specs)

    logits = common.linear_apply(p["router"], x, specs.router, ctx).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                        # (B,S,E)
    topv, topi = top_k(gates, k)                                 # (B,S,K)
    topv = topv / topv.sum(dim=-1, keepdim=True)

    # capacity slots in flat (s·k) order: the assignments of my expert
    # before me in my batch row
    flat = topi.reshape(b, s * k)
    sel = F.one_hot(flat, e)                                     # (B,S·K,E)
    pos = (torch.cumsum(sel, dim=1) - sel).gather(-1, flat[..., None])[..., 0]
    keep = pos < c                                               # (B,S·K)
    # row of each kept assignment in the (E, B·C) slab
    rows = (flat * b + torch.arange(b, device=x.device)[:, None]) * c + pos
    rows = torch.where(keep, rows, 0)

    xin = x.new_zeros((e * b * c, d))
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    xin[rows[keep]] = src[keep]
    h = common.linear_apply(p["up"], xin.reshape(e, b * c, d), specs.up, ctx)
    act = common.activation(specs.act)
    if specs.gated:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = act(h.to(torch.float32)).to(x.dtype)
    h = common.linear_apply(p["down"], h, specs.down, ctx).reshape(e * b * c, d)

    # combine: a token's kept contributions, gate-weighted, summed over k in
    # order (the gates in x's dtype, as the reference's combine tensor)
    wgt = (topv.reshape(b, s * k) * keep).to(x.dtype).to(torch.float32)
    contrib = (h[rows].to(torch.float32) * wgt[..., None]).reshape(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    y = y.to(x.dtype)

    if specs.shared is not None:
        y = y + ffn.ffn_apply(p["shared"], x, specs.shared, ctx)

    aux = {"expert_tokens": torch.bincount(flat[keep], minlength=e).to(torch.int32),
           "dropped": (~keep).sum().to(torch.int32)}
    return y, aux
