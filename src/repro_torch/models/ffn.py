"""Feed-forward blocks — counterpart of `repro.models.ffn`: gated
(SwiGLU/GeGLU) or plain, up and down as QuantizedLinears. The activation
runs wide (f32); requantization happens at the next linear's ingress.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import PrecisionPolicy

from . import common
from .common import ModelCtx


@dataclasses.dataclass(frozen=True)
class FFNSpecs:
    up: Any
    down: Any
    gated: bool
    act: str


def ffn_specs(cfg: ArchConfig, pol: PrecisionPolicy, *, first=False, last=False,
              d_ff: int = 0) -> FFNSpecs:
    f = d_ff or cfg.d_ff
    up_out = 2 * f if cfg.gated_ffn else f
    return FFNSpecs(
        up=common.lspec(pol, "ffn_up", cfg.d_model, up_out, first=first,
                        last=last),
        down=common.lspec(pol, "ffn_down", f, cfg.d_model, first=first,
                          last=last),
        gated=cfg.gated_ffn,
        act=cfg.act_fn,
    )


def ffn_apply(p, x, specs: FFNSpecs, ctx: ModelCtx):
    h = common.linear_apply(p["up"], x, specs.up, ctx)
    act = common.activation(specs.act)
    if specs.gated:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = act(h.to(torch.float32)).to(x.dtype)
    return common.linear_apply(p["down"], h, specs.down, ctx)
