"""Model assembly for the dense decoder, serve path — counterpart of
`repro.models.transformer`.

Each block is pre-norm residual: x += attn(norm(x)); x += ffn(norm(x)).
The reference scans the middle layers over stacked params (`lax.scan`, the
analogue of BrainTTA's hardware loop buffer); PyTorch runs eagerly, so here
the stack is a plain list of per-layer blocks and a Python loop. Layer 0
and layer n-1 get the policy's first/last precision, as in the reference.

Params (serve layout, `pack_for_serve`):
    {"embed": {"w"}, "blocks": [block, ...], "final_norm": {"scale"},
     "lm_head": packed qlinear}
Cache (`init_cache`): a list with one {"k", "v"} pool dict per layer.
Only the `attn` block kind is ported. `decode_verify` runs a multi-token
range through the chunk path (the speculative verify step).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qlinear
from repro_torch.core.precision import get_policy

from . import attention, common, ffn
from .common import ModelCtx


@dataclasses.dataclass(frozen=True)
class BlockSpecs:
    kind: str
    mixer: Any
    ffn: Any = None


def block_specs(cfg: ArchConfig, pol, kind: str, *, first=False,
                last=False) -> BlockSpecs:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    if cfg.n_experts or cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: only dense decoders are ported")
    mix = attention.attn_specs(cfg, pol, first=first, last=last)
    f = ffn.ffn_specs(cfg, pol, first=first, last=last) if cfg.d_ff > 0 else None
    return BlockSpecs(kind, mix, f)


@dataclasses.dataclass(frozen=True)
class ModelSpecs:
    cfg: ArchConfig
    blocks: tuple[BlockSpecs, ...]    # one per layer, first .. last
    lm_head: Any


def build_specs(cfg: ArchConfig) -> ModelSpecs:
    pol = get_policy(cfg.policy)
    n = cfg.n_layers
    if n < 2:
        raise ValueError("need >= 2 layers")
    blocks = tuple(block_specs(cfg, pol, cfg.pattern_at(i), first=i == 0,
                               last=i == n - 1) for i in range(n))
    lm_head = common.lspec(pol, "lm_head", cfg.d_model, cfg.vocab, last=True)
    return ModelSpecs(cfg, blocks, lm_head)


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Train-layout parameters from the port's own seeded init: the same
    distributions as the reference (`qlinear.init` normal/sqrt(in_dim),
    `embed_init` normal*0.02, norm scales ones, zero biases), drawn from a
    torch Generator — so the values differ from the JAX package's. Tests
    that compare with JAX carry the JAX weights over (`repro_torch.bridge`).
    The generator must live on `device`."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are not yet ported")
    sp = build_specs(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    d = cfg.d_model

    def block(bs: BlockSpecs):
        p = {"norm1": common.norm_init(d, cfg.norm, dtype, device),
             "mixer": {"qkv": qlinear.init(generator, bs.mixer.qkv, dtype, device),
                       "out": qlinear.init(generator, bs.mixer.out, dtype, device)}}
        if bs.ffn is not None:
            p["norm2"] = common.norm_init(d, cfg.norm, dtype, device)
            p["ffn"] = {"up": qlinear.init(generator, bs.ffn.up, dtype, device),
                        "down": qlinear.init(generator, bs.ffn.down, dtype, device)}
        return p

    return {
        "embed": common.embed_init(generator, cfg.vocab, d, dtype, device),
        "blocks": [block(bs) for bs in sp.blocks],
        "final_norm": common.norm_init(d, cfg.norm, dtype, device),
        "lm_head": qlinear.init(generator, sp.lm_head, dtype, device),
    }


def block_pack(p, bs: BlockSpecs):
    """Train-layout block params -> packed serve layout."""
    out = {k: v for k, v in p.items() if k.startswith("norm")}
    m = p["mixer"]
    out["mixer"] = {"qkv": qlinear.pack_params(m["qkv"], bs.mixer.qkv),
                    "out": qlinear.pack_params(m["out"], bs.mixer.out)}
    if bs.ffn is not None:
        out["ffn"] = {"up": qlinear.pack_params(p["ffn"]["up"], bs.ffn.up),
                      "down": qlinear.pack_params(p["ffn"]["down"], bs.ffn.down)}
    return out


def _strip_plane_twins(t):
    if isinstance(t, dict):
        return {k: _strip_plane_twins(v) for k, v in t.items() if k != "w_planes"}
    if isinstance(t, list):
        return [_strip_plane_twins(v) for v in t]
    return t


def pack_for_serve(params: dict, cfg: ArchConfig, *,
                   plane_twins: bool = False) -> dict:
    """Convert train-layout params to the packed serve layout (bit-planes /
    int8 codes). The embedding stays wide (bf16, ALWAYS_WIDE).

    `plane_twins=True` keeps the stacked bit-plane twin (`w_planes`) that
    `qlinear.pack_params` emits beside the direct int4/int8 layout: the
    `impl="planes"` cells and the `--spec-draft` draft read it. The default
    strips it, since it duplicates those layers' weight bytes."""
    sp = build_specs(cfg)
    out = {
        "embed": {"w": params["embed"]["w"].to(torch.bfloat16)},
        "blocks": [block_pack(p, bs) for p, bs in zip(params["blocks"], sp.blocks)],
        "final_norm": params["final_norm"],
        "lm_head": qlinear.pack_params(params["lm_head"], sp.lm_head),
    }
    return out if plane_twins else _strip_plane_twins(out)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def _ffn_residual(p, x, bs: BlockSpecs, cfg: ArchConfig, ctx: ModelCtx):
    if bs.ffn is None:
        return x
    h2 = common.norm_apply(p["norm2"], x, cfg.norm)
    return x + ffn.ffn_apply(p["ffn"], h2, bs.ffn, ctx)


def block_prefill(p, x, bs: BlockSpecs, cfg: ArchConfig, ctx: ModelCtx, *,
                  cache_len: int = 0):
    """Prefill through one block; returns (x, cache)."""
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_apply(p["mixer"], h, bs.mixer, cfg, ctx,
                                    return_cache=True, cache_len=cache_len)
    return _ffn_residual(p, x + m, bs, cfg, ctx), cache


def block_decode(p, x, cache, pos, bs: BlockSpecs, cfg: ArchConfig,
                 ctx: ModelCtx, *, pages):
    """One-token decode through one block. x: (B, 1, D); pos: (B,)."""
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_decode(p["mixer"], h, cache, pos, bs.mixer, cfg,
                                     ctx, pages=pages)
    return _ffn_residual(p, x + m, bs, cfg, ctx), cache


def block_chunk(p, x, cache, pos0, bs: BlockSpecs, cfg: ArchConfig,
                ctx: ModelCtx, *, read_pages, write_pages, nreal):
    """A multi-token chunk through one block. x: (B, C, D); pos0: (B,).
    Only full-attention blocks have a pageable partial prefix."""
    if bs.kind != "attn":
        raise ValueError(f"a chunk needs attn blocks, got {bs.kind}")
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_prefill_chunk(
        p["mixer"], h, cache, pos0, bs.mixer, cfg, ctx, read_pages=read_pages,
        write_pages=write_pages, nreal=nreal)
    return _ffn_residual(p, x + m, bs, cfg, ctx), cache


def _logits(params, x, sp: ModelSpecs, ctx: ModelCtx):
    x = common.norm_apply(params["final_norm"], x, sp.cfg.norm)
    return common.linear_apply(params["lm_head"], x, sp.lm_head,
                               ctx).to(torch.float32)


def prefill(params, tokens, sp: ModelSpecs, ctx: ModelCtx, *,
            cache_len: int = 0, last_pos=None):
    """Process the prompt; return (last-position logits (B, 1, V), caches).

    `cache_len`: KV rows per layer cache (0 => prompt length). `last_pos`:
    (B,) index of each row's final real token when `tokens` is
    right-padded to a bucket length; None => the last column. Causal
    masking keeps real positions from attending to the padding."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    cache_len = cache_len or x.shape[1]
    caches = []
    for p, bs in zip(params["blocks"], sp.blocks):
        x, c = block_prefill(p, x, bs, cfg, ctx, cache_len=cache_len)
        caches.append(c)
    if last_pos is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long().reshape(-1, 1, 1)
        x_last = torch.take_along_dim(x, idx, dim=1)
    return _logits(params, x_last, sp, ctx), caches


def decode_step(params, cache, tokens, pos, sp: ModelSpecs, ctx: ModelCtx, *,
                pages):
    """One decode step over the paged pool. tokens: (B, 1); pos: (B,) int32
    per-slot positions; pages: (B, max_pages) int32. The pools in `cache`
    are updated in place; returns (logits (B, 1, V), cache)."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    new_cache = []
    for p, bs, c in zip(params["blocks"], sp.blocks, cache):
        x, c = block_decode(p, x, c, pos, bs, cfg, ctx, pages=pages)
        new_cache.append(c)
    return _logits(params, x, sp, ctx), new_cache


def _chunk_stack(params, cache, tokens, pos0, sp: ModelSpecs, ctx: ModelCtx, kw):
    """Embed `tokens` (B, C) and run the chunk path through every block;
    returns (hidden (B, C, D), cache)."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    new_cache = []
    for p, bs, c in zip(params["blocks"], sp.blocks, cache):
        x, c = block_chunk(p, x, c, pos0, bs, cfg, ctx, **kw)
        new_cache.append(c)
    return x, new_cache


def decode_verify(params, cache, tokens, pos0, sp: ModelSpecs, ctx: ModelCtx, *,
                  read_pages, write_pages, nreal):
    """The full-precision multi-token verify step of self-speculative decoding.

    tokens: (B, K), row b = [last accepted token, draft_0, .., draft_{K-2}]
    at positions pos0[b] .. pos0[b]+K-1, right-padded past nreal[b]. The
    chunk path writes exact K/V over the whole range (in place, overwriting
    whatever the draft wrote there) before any read, and logits come back
    for EVERY row (B, K, V): row t is what a sequential `decode_step` gives
    at position pos0+t after consuming tokens[:, :t+1]."""
    kw = dict(read_pages=read_pages, write_pages=write_pages, nreal=nreal)
    x, new_cache = _chunk_stack(params, cache, tokens, pos0, sp, ctx, kw)
    return _logits(params, x, sp, ctx), new_cache


def init_cache(cfg: ArchConfig, num_pages: int, page_size: int, kv_dtype=None,
               device="cpu"):
    """Zeroed per-layer paged KV pools, (num_pages, page_size, Hk, dh) each."""
    out = []
    for _ in build_specs(cfg).blocks:
        shapes = attention.init_cache_shapes(cfg, num_pages, page_size, kv_dtype)
        out.append({k: torch.zeros(shp, dtype=dt, device=device)
                    for k, (shp, dt) in shapes.items()})
    return out
