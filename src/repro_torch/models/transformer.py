"""Model assembly for the dense and MoE decoders, serve path — counterpart
of `repro.models.transformer`.

Each block is pre-norm residual: x += attn(norm(x)); x += ffn(norm(x)),
where the FFN of an MoE arch is the expert block (`models.moe`).
The reference scans the middle layers over stacked params (`lax.scan`, the
analogue of BrainTTA's hardware loop buffer); PyTorch runs eagerly, so here
the stack is a plain list of per-layer blocks and a Python loop. Layer 0
and layer n-1 get the policy's first/last precision, as in the reference.

Params (serve layout, `pack_for_serve`):
    {"embed": {"w"}, "blocks": [block, ...], "final_norm": {"scale"},
     "lm_head": packed qlinear}
Cache (`init_cache`): a list with one {"k", "v"} pool dict per layer.
Only the `attn` block kind is ported. `decode_verify` runs a multi-token
range through the chunk path (the speculative verify step). Under
`ctx.moe_stats` the serve entry points also return the MoE routing
counters summed over the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import qlinear
from repro_torch.core.precision import get_policy

from . import attention, common, ffn, moe
from .common import ModelCtx


@dataclasses.dataclass(frozen=True)
class BlockSpecs:
    kind: str
    mixer: Any
    ffn: Any = None        # FFNSpecs | MoESpecs | None
    is_moe: bool = False


def block_specs(cfg: ArchConfig, pol, kind: str, *, first=False,
                last=False) -> BlockSpecs:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not yet ported")
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: only decoders without a "
                                  f"frontend are ported")
    mix = attention.attn_specs(cfg, pol, first=first, last=last)
    f, is_moe = None, False
    if cfg.d_ff > 0:
        if cfg.n_experts:
            f, is_moe = moe.moe_specs(cfg, pol, first=first, last=last), True
        else:
            f = ffn.ffn_specs(cfg, pol, first=first, last=last)
    return BlockSpecs(kind, mix, f, is_moe)


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


def _block_init(generator: torch.Generator, cfg: ArchConfig, bs: BlockSpecs,
                dtype, device) -> dict:
    d = cfg.d_model
    p = {"norm1": common.norm_init(d, cfg.norm, dtype, device),
         "mixer": {"qkv": qlinear.init(generator, bs.mixer.qkv, dtype, device),
                   "out": qlinear.init(generator, bs.mixer.out, dtype, device)}}
    if bs.ffn is not None:
        p["norm2"] = common.norm_init(d, cfg.norm, dtype, device)
        p["ffn"] = (moe.moe_init(generator, bs.ffn, dtype, device) if bs.is_moe
                    else {"up": qlinear.init(generator, bs.ffn.up, dtype, device),
                          "down": qlinear.init(generator, bs.ffn.down, dtype,
                                               device)})
    return p


def _init_parts(cfg: ArchConfig, generator: torch.Generator, device, block_fn):
    """The train-layout parameters, drawn in one order (embedding, blocks
    first .. last, lm_head), with `block_fn(params, specs)` applied to each
    block as soon as it is drawn."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are not yet ported")
    sp = build_specs(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    return sp, {
        "embed": common.embed_init(generator, cfg.vocab, cfg.d_model, dtype, device),
        "blocks": [block_fn(_block_init(generator, cfg, bs, dtype, device), bs)
                   for bs in sp.blocks],
        "final_norm": common.norm_init(cfg.d_model, cfg.norm, dtype, device),
        "lm_head": qlinear.init(generator, sp.lm_head, dtype, device),
    }


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Train-layout parameters from the port's own seeded init: the same
    distributions as the reference (`qlinear.init` normal/sqrt(in_dim),
    `embed_init` normal*0.02, norm scales ones, zero biases), drawn from a
    torch Generator — so the values differ from the JAX package's. Tests
    that compare with JAX carry the JAX weights over (`repro_torch.bridge`).
    The generator must live on `device`."""
    return _init_parts(cfg, generator, device, lambda p, bs: p)[1]


def init_for_serve(cfg: ArchConfig, generator: torch.Generator, device="cuda", *,
                   plane_twins: bool = False) -> tuple[dict, int]:
    """`pack_for_serve(init(cfg, generator, device), cfg)` without holding
    the whole train layout: each block is packed as soon as it is drawn and
    its train-layout tensors are freed, so the peak is the packed model
    plus one block (full-depth phi3.5-moe is ~84 GB in bf16, ~10-21 GB
    packed). Same draws, same values. Returns (packed params, bytes of the
    train layout)."""
    train = 0
    strip = (lambda t: t) if plane_twins else _strip_plane_twins

    def pack_block(p, bs):
        nonlocal train
        train += common.tree_nbytes(p)
        return strip(block_pack(p, bs))

    sp, params = _init_parts(cfg, generator, device, pack_block)
    train += common.tree_nbytes({k: v for k, v in params.items() if k != "blocks"})
    out = {"embed": {"w": params["embed"]["w"].to(torch.bfloat16)},
           "blocks": params["blocks"], "final_norm": params["final_norm"],
           "lm_head": strip(qlinear.pack_params(params["lm_head"], sp.lm_head))}
    return out, train


def block_pack(p, bs: BlockSpecs):
    """Train-layout block params -> packed serve layout."""
    out = {k: v for k, v in p.items() if k.startswith("norm")}
    m = p["mixer"]
    out["mixer"] = {"qkv": qlinear.pack_params(m["qkv"], bs.mixer.qkv),
                    "out": qlinear.pack_params(m["out"], bs.mixer.out)}
    if bs.ffn is not None:
        out["ffn"] = (moe.moe_pack(p["ffn"], bs.ffn) if bs.is_moe else
                      {"up": qlinear.pack_params(p["ffn"]["up"], bs.ffn.up),
                       "down": qlinear.pack_params(p["ffn"]["down"], bs.ffn.down)})
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

def _moe_ffn(p, x, bs: BlockSpecs, cfg: ArchConfig, ctx: ModelCtx):
    """The FFN tail every serve entry shares: residual add of the FFN or
    MoE block. Returns (x, st): st is the block's routing counters
    {"expert_tokens", "dropped"} iff it is an MoE block and ctx.moe_stats is
    on, else None."""
    st = None
    if bs.ffn is None:
        return x, st
    h2 = common.norm_apply(p["norm2"], x, cfg.norm)
    if bs.is_moe:
        y, a = moe.moe_apply(p["ffn"], h2, bs.ffn, ctx)
        if ctx.moe_stats:
            st = a
    else:
        y = ffn.ffn_apply(p["ffn"], h2, bs.ffn, ctx)
    return x + y, st


def _moe_zero(cfg: ArchConfig, ctx: ModelCtx, device):
    """The zero routing-counter sum when stats are on for an MoE arch, else
    None."""
    if not (ctx.moe_stats and cfg.n_experts):
        return None
    return {"expert_tokens": torch.zeros((cfg.n_experts,), dtype=torch.int32,
                                         device=device),
            "dropped": torch.zeros((), dtype=torch.int32, device=device)}


def _moe_add(tot, st):
    if tot is None or st is None:
        return tot
    return {k: tot[k] + st[k] for k in tot}


def _with_stats(out: tuple, tot, ctx: ModelCtx) -> tuple:
    return out + (tot,) if ctx.moe_stats else out


def block_prefill(p, x, bs: BlockSpecs, cfg: ArchConfig, ctx: ModelCtx, *,
                  cache_len: int = 0):
    """Prefill through one block; returns (x, cache, st), st per `_moe_ffn`."""
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_apply(p["mixer"], h, bs.mixer, cfg, ctx,
                                    return_cache=True, cache_len=cache_len)
    x, st = _moe_ffn(p, x + m, bs, cfg, ctx)
    return x, cache, st


def block_decode(p, x, cache, pos, bs: BlockSpecs, cfg: ArchConfig,
                 ctx: ModelCtx, *, pages):
    """One-token decode through one block. x: (B, 1, D); pos: (B,).
    Returns (x, cache, st), st per `_moe_ffn`."""
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_decode(p["mixer"], h, cache, pos, bs.mixer, cfg,
                                     ctx, pages=pages)
    x, st = _moe_ffn(p, x + m, bs, cfg, ctx)
    return x, cache, st


def block_chunk(p, x, cache, pos0, bs: BlockSpecs, cfg: ArchConfig,
                ctx: ModelCtx, *, read_pages, write_pages, nreal):
    """A multi-token chunk through one block. x: (B, C, D); pos0: (B,).
    Only full-attention blocks have a pageable partial prefix. Returns
    (x, cache, st), st per `_moe_ffn`."""
    if bs.kind != "attn":
        raise ValueError(f"a chunk needs attn blocks, got {bs.kind}")
    h = common.norm_apply(p["norm1"], x, cfg.norm)
    m, cache = attention.attn_prefill_chunk(
        p["mixer"], h, cache, pos0, bs.mixer, cfg, ctx, read_pages=read_pages,
        write_pages=write_pages, nreal=nreal)
    x, st = _moe_ffn(p, x + m, bs, cfg, ctx)
    return x, cache, st


def _logits(params, x, sp: ModelSpecs, ctx: ModelCtx):
    x = common.norm_apply(params["final_norm"], x, sp.cfg.norm)
    return common.linear_apply(params["lm_head"], x, sp.lm_head,
                               ctx).to(torch.float32)


def prefill(params, tokens, sp: ModelSpecs, ctx: ModelCtx, *,
            cache_len: int = 0, last_pos=None):
    """Process the prompt; return (last-position logits (B, 1, V), caches),
    and the routing counters under ctx.moe_stats (they count the bucket's
    padding rows too, as the reference's do).

    `cache_len`: KV rows per layer cache (0 => prompt length). `last_pos`:
    (B,) index of each row's final real token when `tokens` is
    right-padded to a bucket length; None => the last column. Causal
    masking keeps real positions from attending to the padding."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    cache_len = cache_len or x.shape[1]
    caches = []
    tot = _moe_zero(cfg, ctx, x.device)
    for p, bs in zip(params["blocks"], sp.blocks):
        x, c, st = block_prefill(p, x, bs, cfg, ctx, cache_len=cache_len)
        caches.append(c)
        tot = _moe_add(tot, st)
    if last_pos is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long().reshape(-1, 1, 1)
        x_last = torch.take_along_dim(x, idx, dim=1)
    return _with_stats((_logits(params, x_last, sp, ctx), caches), tot, ctx)


def decode_step(params, cache, tokens, pos, sp: ModelSpecs, ctx: ModelCtx, *,
                pages):
    """One decode step over the paged pool. tokens: (B, 1); pos: (B,) int32
    per-slot positions; pages: (B, max_pages) int32. The pools in `cache`
    are updated in place; returns (logits (B, 1, V), cache), and the routing
    counters under ctx.moe_stats (idle rows are routed and counted, as in
    the reference)."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    new_cache = []
    tot = _moe_zero(cfg, ctx, x.device)
    for p, bs, c in zip(params["blocks"], sp.blocks, cache):
        x, c, st = block_decode(p, x, c, pos, bs, cfg, ctx, pages=pages)
        new_cache.append(c)
        tot = _moe_add(tot, st)
    return _with_stats((_logits(params, x, sp, ctx), new_cache), tot, ctx)


def _chunk_stack(params, cache, tokens, pos0, sp: ModelSpecs, ctx: ModelCtx, kw):
    """Embed `tokens` (B, C) and run the chunk path through every block;
    returns (hidden (B, C, D), cache, routing counters or None)."""
    cfg = sp.cfg
    x = common.embed_apply(params["embed"], tokens, ctx.dtype)
    new_cache = []
    tot = _moe_zero(cfg, ctx, x.device)
    for p, bs, c in zip(params["blocks"], sp.blocks, cache):
        x, c, st = block_chunk(p, x, c, pos0, bs, cfg, ctx, **kw)
        new_cache.append(c)
        tot = _moe_add(tot, st)
    return x, new_cache, tot


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
    x, new_cache, tot = _chunk_stack(params, cache, tokens, pos0, sp, ctx, kw)
    return _with_stats((_logits(params, x, sp, ctx), new_cache), tot, ctx)


def init_cache(cfg: ArchConfig, num_pages: int, page_size: int, kv_dtype=None,
               device="cpu"):
    """Zeroed per-layer paged KV pools, (num_pages, page_size, Hk, dh) each."""
    out = []
    for _ in build_specs(cfg).blocks:
        shapes = attention.init_cache_shapes(cfg, num_pages, page_size, kv_dtype)
        out.append({k: torch.zeros(shp, dtype=dt, device=device)
                    for k, (shp, dt) in shapes.items()})
    return out
