"""GQA attention, serve path — counterpart of `repro.models.attention`:
causal prefill (through the flash-attention kernel where the reference
takes its Pallas kernel, else blockwise in plain torch), and one-token
decode over the paged KV pool through the paged flash-decode kernel.

Layouts follow the reference: q (B, T, H, dh), k/v (B, T, Hk, dh); query
head h reads kv head h // G. `attn_prefill_chunk` runs a multi-token range
against the paged pool; it backs the speculative verify step. Sliding-window
(`local`) layers, the contiguous-slab decode cache, chunked-prefill
scheduling and cross-attention are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import flash_attn, paged_attn

from . import common
from .common import ModelCtx

NEG_INF = -1e30
KV_SCALE = 0.05   # static requant scale for the int8 KV cache (§Perf C)


def _kv_quant(t, dtype):
    """Requantize K/V for cache storage: int8 codes at a static scale, or a
    passthrough cast. The inverse, `_kv_dequant` in the reference, is
    `kernels.paged_attn.kv_dequant` (the paged read path's)."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(t.to(torch.float32) / KV_SCALE),
                           -127, 127).to(torch.int8)
    return t.to(dtype)


@dataclasses.dataclass(frozen=True)
class AttnSpecs:
    qkv: Any
    out: Any


def attn_specs(cfg: ArchConfig, pol: PrecisionPolicy, *, first=False,
               last=False) -> AttnSpecs:
    h, hk, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model

    def mk(lc, i, o, bias=False):
        return common.lspec(pol, lc, i, o, first=first, last=last, bias=bias)

    return AttnSpecs(qkv=mk("attn_qkv", d, (h + 2 * hk) * dh, bias=cfg.qkv_bias),
                     out=mk("attn_out", h * dh, d))


def _split_qkv(y: torch.Tensor, cfg: ArchConfig):
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, t, _ = y.shape
    q, k, v = torch.split(y, [h * dh, hk * dh, hk * dh], dim=-1)
    return (q.reshape(b, t, h, dh), k.reshape(b, t, hk, dh),
            v.reshape(b, t, hk, dh))


def _gqa_scores_blockless(q, k, v, mask):
    """Reference small-scale attention. q: (B,Tq,H,dh) k/v: (B,Tk,Hk,dh)."""
    b, tq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, tq, hk, g, dh)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k).to(torch.float32) / dh ** 0.5
    s = torch.where(mask[:, None, None, :, :], s, _neg_inf(s))
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgts,bshd->bthgd", a, v)
    return o.reshape(b, tq, h, dh)


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=like.dtype, device=like.device)


def blockwise_attention(q, k, v, *, causal: bool, q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """Flash-style blocked attention with online softmax (plain torch; the
    reference has no kernel here either).

    q: (B, Tq, H, dh); k, v: (B, Tk, Hk, dh). Loops over q blocks and kv
    blocks with m/l/acc carries in f32; odd shapes fall back to the
    blockless reference, as in the JAX package."""
    b, tq, h, dh = q.shape
    tk, hk = k.shape[1], k.shape[2]
    g = h // hk
    q_block = min(q_block, tq)
    kv_block = min(kv_block, tk)
    dev = q.device
    if tq % q_block or tk % kv_block:           # fallback for odd shapes
        pos_q = torch.arange(tq, device=dev)
        pos_k = torch.arange(tk, device=dev)
        mask = torch.ones((b, tq, tk), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos_q[None, :, None] >= pos_k[None, None, :]
        return _gqa_scores_blockless(q, k, v, mask)

    scale = 1.0 / dh ** 0.5
    outs = []
    for qi in range(tq // q_block):
        qb = q[:, qi * q_block:(qi + 1) * q_block].reshape(b, q_block, hk, g, dh)
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((b, hk, g, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hk, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hk, g, q_block, dh), dtype=torch.float32, device=dev)
        for kj in range(tk // kv_block):
            ks = k[:, kj * kv_block:(kj + 1) * kv_block]
            vs = v[:, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bqhgd,bshd->bhgqs", qb, ks).to(torch.float32) * scale
            if causal:
                k_pos = kj * kv_block + torch.arange(kv_block, device=dev)
                msk = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(msk[None, None, None], s, _neg_inf(s))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqs,bshd->bhgqd", p.to(q.dtype), vs).to(torch.float32)
            m = m_new
        o = (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)  # (B,Hk,G,qb,dh)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, dh))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# block-level apply: prefill and decode
# ---------------------------------------------------------------------------

def attn_apply(p, x, specs: AttnSpecs, cfg: ArchConfig, ctx: ModelCtx, *,
               return_cache: bool = False, cache_len: int = 0):
    """Full-sequence causal attention (prefill). x: (B, T, D).

    With return_cache, the KV cache is (B, cache_len, Hk, dh) per leaf:
    the T prompt rows, zero-padded to `cache_len` (>= T)."""
    b, t, _ = x.shape
    y = common.linear_apply(p["qkv"], x, specs.qkv, ctx)
    q, k, v = _split_qkv(y, cfg)
    positions = torch.arange(t, device=x.device)
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)
    if t % 256 == 0:
        # where the reference's TPU path runs kernels/flash_attn.py: the
        # flash-attention kernel on the card, its plain version on the CPU
        o = flash_attn.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)).transpose(1, 2)
    else:
        o = blockwise_attention(q, k, v, causal=True)
    out = common.linear_apply(p["out"], o.reshape(b, t, -1), specs.out, ctx)
    if not return_cache:
        return out
    cap = max(cache_len or t, 1)
    if t > cap:
        k, v = k[:, -cap:], v[:, -cap:]
    elif t < cap:
        pad = (0, 0, 0, 0, 0, cap - t)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    cd = torch.int8 if cfg.kv_cache_dtype == "int8" else k.dtype
    return out, {"k": _kv_quant(k, cd), "v": _kv_quant(v, cd)}


def init_cache_shapes(cfg: ArchConfig, num_pages: int, page_size: int,
                      dtype=None):
    """(shape, dtype) of one attention layer's K and V block pools,
    (num_pages, page_size, Hk, dh). The reference's per-slot slab layout
    (`--contiguous`) is not ported."""
    if dtype is None:
        dtype = getattr(torch, cfg.kv_cache_dtype)
    shp = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shp, dtype), "v": (shp, dtype)}


def attn_decode(p, x, cache, pos, specs: AttnSpecs, cfg: ArchConfig,
                ctx: ModelCtx, *, pages):
    """One-token decode over the paged pool. x: (B, 1, D); pos: (B,) int32
    per-slot positions; cache k/v: (num_pages, page_size, Hk, dh); pages:
    (B, max_pages) int32 page table.

    Each slot's RoPE phase and write index follow its own position. The new
    token's K/V are written into the pool IN PLACE (the reference returns a
    new pool; updating in place saves a pool copy per layer per tick), then
    `paged_flash_decode` reads through the same table. Returns (out, cache)
    with the cache dict holding the updated pools."""
    b = x.shape[0]
    y = common.linear_apply(p["qkv"], x, specs.qkv, ctx)
    q, k_new, v_new = _split_qkv(y, cfg)
    posb = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    posv = posb[:, None]
    q = common.rope(q, posv, cfg.rope_theta)
    k_new = common.rope(k_new, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    page_size = k.shape[1]
    rows = torch.arange(b, device=x.device)
    pid = pages.long()[rows, (posb // page_size).long()]
    off = (posb % page_size).long()
    k[pid, off] = _kv_quant(k_new, k.dtype)[:, 0]
    v[pid, off] = _kv_quant(v_new, v.dtype)[:, 0]
    h, dh = cfg.n_heads, cfg.head_dim
    o = paged_attn.paged_flash_decode(q[:, 0].contiguous(), k, v,
                                      pages.to(torch.int32).contiguous(),
                                      posb.contiguous(), kv_scale=KV_SCALE)
    out = common.linear_apply(p["out"], o.reshape(b, 1, h * dh), specs.out, ctx)
    return out, {"k": k, "v": v}


def attn_prefill_chunk(p, x, cache, pos0, specs: AttnSpecs, cfg: ArchConfig,
                       ctx: ModelCtx, *, read_pages, write_pages, nreal):
    """A multi-token chunk against the paged pool at a position offset.

    x: (B, C, D), right-padded past `nreal` (B,); pos0: (B,) absolute
    position of each row's first token; read_pages / write_pages: (B,
    max_pages) page rows. Token t sits at position pos0+t: its K/V are
    written IN PLACE to write_pages[(pos0+t)//P] offset (pos0+t)%P (padding
    rows t >= nreal go to the scratch page), for every valid row before any
    read, and its query attends every pooled token at position <= pos0+t.

    How a row reads: on the CPU, the reference's f32 algebra (gather the
    read rows, mask, one softmax over the chunk); on the card, through the
    paged flash-decode kernel over B*C virtual rows, row (b, t) repeating
    slot b's page row at position pos0[b]+t, so that each row reads exactly
    as a sequential decode step at that position does (a padding row reads
    at its slot's last valid position and is ignored)."""
    b, c, _ = x.shape
    dev = x.device
    y = common.linear_apply(p["qkv"], x, specs.qkv, ctx)
    q, k_new, v_new = _split_qkv(y, cfg)
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=dev).reshape(b)
    nreal = torch.as_tensor(nreal, dtype=torch.int32, device=dev).reshape(b)
    tt = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    positions = pos0[:, None] + tt                                    # (B, C)
    q = common.rope(q, positions, cfg.rope_theta)
    k_new = common.rope(k_new, positions, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    page_size = k.shape[1]
    rows = torch.arange(b, device=dev)[:, None]
    pidx = torch.clamp(positions // page_size, max=write_pages.shape[1] - 1).long()
    pid = torch.where(tt < nreal[:, None], write_pages.long()[rows, pidx], 0)
    off = (positions % page_size).long()
    k[pid, off] = _kv_quant(k_new, k.dtype)
    v[pid, off] = _kv_quant(v_new, v.dtype)

    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if dev.type == "cuda":
        last = torch.clamp(nreal - 1, min=0)[:, None]
        vpos = (pos0[:, None] + torch.minimum(tt, last)).reshape(-1)
        vpages = read_pages.to(torch.int32).repeat_interleave(c, dim=0)
        o = paged_attn.paged_flash_decode(q.reshape(b * c, h, dh).contiguous(), k, v,
                                          vpages.contiguous(), vpos.contiguous(),
                                          kv_scale=KV_SCALE)
        o = o.reshape(b, c, h * dh)
    else:
        s = read_pages.shape[1] * page_size
        rp = read_pages.long()
        kf = paged_attn.kv_dequant(k[rp].reshape(b, s, hk, dh), x.dtype, KV_SCALE)
        vf = paged_attn.kv_dequant(v[rp].reshape(b, s, hk, dh), x.dtype, KV_SCALE)
        valid = (torch.arange(s, device=dev)[None, None, :]
                 <= positions[:, :, None])                             # (B, C, S)
        qg = q.reshape(b, c, hk, h // hk, dh)
        sc = torch.einsum("bthgd,bshd->bhgts", qg, kf).to(torch.float32) / dh ** 0.5
        sc = torch.where(valid[:, None, None], sc, _neg_inf(sc))
        a = torch.softmax(sc, dim=-1).to(x.dtype)
        o = torch.einsum("bhgts,bshd->bthgd", a, vf).reshape(b, c, h * dh)
    out = common.linear_apply(p["out"], o, specs.out, ctx)
    return out, {"k": k, "v": v}
