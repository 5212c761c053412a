"""Paged-attention decode: flash-decode over the page table — counterpart of
`repro.kernels.paged_attn`.

`paged_flash_decode` launches the CUDA kernel (`csrc/paged_attn.cu`) for
CUDA tensors; for CPU tensors it runs `paged_decode_plain`, the gather
algebra of the reference's `models.attention.attn_decode` paged path:
gather the slot's pages into a dense (B, S, Hk, dh) view, dequantize,
mask `tok <= pos`, softmax, weighted sum. The kernel splits each row's
tokens into CHUNK-token chunks, one block each, and merges the chunks'
partials through a workspace (counters and partials) that `_workspace`
keeps per device and stream.
"""
from __future__ import annotations

import ctypes

import torch

from .build import Kernel

NEG_INF = -1e30

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
PAGED_DECODE = Kernel("paged_attn", "repro_paged_decode",
                      [_I, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _F, _P, _L, _P, _L])
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: tokens a block of the kernel takes, at fixed positions (csrc/paged_attn.cu
#: CHUNK; the kernel refuses a workspace too small for its chunks)
CHUNK = 64
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, ints: int, floats: int):
    """The kernel's workspace on `stream` of `dev`: int32 counters, one per
    (row, kv head), zero (the kernel leaves them zero), and f32 room for the
    chunks' partials. Allocated at first use and again only when a launch
    needs more, never per call; launches on one stream share it, launches
    on two streams never do."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < ints or ws[1].numel() < floats:
        had = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = _workspaces[key] = (
            torch.zeros(max(ints, 2 * had[0], 1 << 10), dtype=torch.int32, device=dev),
            torch.empty(max(floats, 2 * had[1], 1 << 16), dtype=torch.float32,
                        device=dev))
    return ws


def kv_dequant(c: torch.Tensor, compute_dtype, kv_scale: float) -> torch.Tensor:
    """int8 codes at the static KV scale, or a passthrough cast."""
    if c.dtype == torch.int8:
        return (c.to(torch.float32) * kv_scale).to(compute_dtype)
    return c.to(compute_dtype)


def paged_decode_plain(q, k_pool, v_pool, pages, pos, *, kv_scale: float = 0.05):
    """The gather path: q (B, Hq, dh); pools (num_pages, P, Hk, dh); pages
    (B, max_pages) int32; pos (B,) int32 -> (B, Hq, dh) in q's dtype.

    The table is first cut to the pages below max(pos), as the reference
    does for eager callers; the cut pages are masked anyway."""
    b, hq, dh = q.shape
    _, page_size, hk, _ = k_pool.shape
    pages = pages[:, :int(pos.max()) // page_size + 1].long()
    s = pages.shape[1] * page_size
    kf = kv_dequant(k_pool[pages].reshape(b, s, hk, dh), q.dtype, kv_scale)
    vf = kv_dequant(v_pool[pages].reshape(b, s, hk, dh), q.dtype, kv_scale)
    valid = torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None]
    g = hq // hk
    qg = q.reshape(b, hk, g, dh)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, kf).to(torch.float32) / dh ** 0.5
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.tensor(NEG_INF, dtype=torch.float32, device=q.device))
    a = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", a, vf)
    return o.reshape(b, hq, dh)


def paged_flash_decode(q, k_pool, v_pool, pages, pos, *, kv_scale: float = 0.05):
    """Single-token decode attention through the page-table indirection.

    q: (B, Hq, dh) compute dtype; k_pool/v_pool: (num_pages, page_size, Hk,
    dh), int8 codes at `kv_scale` or the compute dtype; pages: (B,
    max_pages) int32 (unallocated entries point at the scratch page 0);
    pos: (B,) int32 — the new token's KV must already be written at
    pages[b, pos[b] // P] offset pos[b] % P. Returns (B, Hq, dh). On the
    card the pools must start 16-byte aligned, as whole tensors do.
    """
    b, hq, dh = q.shape
    num_pages, page_size, hk, dh_k = k_pool.shape
    if dh != dh_k or v_pool.shape != k_pool.shape or hq % hk:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}")
    if pages.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(f"pages {tuple(pages.shape)} / pos {tuple(pos.shape)} "
                         f"for {b} slots")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, pages, pos, kv_scale=kv_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    tensors = (q, k_pool, v_pool, pages, pos)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode: every operand must be a "
                         f"contiguous tensor on {q.device}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k_pool.dtype not in (q.dtype, torch.int8)
            or v_pool.dtype != k_pool.dtype
            or pages.dtype != torch.int32 or pos.dtype != torch.int32):
        raise ValueError("paged_flash_decode: q f32/bf16, pools in q's dtype "
                         "or int8, pages/pos int32")
    if dh % 32 or dh > 256 or (hq // hk > 8 and hq // hk != 12):
        raise ValueError(f"paged_flash_decode: needs dh % 32 == 0, dh <= 256 "
                         f"and <= 8 or 12 query heads per kv head (dh={dh}, "
                         f"G={hq // hk})")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_flash_decode: the pools must start 16-byte "
                         "aligned (the kernel copies rows 16 bytes at a time)")
    out = torch.empty_like(q)
    max_pages = pages.shape[1]
    chunks = -(-max_pages * page_size // CHUNK)
    stream = torch.cuda.current_stream().cuda_stream
    cnt, part = _workspace(q.device, stream, b * hk,
                           b * hk * chunks * (hq // hk) * (dh + 2))
    PAGED_DECODE(_DT[q.dtype], _DT[k_pool.dtype], q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), b, max_pages, page_size,
                 hq, hk, dh, 1.0 / dh ** 0.5, kv_scale, cnt.data_ptr(), cnt.numel(),
                 part.data_ptr(), part.numel(), stream=stream)
    return out
