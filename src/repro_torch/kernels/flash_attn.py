"""Causal GQA flash attention for prefill — counterpart of
`repro.kernels.flash_attn`.

`flash_attention` launches the CUDA kernel (`csrc/flash_attn.cu`: bf16 on
the tensor cores, f32 on the CUDA cores) for CUDA tensors; for CPU tensors
it runs `flash_attention_plain`, the reference's
`_flash_kernel` algebra in torch: 256-row query and KV blocks, scores in
f32 scaled after the dot, NEG_INF causal mask, online softmax (m, l, acc in
f32), p rounded to v's dtype before the PV product, out / max(l, 1e-20).

Layout: q (B, H, Tq, dh), k/v (B, Hk, Tk, dh) — the reference's (BH, T,
dh) is B = 1 — with query head h reading kv head h // (H / Hk). Any strides
with a contiguous dh are taken, so the model passes views of its (B, T, H,
dh) activations.
"""
from __future__ import annotations

import ctypes

import torch

from .build import Kernel

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FLASH_ATTN = Kernel("flash_attn", "repro_flash_attn",
                    [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.POINTER(ctypes.c_longlong), _I, _F])
_DT = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 256,
                          bk: int = 256) -> torch.Tensor:
    """The reference's blocked online softmax in torch; (B, H, Tq, dh) in
    q's dtype. Block sizes clamp to the problem and must divide it."""
    b, h, tq, dh = q.shape
    hk, tk = k.shape[1], k.shape[2]
    g = h // hk
    bq, bk = min(bq, tq), min(bk, tk)
    if tq % bq or tk % bk:
        raise ValueError(f"blocks ({bq}, {bk}) must divide (Tq, Tk) = ({tq}, {tk})")
    scale = 1.0 / dh ** 0.5
    dev = q.device
    qg = q.reshape(b, hk, g, tq, dh).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for qi in range(tq // bq):
        qb = qg[:, :, :, qi * bq:(qi + 1) * bq]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((b, hk, g, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hk, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hk, g, bq, dh), dtype=torch.float32, device=dev)
        for ki in range(tk // bk):
            ks = kf[:, :, ki * bk:(ki + 1) * bk]
            vs = vf[:, :, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bhgqd,bhsd->bhgqs", qb, ks) * scale
            if causal:
                k_pos = ki * bk + torch.arange(bk, device=dev)
                s = torch.where((q_pos[:, None] >= k_pos[None, :]), s,
                                torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = p.to(v.dtype).to(torch.float32)
            acc = acc * corr[..., None] + torch.einsum("bhgqs,bhsd->bhgqd", pv, vs)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    return torch.cat(outs, dim=3).reshape(b, h, tq, dh).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Causal (or full) GQA attention. q: (B, H, Tq, dh); k, v: (B, Hk, Tk,
    dh), H % Hk == 0, same dtype (f32 or bf16). Returns (B, H, Tq, dh) in
    q's dtype; on the card its memory is laid out (B, Tq, H, dh), so
    `.transpose(1, 2)` of it is contiguous."""
    b, h, tq, dh = q.shape
    if (k.shape[0] != b or v.shape != k.shape or k.shape[3] != dh
            or h % k.shape[1]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    ts = (q, k, v)
    if any(t.device != q.device or t.stride(3) != 1 for t in ts):
        raise ValueError(f"flash_attention: q, k, v must lie on {q.device} "
                         f"with a contiguous last dim")
    if q.dtype not in _DT or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         "float32 or bfloat16")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in ts):
        raise ValueError("flash_attention: bf16 rows must start 16-byte aligned "
                         "(aligned storage, strides multiples of 8)")
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    FLASH_ATTN(_DT[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, h, k.shape[1], tq, k.shape[2], dh, strides,
               int(causal), 1.0 / dh ** 0.5)
    return out
