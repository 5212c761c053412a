"""Ternary MAC bodies — the vTMAC unit (counterpart of `repro.kernels.tgemm`).

Trits are two bit-planes (mask, sign) per `core.pack`.

  TERNARY_POPCOUNT — the gated XNOR: with
                         active   = popc(xm & wm)
                         disagree = popc(xm & wm & (xs ^ ws))
                     the dot is active - 2*disagree. The CUDA body
                     (`csrc/gemm.cu`, BODY_TERNARY) keeps both sides
                     packed: `tpop_stream_kernel` up to 8 rows adds each
                     word's active - 2*disagree, `pop_mma_kernel` above runs
                     the b1 tensor cores' AND-popc on the positive and
                     negative planes (m & ~s, m & s) and the masks, dot =
                     2*agree - active; a grouped call runs
                     `pop_mma_kernel` at every M, a 16-row tile up to 16
                     rows, with a grid z. The plain version is
                     `core.pack.ternary_dot_words`.
  TERNARY_MXU      — both sides unpacked to {-1,0,+1} int8 and dotted
                     (BODY_TERNARY_MXU: `tmxu_stream_kernel` up to 8 rows,
                     `tmxu_mma_kernel` on the int8 tensor cores above, and
                     for a grouped call at every M, a 16-row tile up to
                     16 rows); integer-exact, so equal to TERNARY_POPCOUNT.
  TERNARY_W_I8A    — mixed w-ternary x a-int8: (M, K) int8 activation codes
                     against trit weight planes unpacked to int8
                     (BODY_TERNARY_W_I8A: `wt_stream_kernel` up to 8 rows,
                     `wt_mma_kernel` on the int8 tensor cores above, and
                     for a grouped call at every M, a 16-row tile up to
                     16 rows; its activation rows, every group member's
                     too, must start 16-byte aligned on the card). The two sides have different densities: 1
                     code per unit for x, 32 per word for w.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .bgemm import chunked_over_n, unpacked_dot
from .harness import (GEMM_GROUPED_MXU, GEMM_GROUPED_POP, GEMM_GROUPED_WT_I8A, MacBody,
                      gemm_kernel)


def ternary_popcount_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    (xm, xs), (wm, ws) = x_ops, w_ops
    return chunked_over_n(
        lambda a, b: pack.ternary_dot_words(xm[:, None, :], xs[:, None, :],
                                            wm[a:b], ws[a:b]),
        xm.shape[0], wm.shape[0], xm.device)


TERNARY_POPCOUNT = MacBody("tgemm_popcount", body_id=2, n_x=2, n_w=2,
                           k_per_q=pack.WORD, plain=ternary_popcount_plain,
                           kernel=gemm_kernel(), grouped=GEMM_GROUPED_POP)


def ternary_mxu_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    (xm, xs), (wm, ws) = x_ops, w_ops
    return unpacked_dot(pack.unpack_ternary_i8(xm, xs, k),
                        lambda a, b: pack.unpack_ternary_i8(wm[a:b], ws[a:b], k),
                        wm.shape[0])


TERNARY_MXU = MacBody("tgemm_mxu", body_id=4, n_x=2, n_w=2, k_per_q=pack.WORD,
                      plain=ternary_mxu_plain, kernel=gemm_kernel(),
                      grouped=GEMM_GROUPED_MXU)


def ternary_w_i8a_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    wm, ws = w_ops
    return unpacked_dot(x_ops[0],
                        lambda a, b: pack.unpack_ternary_i8(wm[a:b], ws[a:b], k),
                        wm.shape[0])


TERNARY_W_I8A = MacBody("tgemm_wt_i8a", body_id=5, n_x=1, n_w=2,
                        k_per_q=pack.WORD, xk_per_q=1, wk_per_q=pack.WORD,
                        plain=ternary_w_i8a_plain, kernel=gemm_kernel(),
                        grouped=GEMM_GROUPED_WT_I8A)
