"""Ternary gated-XNOR MAC body — the vTMAC unit (counterpart of
`repro.kernels.tgemm`, TERNARY_POPCOUNT).

Trits are two bit-planes (mask, sign) per `core.pack`. The CUDA body
(`csrc/gemm.cu`, BODY_TERNARY) keeps two int32 accumulators:
    active   += popc(xm & wm)
    disagree += popc(xm & wm & (xs ^ ws))
and the dot is active - 2*disagree. The plain version is
`core.pack.ternary_dot_words`.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .bgemm import chunked_over_n
from .harness import MacBody, gemm_kernel


def ternary_popcount_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    (xm, xs), (wm, ws) = x_ops, w_ops
    return chunked_over_n(
        lambda a, b: pack.ternary_dot_words(xm[:, None, :], xs[:, None, :],
                                            wm[a:b], ws[a:b]),
        xm.shape[0], wm.shape[0], xm.device)


TERNARY_POPCOUNT = MacBody("tgemm_popcount", body_id=2, n_x=2, n_w=2,
                           k_per_q=pack.WORD, plain=ternary_popcount_plain,
                           kernel=gemm_kernel())
