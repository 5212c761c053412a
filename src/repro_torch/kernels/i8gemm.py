"""int8 MAC body — the 8-bit vMAC path (counterpart of `repro.kernels.i8gemm`).

(M, K) int8 activation codes x K-major (K, N) int8 weight codes -> int32.
On the card (`csrc/gemm.cu`, BODY_I8) up to 8 rows run `i8_stream_kernel`
(the weights streamed through registers, byte-transposed into `__dp4a`
words, K split across blocks when the column tiles are too few to fill the
card) and more rows `i8_mma_kernel` (the int8 tensor cores); a grouped call
(K11) runs `i8_mma_kernel` with a grid z over the members, a 16-row tile
up to 16 rows. The plain version below is the same integer dot
in torch.
"""
from __future__ import annotations

import torch

from .harness import GEMM_GROUPED, MacBody, gemm_kernel


def i8_dot_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32. Exact: in float64 every
    product and every partial sum is an integer below 127^2 * K < 2^53, so
    the sum does not depend on its order (float32 would round past 2^24)."""
    return (x_ops[0].to(torch.float64) @ w_ops[0].to(torch.float64)).to(torch.int32)


I8_DOT = MacBody("i8gemm", body_id=0, n_x=1, n_w=1, k_per_q=1,
                 plain=i8_dot_plain, kernel=gemm_kernel(), grouped=GEMM_GROUPED,
                 w_kmajor=True)
