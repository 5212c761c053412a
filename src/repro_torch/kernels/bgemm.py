"""Binary MAC bodies — the vBMAC unit (counterpart of `repro.kernels.bgemm`).

Operands are bit-packed along K (32 per int32 word, bit = 1 encodes +1).
Two formulations of the same integer dot:

  BINARY_POPCOUNT — the CUDA body (`csrc/gemm.cu`, BODY_BINARY) keeps both
                    sides packed: `bpop_stream_kernel` up to 8 rows sums
                    `__popc(x ^ w)` mismatches (the dot is K -
                    2*mismatches), `pop_mma_kernel` above runs the b1
                    tensor cores' AND-popc on x, w and their complements
                    (the dot is 2*agreements - K); a grouped call runs
                    `pop_mma_kernel` at every M, a 16-row tile up to 16
                    rows, with a grid z. The plain version is
                    `core.pack.binary_dot_words`.
  BINARY_MXU      — both sides unpacked to ±1 int8 and dotted (the
                    reference's MXU body; on the card BODY_BINARY_MXU runs
                    `bmxu_stream_kernel` up to 8 rows, __dp4a on weight
                    words unpacked in registers, and `bmxu_mma_kernel`
                    above, the int8 tensor cores on both sides unpacked in
                    shared memory; a grouped call runs `bmxu_mma_kernel`
                    at every M, a 16-row tile up to 16 rows). The dot is
                    integer-exact, so it equals BINARY_POPCOUNT's.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .harness import GEMM_GROUPED_MXU, GEMM_GROUPED_POP, MacBody, gemm_kernel

N_CHUNK = 4096   # bounds the plain versions' (M, N_CHUNK, K/32) temporaries


def chunked_over_n(fn, m: int, n: int, device) -> torch.Tensor:
    """(M, N) int32 from fn(n0, n1) -> (M, n1-n0), N_CHUNK columns at a time."""
    if n == 0:
        return torch.zeros((m, 0), dtype=torch.int32, device=device)
    return torch.cat([fn(n0, min(n0 + N_CHUNK, n))
                      for n0 in range(0, n, N_CHUNK)], dim=1)


def unpacked_dot(x: torch.Tensor, unpack_w, n: int) -> torch.Tensor:
    """(M, K) int8 codes x the (n1-n0, K) int8 weight rows `unpack_w(n0,
    n1)` yields -> (M, N) int32, N_CHUNK rows unpacked at a time. Exact: in
    float64 every product and partial sum is an integer below 2^53."""
    xd = x.to(torch.float64)
    return chunked_over_n(
        lambda a, b: (xd @ unpack_w(a, b).to(torch.float64).T).to(torch.int32),
        x.shape[0], n, x.device)


def binary_popcount_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    x, w = x_ops[0], w_ops[0]
    return chunked_over_n(
        lambda a, b: pack.binary_dot_words(x[:, None, :], w[a:b], k),
        x.shape[0], w.shape[0], x.device)


BINARY_POPCOUNT = MacBody("bgemm_popcount", body_id=1, n_x=1, n_w=1,
                          k_per_q=pack.WORD, plain=binary_popcount_plain,
                          kernel=gemm_kernel(), grouped=GEMM_GROUPED_POP)


def binary_mxu_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    w = w_ops[0]
    return unpacked_dot(pack.unpack_pm1_i8(x_ops[0], k),
                        lambda a, b: pack.unpack_pm1_i8(w[a:b], k), w.shape[0])


BINARY_MXU = MacBody("bgemm_mxu", body_id=3, n_x=1, n_w=1, k_per_q=pack.WORD,
                     plain=binary_mxu_plain, kernel=gemm_kernel(),
                     grouped=GEMM_GROUPED_MXU)
