"""Binary XNOR+popcount MAC body — the vBMAC unit (counterpart of
`repro.kernels.bgemm`, BINARY_POPCOUNT).

Operands are bit-packed along K (32 per int32 word). The CUDA body
(`csrc/gemm.cu`, BODY_BINARY) sums `__popc(x ^ w)` mismatches; the dot is
K - 2*mismatches. The plain version is `core.pack.binary_dot_words`.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .harness import MacBody, gemm_kernel

N_CHUNK = 4096   # bounds the plain versions' (M, N_CHUNK, K/32) temporaries


def chunked_over_n(fn, m: int, n: int, device) -> torch.Tensor:
    """(M, N) int32 from fn(n0, n1) -> (M, n1-n0), N_CHUNK columns at a time."""
    if n == 0:
        return torch.zeros((m, 0), dtype=torch.int32, device=device)
    return torch.cat([fn(n0, min(n0 + N_CHUNK, n))
                      for n0 in range(0, n, N_CHUNK)], dim=1)


def binary_popcount_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    x, w = x_ops[0], w_ops[0]
    return chunked_over_n(
        lambda a, b: pack.binary_dot_words(x[:, None, :], w[a:b], k),
        x.shape[0], w.shape[0], x.device)


BINARY_POPCOUNT = MacBody("bgemm_popcount", body_id=1, n_x=1, n_w=1,
                          k_per_q=pack.WORD, plain=binary_popcount_plain,
                          kernel=gemm_kernel())
