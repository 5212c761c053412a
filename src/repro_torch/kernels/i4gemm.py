"""int4 (s4 nibble-packed) weights x int8 activations — the W4A8 vMAC path
(counterpart of `repro.kernels.i4gemm`, INT4_W_I8A).

Weights are s4 codes packed 8 per 32-bit word (`core.pack.pack_int4`),
activations int8 codes. On the card (`csrc/gemm.cu`, BODY_INT4_W_I8A) up
to 8 rows run `s4_stream_kernel` (the nibble words streamed through
registers and unpacked a word at a time for `__dp4a`) and more rows
`s4_mma_kernel` (unpacked into an int8 tile for the tensor cores); a grouped
call (K11) runs `s4_mma_kernel` with a grid z over the members, a 16-row
tile up to 16 rows. The plain version unpacks with
`core.pack.unpack_int4_i8` and takes the same integer dot in torch.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .bgemm import unpacked_dot
from .harness import GEMM_GROUPED, MacBody, gemm_kernel


def w4a8_plain(x_ops, w_ops, k: int) -> torch.Tensor:
    w = w_ops[0]
    return unpacked_dot(x_ops[0], lambda a, b: pack.unpack_int4_i8(w[a:b], k),
                        w.shape[0])


INT4_W_I8A = MacBody("i4gemm_w4a8", body_id=6, n_x=1, n_w=1,
                     k_per_q=pack.NIBBLES, xk_per_q=1, wk_per_q=pack.NIBBLES,
                     plain=w4a8_plain, kernel=gemm_kernel(), grouped=GEMM_GROUPED)
