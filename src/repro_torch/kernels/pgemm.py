"""Plane-composed MAC bodies — int4/int8 weights as shifted binary planes
(counterpart of `repro.kernels.pgemm`, PLANES_W4_I8A / PLANES_W8_I8A).

The weight is a stacked (P, N, K/32) tensor of MSB-first two's-complement
binary planes (`core.pack.pack_planes`; plane 0 is the sign plane with
coefficient -2^(b-1)), the activations (M, K) int8 codes. The live depth
P <= b is the operand's leading axis: a leading slice `w_planes[:P]` with
unchanged coefficients is the floor-truncated weight the self-speculative
draft runs.

The plain version follows the reference's `_planes_step`: unpack plane i to
{0,1} int8, take its int32 dot with the activations, add coeff_i * dot. The
CUDA bodies (`csrc/gemm.cu`, BODY_PLANES_W4/W8) compose the live plane words
into int8 codes with an in-register bit transpose, then take the dot with
__dp4a up to 8 rows (`planes_stream_kernel`, streaming the plane words) and
on the int8 tensor cores above (`planes_mma_kernel`); all are integer sums,
so they agree bit for bit, and at P = b they equal the direct int4/int8
cells. The activation rows must be 16-byte aligned on the card, as every
contiguous int8 (M, K) tensor with K % 32 == 0 is.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack

from .bgemm import unpacked_dot
from .harness import GEMM_GROUPED_PLANES, MacBody, gemm_kernel


def planes_plain(x_ops, w_ops, k: int, *, bits: int) -> torch.Tensor:
    x, wp = x_ops[0], w_ops[0]                   # (M, K) int8, (P, N, K/32)
    acc = torch.zeros((x.shape[0], wp.shape[1]), dtype=torch.int32, device=x.device)
    for coeff, plane in zip(pack.plane_coeffs(bits), wp):
        dot = unpacked_dot(x, lambda a, b, pl=plane: pack.unpack_bits(pl[a:b], k),
                           wp.shape[1])
        acc += coeff * dot
    return acc


def _mk(bits: int, name: str, body_id: int) -> MacBody:
    return MacBody(name, body_id=body_id, n_x=1, n_w=1, k_per_q=pack.WORD,
                   xk_per_q=1, wk_per_q=pack.WORD, w_stack=bits,
                   plain=lambda x_ops, w_ops, k: planes_plain(x_ops, w_ops, k,
                                                              bits=bits),
                   kernel=gemm_kernel(), grouped=GEMM_GROUPED_PLANES)


PLANES_W4_I8A = _mk(4, "pgemm_w4a8_planes", 7)
PLANES_W8_I8A = _mk(8, "pgemm_w8a8_planes", 8)
