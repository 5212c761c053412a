"""Bit-plane packing — BrainTTA's v_C operands-per-word storage (§IV-B),
counterpart of `repro.core.pack`.

The contraction (K) axis is packed into 32-bit words, bit k of word j
holding the code of operand 32*j + k, so the words are bit-identical to the
JAX package's:

  binary : K/32 words, bit = 1 encodes +1
  ternary: two planes (mask, sign) of K/32 words each
  int4   : K/8 words, nibble j of word i = s4 code 8*i+j (two's complement)
  int8   : native int8 codes (no packing)
  planes : int4/int8 codes as a stack of binary planes (..., bits, N, K/32),
           MSB-first two's complement (the plane-composed cells' weights)

torch has limited uint32 support (no `>>` for uint32 on the CPU), so the
port stores every packed word as **int32 with its bits unchanged**. int32
`>>` is arithmetic, so every shift below is followed by a mask, and the
popcount of the plain versions is a SWAR count in int64. Packing always
happens along the LAST axis; K must be a multiple of 32 (of 8 for int4).
"""
from __future__ import annotations

import torch

WORD = 32  # bits per packed word
NIBBLES = 8  # s4 codes per packed word

#: total bit-planes of each plane-decomposable weight precision (two's
#: complement: plane 0 is the sign plane, coefficient -2^(b-1))
PLANE_BITS = {"int4": 4, "int8": 8}

#: K elements per unit of each packed leaf's storage axis; a leaf absent
#: here is unpacked (one element per storage unit)
K_QUANTUM = {"w_packed": WORD, "w_mask": WORD, "w_sign": WORD,
             "w_q4": NIBBLES, "w_planes": WORD}


def _check_k(k: int) -> None:
    if k % WORD:
        raise ValueError(f"packing axis length {k} not a multiple of {WORD}")


def _to_i32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_bits(codes: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 codes (last axis = K) into int32 words (last axis K/32).

    Bit k of word j holds code[..., j*32+k] (little-endian within the word).
    """
    _check_k(codes.shape[-1])
    c = codes.to(torch.int64).reshape(*codes.shape[:-1], codes.shape[-1] // WORD, WORD)
    shifts = torch.arange(WORD, dtype=torch.int64, device=codes.device)
    return _to_i32_bits((c << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_bits -> uint8 codes with last axis k."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32).unsqueeze(-1) >> shifts) & 1   # mask after >>
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD)[..., :k].to(torch.uint8)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of int32 words (all 32 bits, sign bit included) as
    int32 — a SWAR count in int64, since torch has no popcount op."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


# -- binary ------------------------------------------------------------------

def pack_binary(values: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} float values: bit=1 encodes +1 (values >= 0)."""
    return pack_bits(values >= 0)


def unpack_pm1_i8(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unpack bit-plane words to ±1 int8 along a last axis of length k."""
    return unpack_bits(words, k).to(torch.int8) * 2 - 1


# -- ternary -----------------------------------------------------------------

def pack_ternary(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack {-1,0,+1} floats into (mask_words, sign_words) planes."""
    return pack_bits(values != 0), pack_bits(values < 0)


def unpack_ternary_i8(mask_words: torch.Tensor, sign_words: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Unpack trit planes to {-1,0,+1} int8."""
    mask = unpack_bits(mask_words, k).to(torch.int8)
    sign = unpack_bits(sign_words, k).to(torch.int8)
    return mask * (1 - 2 * sign)


# -- int4 (s4 nibble codes, 8 per word) --------------------------------------

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack s4 codes in [-8, 7] (last axis = K) into int32 words: nibble j
    of word i holds code[..., 8*i+j] in two's complement, little-endian."""
    k = codes.shape[-1]
    if k % NIBBLES:
        raise ValueError(f"int4 packing axis length {k} not a multiple of {NIBBLES}")
    c = (codes.to(torch.int64) & 0xF).reshape(*codes.shape[:-1], k // NIBBLES, NIBBLES)
    shifts = torch.arange(0, 4 * NIBBLES, 4, dtype=torch.int64, device=codes.device)
    return _to_i32_bits((c << shifts).sum(dim=-1))


def unpack_int4_i8(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unpack s4 nibble words to int8 codes along a last axis of length k;
    a nibble >= 8 is negative (nibble - 16)."""
    shifts = torch.arange(0, 4 * NIBBLES, 4, dtype=torch.int32, device=words.device)
    nib = (words.to(torch.int32).unsqueeze(-1) >> shifts) & 0xF   # mask after >>
    nib = nib.reshape(*words.shape[:-1], words.shape[-1] * NIBBLES)[..., :k]
    return torch.where(nib >= 8, nib - 16, nib).to(torch.int8)


# -- bit-plane stacks (int4/int8 as shifted sums of binary planes) -----------
#
# A b-bit two's-complement code c is exactly
#     c = -2^(b-1) * bit_{b-1} + sum_{j<b-1} 2^j * bit_j,
# stored MSB-first along a plane axis inserted before the last two axes:
# (N, K) codes become a (b, N, K/32) stack, (E, N, K) become (E, b, N, K/32).
# A leading slice [:P] keeps its coefficients and composes to the floor
# truncation floor(c / 2^(b-P)) * 2^(b-P): the self-speculative draft.


def plane_coeffs(bits: int) -> tuple[int, ...]:
    """MSB-first per-plane coefficients of the b-bit two's-complement
    decomposition: (-2^(b-1), 2^(b-2), ..., 2, 1)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"plane decomposition supports 2..8 bits, got {bits}")
    return (-(1 << (bits - 1)),) + tuple(1 << (bits - 1 - i) for i in range(1, bits))


def pack_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """b-bit two's-complement codes (integer dtype, last axis = K) -> int32
    plane stack (..., bits, N, K/32), MSB-first. The b-bit field is masked
    before any shift, so int32's arithmetic `>>` never sees a sign bit."""
    plane_coeffs(bits)                               # validates bits
    _check_k(codes.shape[-1])
    if codes.ndim < 2:
        raise ValueError("pack_planes needs at least a (N, K) matrix")
    field = codes.to(torch.int32) & ((1 << bits) - 1)
    return torch.stack([pack_bits((field >> (bits - 1 - i)) & 1)
                        for i in range(bits)], dim=-3)


def unpack_planes_i8(planes: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """Compose a (possibly truncated) plane stack (..., P, N, K/32) back to
    int8 codes (..., N, k): the stored codes at P == bits, their floor
    truncation to the top P planes below that."""
    p_live = planes.shape[-3]
    coeffs = torch.tensor(plane_coeffs(bits)[:p_live], dtype=torch.int32,
                          device=planes.device)
    bitsmat = unpack_bits(planes, k).to(torch.int32)          # (..., P, N, k)
    return (bitsmat * coeffs[:, None, None]).sum(dim=-3).to(torch.int8)


# -- packed dot products (the XNOR/gated-XNOR algebra, §II-A) ----------------

def binary_dot_words(x_words: torch.Tensor, w_words: torch.Tensor, k: int) -> torch.Tensor:
    """Binary dot over packed words (last axis contracted, broadcasting):
    dot = K - 2*popcount(x ^ w)."""
    mismatch = popcount32(torch.bitwise_xor(x_words, w_words)).sum(dim=-1, dtype=torch.int32)
    return k - 2 * mismatch


def ternary_dot_words(xm: torch.Tensor, xs: torch.Tensor, wm: torch.Tensor,
                      ws: torch.Tensor) -> torch.Tensor:
    """Gated-XNOR dot over packed trit planes (last axis contracted):
    dot = popcount(xm & wm) - 2*popcount(xm & wm & (xs ^ ws))."""
    active = torch.bitwise_and(xm, wm)
    disagree = torch.bitwise_and(active, torch.bitwise_xor(xs, ws))

    def pc(v):
        return popcount32(v).sum(dim=-1, dtype=torch.int32)

    return pc(active) - 2 * pc(disagree)
