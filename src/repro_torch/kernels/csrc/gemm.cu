// Output-stationary packed GEMM with a fused requant epilogue: one template,
// the MAC body a compile-time parameter.
//
// Replaces the TPU kernels `repro/kernels/harness.py` `gemm` + `_kernel`
// (one pallas_call skeleton) with nine of its MacBodies, and `gemm_grouped`
// (the same call vmapped over a leading group axis: K11, and K10 over expert
// stacks for the plane bodies) through a second entry point,
// `repro_gemm_grouped`, over every body below:
//   BODY_I8            `repro/kernels/i8gemm.py` `_i8_step`        (I8_DOT)
//   BODY_BINARY        `repro/kernels/bgemm.py`  `_popcount_step`  (BINARY_POPCOUNT)
//   BODY_TERNARY       `repro/kernels/tgemm.py`  `_popcount_step`  (TERNARY_POPCOUNT)
//   BODY_BINARY_MXU    `repro/kernels/bgemm.py`  `_mxu_step`       (BINARY_MXU)
//   BODY_TERNARY_MXU   `repro/kernels/tgemm.py`  `_mxu_step`       (TERNARY_MXU)
//   BODY_TERNARY_W_I8A `repro/kernels/tgemm.py`  `_wt_i8a_step`    (TERNARY_W_I8A)
//   BODY_INT4_W_I8A    `repro/kernels/i4gemm.py` `_w4a8_step`      (INT4_W_I8A)
//   BODY_PLANES_W4     `repro/kernels/pgemm.py`  `_planes_step`    (PLANES_W4_I8A)
//   BODY_PLANES_W8     `repro/kernels/pgemm.py`  `_planes_step`    (PLANES_W8_I8A)
//
// What it computes, for an (M, N) output:
//   dot[m, n] = finish(sum over K of mac(x[m, k], w[n, k]))   (int32, exact)
//   out       = ((float)dot * w_scale[n]) * a_scale[m] + bias[n]  -> bf16
// or the raw int32 dot when out_acc != 0 (the reference's out="acc").
//
// Storage formats (every packed operand is a run of 32-bit words per row):
//   int8        (R, K) int8 codes, read four to a word (K/4 words per row)
//   K-major     (K, N) int8 weight codes
//   bits        K/32 words, bit k of word j = operand 32j+k (1 encodes +1)
//   trits       two bits planes, mask (non-zero) and sign (negative)
//   s4          K/8 words, nibble j of word i = s4 code 8i+j
//   planes      a stack of P <= BITS binary planes (P, N, K/32), MSB-first
//               two's complement: plane 0 is the sign plane (coefficient
//               -2^(BITS-1)), plane i has coefficient 2^(BITS-1-i); plane i
//               of row n starts at w0 + i * plane_stride + n * K/32
// The two sides of a body may differ (the mixed bodies: int8 codes against
// trit planes or s4 nibbles), so each side is staged by its own density.
//
// MAC kinds. The popcount bodies work on packed words directly: XNOR sums
// __popc(x ^ w) mismatches (dot = K - 2 * mismatches), gated XNOR adds each
// word's active - 2 * disagree (pop_mac); above 8 rows, and grouped at
// every M, the b1 tensor cores take the same dots from AND-popc products
// (pop_mma_kernel). Every other body is an int8 body: each side becomes
// words of four int8 codes of k, multiplied by __dp4a (four MACs) or by the
// int8 tensor cores. int8 rows are copied; K-major int8 weights are
// byte-transposed four columns at a time; bits, trits and nibbles are
// unpacked to ±1, {-1, 0, +1} and sign-extended s4 bytes. The P live plane
// words of a plane stack are composed into the codes sum_i coeff_i * bit_i
// (each fits an int8, truncated or not: a missing plane contributes 0), so
// the plane kernels' dot is integer-identical to the reference's per-plane
// sum sum_i coeff_i * (x . plane_i). The reference's MXU bodies dot the
// unpacked values in f32 and cast; this port takes the integer dot of the
// ±1 / trit codes, which is the same number and equals the popcount bodies'
// dot bit for bit.
//
// Which kernel runs each body:
// - Called ungrouped, every body runs two kernels, chosen by M. Up to
//   SMALL_M = 8 rows (decode and draft rows of 4 slots) a weight-streaming
//   kernel: persistent blocks stage the activations once (as int8 codes, K7
//   unpacking its bits or trits there; K3 and K4 as their packed words) and
//   stream the weights through registers with 16-byte loads, the next
//   item's in flight while this one is multiplied, bound by the weight
//   bytes and the launch floor (each weight byte feeds at most 8 rows).
//   Above 8 rows (verify rows, the prefill buckets) one tensor-core tile on
//   a 3-stage cp.async ring: for the int8 bodies 128 x 64 outputs on
//   mma.sync m16n8k32 s8, with each body's own weight stage into a padded
//   int8 code tile (and for K7 an activation stage too); for the popcount
//   bodies 64 x 64 outputs on mma.sync m16n8k256 b1 (AND-popc), on the
//   packed words as they arrive, both sides 1 or 2 bits a k from HBM to the
//   tensor cores:
//     K1   i8_stream_kernel (K split across blocks, int32 atomics)  i8_mma_kernel
//     K3   bpop_stream_kernel                                        pop_mma_kernel<1>
//     K4   tpop_stream_kernel                                        pop_mma_kernel<2>
//     K7   bmxu_stream_kernel / tmxu_stream_kernel                   bmxu_mma_kernel / tmxu_mma_kernel
//     K8   wt_stream_kernel                                          wt_mma_kernel
//     K9   s4_stream_kernel                                          s4_mma_kernel
//     K10  planes_stream_kernel                                      planes_mma_kernel
//   Each kernel's design is written above it.
// - Grouped (K11, `repro_gemm_grouped`: G GEMMs of one shape in one
//   launch, every operand with a leading G axis: x (G, M, .), w (G, N, .)
//   or (G, K, N), w_scale and bias (G, N), a_scale (G, M), out (G, M, N)),
//   every body runs its tensor-core kernel at every M with blockIdx.z over
//   the groups: the int8, s4, plane, mxu and wt-i8a bodies i8_mma_kernel /
//   s4_mma_kernel / planes_mma_kernel / bmxu_mma_kernel / tmxu_mma_kernel /
//   wt_mma_kernel on a 16-row tile (BN = 128) up to G_SMALL_M = 16 rows and
//   the 128-row one above, the popcount bodies (K3, K4) pop_mma_kernel on
//   its b1 tile, 16 rows (BN = 128) up to G_SMALL_M and 64 above.
//   The MoE expert projections are G = E weight stacks at decode M = slots
//   x capacity (16 for 4 slots): the weight bytes of all experts, and for
//   the bit-plane bodies the weight codes each block unpacks, bound them.
//   A plane stack (G, P, N, K/32) may be the leading-P slice of a (G, BITS,
//   N, K/32) stack (the self-speculative draft's truncation): the kernel
//   takes P, the plane stride and the member stride, so it reads the P live
//   planes of each expert in place and the planes past P never.
//
// Exactness. The epilogue keeps the reference's order exactly and uses
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA, and rounds
// with __float2bfloat16_rn, so the bf16 output is bit-equal to
// `harness.requant` on the same int32 dot and scales.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace {

enum { BODY_I8 = 0, BODY_BINARY = 1, BODY_TERNARY = 2, BODY_BINARY_MXU = 3,
       BODY_TERNARY_MXU = 4, BODY_TERNARY_W_I8A = 5, BODY_INT4_W_I8A = 6,
       BODY_PLANES_W4 = 7, BODY_PLANES_W8 = 8 };

// One packed word of each plane of x and w: binary adds the mismatches
// __popc(x ^ w) (dot = K - 2 * sum, pop_finish), ternary the gated XNOR's
// active - 2 * disagree of this word directly (dot = sum). Zero words (past
// K) add nothing to either.
template <int NP>
__device__ __forceinline__ int pop_mac(int acc, uint32_t x0, uint32_t x1, uint32_t w0,
                                       uint32_t w1) {
  if constexpr (NP == 1) {
    return acc + __popc(x0 ^ w0);
  } else {
    const uint32_t active = x0 & w0;
    return acc + __popc(active) - 2 * __popc(active & (x1 ^ w1));
  }
}
template <int NP>
__device__ __forceinline__ int pop_finish(int acc, int K) {
  return NP == 1 ? K - 2 * acc : acc;
}

// The fused epilogue for output (m, n) at out[idx]: the raw int32 dot, or
// ((float)dot * w_scale[n]) * a_scale[m] + bias[n] rounded to bf16, in the
// reference's order with no FMA contraction.
__device__ __forceinline__ void store_out(void* out, int out_acc, size_t idx,
                                          int dot, const float* w_scale,
                                          const float* a_scale,
                                          const float* bias, int m, int n) {
  if (out_acc) {
    static_cast<int*>(out)[idx] = dot;
    return;
  }
  float y = __int2float_rn(dot);
  if (w_scale) y = __fmul_rn(y, w_scale[n]);
  if (a_scale) y = __fmul_rn(y, a_scale[m]);
  if (bias) y = __fadd_rn(y, bias[n]);
  static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
}

// ---------------------------------------------------------------------------
// Shared by the K1, K7, K9 and K10 kernels below
// ---------------------------------------------------------------------------

// A 4 x 4 byte transpose: byte i of o[L] is byte L of in[i].
__device__ __forceinline__ void transpose4x4(uint32_t i0, uint32_t i1, uint32_t i2,
                                             uint32_t i3, uint32_t* o) {
  const uint32_t a0 = __byte_perm(i0, i1, 0x5140);
  const uint32_t a1 = __byte_perm(i0, i1, 0x7362);
  const uint32_t a2 = __byte_perm(i2, i3, 0x5140);
  const uint32_t a3 = __byte_perm(i2, i3, 0x7362);
  o[0] = __byte_perm(a0, a2, 0x5410);
  o[1] = __byte_perm(a0, a2, 0x7632);
  o[2] = __byte_perm(a1, a3, 0x5410);
  o[3] = __byte_perm(a1, a3, 0x7632);
}

// Eight s4 codes (one F_S4 word, nibble j = code j) -> two words of four
// sign-extended int8 codes in k order: lo holds codes 0..3, hi codes 4..7.
// Whole-word masks pick the even and odd nibbles, two byte permutes put
// them in order, and the sign bit (bit 3 of each byte) times 0x1E sets bits
// 4..7 of each negative byte (0x08 * 0x1E = 0xF0: no carry between bytes).
__device__ __forceinline__ void s4_to_codes(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t e = v & 0x0F0F0F0Fu, o = (v >> 4) & 0x0F0F0F0Fu;
  lo = __byte_perm(e, o, 0x5140);
  hi = __byte_perm(e, o, 0x7362);
  lo |= (lo & 0x08080808u) * 0x1Eu;
  hi |= (hi & 0x08080808u) * 0x1Eu;
}

// rows up to which the streaming kernels run: measured on the card (K10),
// the tensor-core kernel is faster from 13 rows on at every llama3.2-3b shape
constexpr int SMALL_M = 8;

constexpr int S_THREADS = 128;
constexpr int S_KL = 8;               // K10/K9: lanes of a column, splitting K
constexpr int S_COLS = S_THREADS / S_KL;   // K10/K9: columns per tile, 4 per warp
constexpr int S_XMAX = 64 * 1024;     // staged activations: M x K bytes at most

// Four words (one 16-byte piece) of a row of `kw` words; zero when !ok.
// `vec`: the rows are 16-byte aligned.
__device__ __forceinline__ uint4 load_quad(const uint32_t* row, int q, int kw,
                                           bool ok, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    if (vec) {
      v = __ldg(reinterpret_cast<const uint4*>(row) + q);
    } else {
      const int w = 4 * q;
      v.x = __ldg(row + w);
      if (w + 1 < kw) v.y = __ldg(row + w + 1);
      if (w + 2 < kw) v.z = __ldg(row + w + 2);
      if (w + 3 < kw) v.w = __ldg(row + w + 3);
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The streaming kernels' persistent grid: as many blocks as fit on the card
// at once (for this kernel at `smem` dynamic bytes), none more than `work`.
// Worked out at first use per (kernel, smem / 128), not per launch: a decode
// tick launches these ~100 times, and each runtime query costs host time
// that the tick waits for. One card per process (the serve path's).
template <typename F>
int resident_blocks(F* kernel, int smem, std::atomic<int>* fit, int* blocks) {
  int b = fit[smem / 128].load(std::memory_order_relaxed);
  if (b == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    b = max(1, per_sm) * sms;
    fit[smem / 128].store(b, std::memory_order_relaxed);
  }
  *blocks = b;
  return 0;
}

// ---------------------------------------------------------------------------
// K10: the plane bodies
// ---------------------------------------------------------------------------

// One 32-k word of each live plane (pw[i]: plane i, MSB-first; bit k of the
// word belongs to the k-th weight) -> the 32 int8 codes sum_i coeff_i *
// bit_i, as eight words in k-interleaved order: byte L of w[r] is the code
// of k = 8L + r. Plane i lands on bit BITS-1-i of the code byte, and the
// sign plane's bit BITS-1 is sign-extended (a no-op at 8 bits, where bit 7
// of an int8 already weighs -128). Planes at or past NP are zero words and
// add nothing, which is the truncated stack.
//
// Per byte lane of the eight words w[r] (row r = plane BITS-1-r, or zero)
// the 8x8 bit matrix is transposed by three block swaps (4-, 2- and 1-bit
// fields).
template <int BITS, int NP>
__device__ __forceinline__ void planes_to_codes(const uint32_t* pw, uint32_t* w) {
  static_assert(BITS == 4 || BITS == 8, "4- or 8-bit plane stacks");
  static_assert(NP >= 1 && NP <= BITS, "1 <= live planes <= BITS");
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = BITS - 1 - r;
    w[r] = (i >= 0 && i < NP) ? pw[i] : 0u;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t t = ((w[r] >> 4) ^ w[r + 4]) & 0x0F0F0F0Fu;
    w[r + 4] ^= t;
    w[r] ^= t << 4;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (i & 1) + 4 * (i >> 1);             // 0, 1, 4, 5
    const uint32_t t = ((w[r] >> 2) ^ w[r + 2]) & 0x33333333u;
    w[r + 2] ^= t;
    w[r] ^= t << 2;
  }
#pragma unroll
  for (int r = 0; r < 8; r += 2) {
    const uint32_t t = ((w[r] >> 1) ^ w[r + 1]) & 0x55555555u;
    w[r + 1] ^= t;
    w[r] ^= t << 1;
  }
  if constexpr (BITS == 4) {
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] |= (w[r] & 0x08080808u) * 0x1Fu;
  }
}

// The k-interleaved order of planes_to_codes <-> k order (words of four
// consecutive k, little-endian, like an int8 activation row read as words):
// a 4x4 byte transpose of words {0..3} and of {4..7}, in either direction.
// to_k: out[j] holds k = 4j .. 4j+3 of the interleaved in[]; otherwise
// out[] is the interleaved form of the k-ordered in[].
template <bool TO_K>
__device__ __forceinline__ void interleave32(const uint32_t* in, uint32_t* out) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t t[4];
    if constexpr (TO_K) {
      transpose4x4(in[4 * h], in[4 * h + 1], in[4 * h + 2], in[4 * h + 3], t);
#pragma unroll
      for (int l = 0; l < 4; ++l) out[2 * l + h] = t[l];
    } else {
      transpose4x4(in[h], in[2 + h], in[4 + h], in[6 + h], t);
#pragma unroll
      for (int l = 0; l < 4; ++l) out[4 * h + l] = t[l];
    }
  }
}

// planes_to_codes in k order: out[j] holds the codes of k = 4j .. 4j+3.
template <int BITS, int NP>
__device__ __forceinline__ void compose_word(const uint32_t* pw, uint32_t* out) {
  uint32_t w[8];
  planes_to_codes<BITS, NP>(pw, w);
  interleave32<true>(w, out);
}

// ±1 or trit int8 codes of one 32-k word of bits (NP = 1; bit = 1 encodes
// +1) or of a (mask, sign) pair of words (NP = 2), as eight words in
// planes_to_codes' k-interleaved order: byte L of cw[r] is the code of k =
// 8L + r, so bit r of each byte is picked by one whole-word shift and mask,
// with no per-bit branch and no transpose. With b those bits as 0/1
// bytes, ±1 = 0xFFFFFFFF - b * 0xFE (0xFF = -1 where b = 0, 0x01 where b =
// 1: no borrow between bytes) and a trit = m + (m & s) * 0xFE (0, 0x01, or
// 0xFF = -1: no carry), the integer form of mask - 2 (mask & sign).
template <int NP>
__device__ __forceinline__ void mxu_codes(const uint32_t* pw, uint32_t* cw) {
  static_assert(NP == 1 || NP == 2, "bits or (mask, sign) trits");
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t b = (pw[0] >> r) & 0x01010101u;
    if constexpr (NP == 1) cw[r] = 0xFFFFFFFFu - b * 0xFEu;
    else cw[r] = b + ((pw[1] >> r) & b) * 0xFEu;
  }
}

// -- small M: stream the bit-plane words (K10, K7) ---------------------------

// The two sides of a streaming kernel (stream_gemm's D). PLANES: the bit
// planes (N, K/32) a weight column loads, plane p at w + p * pstride words;
// weights(pw, cw): one 32-k word of each plane -> 8 code words in
// planes_to_codes' k-interleaved order; acts(x, xpstride, m, bk, K, t): the
// 32 k of activation row m at 32-k word bk, staged in the same order, zero
// past K (so that padded weight codes add nothing).
//   PlaneSide  K10: a BITS-plane stack with NP live planes x int8 rows (M,
//              K), 16-byte aligned
//   MxuSide    K7: bits (NP = 1) or (mask, sign) trits (NP = 2) on both
//              sides; activations (M, K/32) words a plane, the sign plane at
//              x + xpstride words
template <int BITS, int NP> struct PlaneSide {
  static constexpr int PLANES = NP;
  static constexpr bool PACKED = false;
  __device__ static void weights(const uint32_t* pw, uint32_t* cw) {
    planes_to_codes<BITS, NP>(pw, cw);
  }
  __device__ static void acts(const void* x, long long, int m, int bk, int K,
                              uint32_t* t) {
    uint32_t v[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (bk * 32 < K) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint8_t*>(x) + (size_t)m * K + bk * 32);
      const uint4 a = src[0], b = src[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    interleave32<false>(v, t);
  }
};

template <int NP> struct MxuSide {
  static constexpr int PLANES = NP;
  static constexpr bool PACKED = false;
  __device__ static void weights(const uint32_t* pw, uint32_t* cw) {
    mxu_codes<NP>(pw, cw);
  }
  __device__ static void acts(const void* x, long long xpstride, int m, int bk, int K,
                              uint32_t* t) {
    const int kw = K / 32;
    if (bk >= kw) {
#pragma unroll
      for (int r = 0; r < 8; ++r) t[r] = 0u;
      return;
    }
    const uint32_t* xw = static_cast<const uint32_t*>(x) + (size_t)m * kw + bk;
    uint32_t pw[NP];
    pw[0] = __ldg(xw);
    if constexpr (NP == 2) pw[1] = __ldg(xw + xpstride);
    mxu_codes<NP>(pw, t);
  }
};

// K8: MxuSide's (mask, sign) trit weights x PlaneSide's int8 rows
struct WtSide {
  static constexpr int PLANES = 2;
  static constexpr bool PACKED = false;
  __device__ static void weights(const uint32_t* pw, uint32_t* cw) { mxu_codes<2>(pw, cw); }
  __device__ static void acts(const void* x, long long xpstride, int m, int bk, int K,
                              uint32_t* t) {
    PlaneSide<8, 1>::acts(x, xpstride, m, bk, K, t);
  }
};

// K3 / K4: bits (NP = 1) or (mask, sign) trits (NP = 2) on both sides, kept
// packed from HBM to the ALU: no codes. The activations are staged as their
// words and each weight word meets M staged words in one popcount MAC
// (pop_mac); `weights` and `acts` are not used.
template <int NP> struct PopSide {
  static constexpr int PLANES = NP;
  static constexpr bool PACKED = true;
};

// M <= MS rows (MS = 4 or 8) against D::PLANES weight planes.
// Persistent blocks walk 16-column tiles blockIdx.x, + gridDim.x, ...; lane
// 4 kl + c of a warp (column c of its 4, k-lane kl) takes the k-quads kl,
// kl + 8, ... of column c, U of them (x PLANES planes of 16-byte loads) per
// item, so that a quarter-warp reads the activations of two k-quads, each
// broadcast to 4 lanes. The walk is
// a stream of items (tile, batch of U quads), and the next item's loads are
// issued before this item's codes are composed and multiplied, so one item
// of loads is always in flight; the first item's loads also overlap the
// staging of the activations, which happens once per block (M x K int8
// codes in dynamic shared memory, each 32 k in planes_to_codes' k-interleaved
// order, so that a lane multiplies its weight codes without putting them
// back in k order; each 128-byte k-quad's eight 16-byte pieces rotated by
// the quad index so that different k-lanes read distinct banks). A PACKED
// side (K3, K4) stages its activation words as they are, one 16-byte piece
// per k-quad and plane (M x K/8 bytes a plane: 8 KiB at 8 rows and K =
// 8192), and multiplies each weight word with pop_mac: no codes on either
// side.
template <class D, int MS>
__device__ __forceinline__ void stream_gemm(const void* __restrict__ x, long long xpstride,
                                            const uint32_t* __restrict__ w,
                                            long long pstride,
                                            const float* __restrict__ w_scale,
                                            const float* __restrict__ a_scale,
                                            const float* __restrict__ bias,
                                            void* __restrict__ out, int out_acc, int M,
                                            int N, int K, int vec) {
  constexpr int NP = D::PLANES;
  constexpr int U = NP >= 4 ? 1 : 4 / NP;       // quads per item: 4-8 loads
  extern __shared__ uint4 xs[];                 // [M][nq * 8] pieces

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kl = lane / (32 / S_KL), col = warp * (32 / S_KL) + lane % (32 / S_KL);
  const int kw = K / 32, nq = (kw + 3) / 4;
  const int nb = ((nq + S_KL - 1) / S_KL + U - 1) / U;   // items per tile
  const int tiles = (N + S_COLS - 1) / S_COLS;
  const int my_tiles = tiles > (int)blockIdx.x
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int items = my_tiles * nb;

  // item it: tile blockIdx.x + (it / nb) * gridDim.x, quads kl + 8 (U b + u)
  auto column = [&](int it) {
    return ((int)blockIdx.x + (it / nb) * (int)gridDim.x) * S_COLS + col;
  };
  auto load_item = [&](int it, uint4 (&buf)[U][NP]) {
    const int n = column(it), q0 = kl + S_KL * U * (it % nb);
    const uint32_t* wn = w + (size_t)(n < N ? n : 0) * kw;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + S_KL * u;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        buf[u][p] = load_quad(wn + p * pstride, q, kw, n < N && q < nq, vec);
    }
  };
  int acc[MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) acc[m] = 0;
  auto run_item = [&](int it, const uint4 (&buf)[U][NP]) {
    const int q0 = kl + S_KL * U * (it % nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + S_KL * u;
      if (q >= nq) break;
      if constexpr (D::PACKED) {
        const uint4* xq = xs + q * NP;
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          if (m < M) {                          // warp-uniform
            const uint4 x0 = xq[m * nq * NP];
            const uint4 x1 = NP == 2 ? xq[m * nq * NP + 1] : x0;
            const uint4 w1 = buf[u][NP - 1];
            int a = acc[m];
            a = pop_mac<NP>(a, x0.x, x1.x, buf[u][0].x, w1.x);
            a = pop_mac<NP>(a, x0.y, x1.y, buf[u][0].y, w1.y);
            a = pop_mac<NP>(a, x0.z, x1.z, buf[u][0].z, w1.z);
            a = pop_mac<NP>(a, x0.w, x1.w, buf[u][0].w, w1.w);
            acc[m] = a;
          }
        }
      } else {
        const uint4* xq = xs + q * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {             // plane word e: k 32e..32e+31
          uint32_t pw[NP], cw[8];                 // codes, k-interleaved like xs
#pragma unroll
          for (int p = 0; p < NP; ++p) pw[p] = lane_of(buf[u][p], e);
          D::weights(pw, cw);
#pragma unroll
          for (int m = 0; m < MS; ++m) {
            if (m < M) {                          // warp-uniform
              const uint4 xa = xq[m * nq * 8 + ((2 * e + q) & 7)];
              const uint4 xb = xq[m * nq * 8 + ((2 * e + 1 + q) & 7)];
              int a = acc[m];
              a = __dp4a(static_cast<int>(xa.x), static_cast<int>(cw[0]), a);
              a = __dp4a(static_cast<int>(xa.y), static_cast<int>(cw[1]), a);
              a = __dp4a(static_cast<int>(xa.z), static_cast<int>(cw[2]), a);
              a = __dp4a(static_cast<int>(xa.w), static_cast<int>(cw[3]), a);
              a = __dp4a(static_cast<int>(xb.x), static_cast<int>(cw[4]), a);
              a = __dp4a(static_cast<int>(xb.y), static_cast<int>(cw[5]), a);
              a = __dp4a(static_cast<int>(xb.z), static_cast<int>(cw[6]), a);
              a = __dp4a(static_cast<int>(xb.w), static_cast<int>(cw[7]), a);
              acc[m] = a;
            }
          }
        }
      }
    }
    if (it % nb != nb - 1) return;
    // the tile's last item: the 8 k-lanes of a column add their partial
    // sums (exact in any order), and k-lane m stores row m
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      int a = acc[m];
#pragma unroll
      for (int o = 32 / S_KL; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[m] = 0;
      const int n = column(it);
      if constexpr (D::PACKED) a = pop_finish<NP>(a, K);
      if (n < N && m < M && m == kl)
        store_out(out, out_acc, (size_t)m * N + n, a, w_scale, a_scale, bias, m, n);
    }
  };

  uint4 ba[U][NP], bb[U][NP];
  if (items > 0) load_item(0, ba);
  if constexpr (D::PACKED) {
    // a k-quad's 4 words of each plane as one piece, [M][nq][NP], zero past K
    const auto* xw = static_cast<const uint32_t*>(x);
    for (int i = tid; i < M * nq * NP; i += S_THREADS) {
      const int m = i / (nq * NP), q = i / NP % nq, p = i % NP;
      const uint32_t* row = xw + p * xpstride + (size_t)m * kw;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 4 * q + e < kw ? __ldg(row + 4 * q + e) : 0u;
      xs[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    // 32 k at a time, in planes_to_codes' k-interleaved order, as two pieces
    for (int i = tid; i < M * nq * 4; i += S_THREADS) {
      const int m = i / (nq * 4), bk = i % (nq * 4), kq = bk >> 2, e = bk & 3;
      uint32_t t[8];
      D::acts(x, xpstride, m, bk, K, t);
      uint4* row = xs + m * nq * 8 + kq * 8;
      row[(2 * e + kq) & 7] = make_uint4(t[0], t[1], t[2], t[3]);
      row[(2 * e + 1 + kq) & 7] = make_uint4(t[4], t[5], t[6], t[7]);
    }
  }
  __syncthreads();
  // two register buffers, unrolled by hand so neither is indexed at run time
  for (int it = 0; it < items; it += 2) {
    if (it + 1 < items) load_item(it + 1, bb);
    run_item(it, ba);
    if (it + 1 >= items) break;
    if (it + 2 < items) load_item(it + 2, ba);
    run_item(it + 1, bb);
  }
}

// K10: NP live planes of a BITS-plane stack x int8 rows
template <int BITS, int NP, int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
planes_stream_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ w,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ a_scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int out_acc, int M, int N, int K, long long pstride, int vec) {
  stream_gemm<PlaneSide<BITS, NP>, MS>(x, 0, w, pstride, w_scale, a_scale, bias, out,
                                       out_acc, M, N, K, vec);
}

// K7: ±1 bits on both sides (bmxu) or trits on both sides (tmxu); the
// weight stream is 1 or 2 bits a MAC column, so at decode the launch floor
// and the unpack (3 or 5 integer ops per four codes, then M __dp4a) bound
// them rather than the weight bytes
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
bmxu_stream_kernel(const uint32_t* __restrict__ x, long long xpstride,
                   const uint32_t* __restrict__ w, long long pstride,
                   const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                   const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                   int M, int N, int K, int vec) {
  stream_gemm<MxuSide<1>, MS>(x, xpstride, w, pstride, w_scale, a_scale, bias, out,
                              out_acc, M, N, K, vec);
}
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
tmxu_stream_kernel(const uint32_t* __restrict__ x, long long xpstride,
                   const uint32_t* __restrict__ w, long long pstride,
                   const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                   const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                   int M, int N, int K, int vec) {
  stream_gemm<MxuSide<2>, MS>(x, xpstride, w, pstride, w_scale, a_scale, bias, out,
                              out_acc, M, N, K, vec);
}

// K3 / K4: bits (bpop) or (mask, sign) trits (tpop) on both sides, packed:
// per 32 k and row one XOR and one POPC (binary) or two ANDs, an XOR and
// two POPCs (ternary) on words straight from HBM, so at decode the 1- or
// 2-bit weight bytes, the POPC rate (16 a clock an SM) and the launch floor
// are of one order, the floor the largest
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
bpop_stream_kernel(const uint32_t* __restrict__ x, long long xpstride,
                   const uint32_t* __restrict__ w, long long pstride,
                   const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                   const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                   int M, int N, int K, int vec) {
  stream_gemm<PopSide<1>, MS>(x, xpstride, w, pstride, w_scale, a_scale, bias, out,
                              out_acc, M, N, K, vec);
}
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
tpop_stream_kernel(const uint32_t* __restrict__ x, long long xpstride,
                   const uint32_t* __restrict__ w, long long pstride,
                   const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                   const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                   int M, int N, int K, int vec) {
  stream_gemm<PopSide<2>, MS>(x, xpstride, w, pstride, w_scale, a_scale, bias, out,
                              out_acc, M, N, K, vec);
}

// K8: trit weights x int8 rows (M, K), 16-byte aligned (xpstride unused);
// K7's ternary weight stream against K10's staged activations, so only
// the weights are unpacked (5 integer ops per four codes)
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
wt_stream_kernel(const uint32_t* __restrict__ x, long long xpstride,
                 const uint32_t* __restrict__ w, long long pstride,
                 const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                 const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                 int M, int N, int K, int vec) {
  stream_gemm<WtSide, MS>(x, xpstride, w, pstride, w_scale, a_scale, bias, out, out_acc,
                          M, N, K, vec);
}

// ---------------------------------------------------------------------------
// K9: s4 nibble weights, small M
// ---------------------------------------------------------------------------

// M <= MS rows of int8 activations x (N, K/8) s4 words: planes_stream_kernel's
// walk with one 4-bit "plane". Lane 4 kl + c takes the 16-byte pieces (32 k)
// kl, kl + 8, ... of column c, four per item (64 bytes in flight a lane).
// Each word of eight nibbles is unpacked with two whole-word masks and no
// sign extension: the lanes multiply u = nibble ^ 8 = code + 8 (0..15), and
// the epilogue subtracts 8 * sum_k x[m, k], which the staging adds up once
// per block; the integer sum is exact in any order, so the dot is the
// reference's. The even and odd nibbles (v & 0x0F0F0F0F, (v >> 4) & ...)
// are matched by activations staged as words of the even and the odd k of
// each 8, so the codes need no byte permutes. 16-byte pieces of 32 k per
// row (8 words: even, odd, even, odd, ...); the 8 k-lanes of a column read
// 8 consecutive pieces, so a quarter-warp's two addresses hit distinct banks.
template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
s4_stream_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                 const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                 int M, int N, int K, int vec) {
  constexpr int U = 4;                          // pieces per item
  extern __shared__ uint4 xs[];                 // [M][np][2]
  __shared__ int xsum[MS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kl = lane / (32 / S_KL), col = warp * (32 / S_KL) + lane % (32 / S_KL);
  const int kw = K / 8, np = (kw + 3) / 4;      // words, 32-k pieces per row
  const int nb = ((np + S_KL - 1) / S_KL + U - 1) / U;   // items per tile
  const int tiles = (N + S_COLS - 1) / S_COLS;
  const int my_tiles = tiles > (int)blockIdx.x
                           ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int items = my_tiles * nb;

  auto column = [&](int it) {
    return ((int)blockIdx.x + (it / nb) * (int)gridDim.x) * S_COLS + col;
  };
  auto load_item = [&](int it, uint4 (&buf)[U]) {
    const int n = column(it), p0 = kl + S_KL * U * (it % nb);
    const uint32_t* wn = w + (size_t)(n < N ? n : 0) * kw;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + S_KL * u;
      buf[u] = load_quad(wn, p, kw, n < N && p < np, vec);
    }
  };
  int acc[MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) acc[m] = 0;
  auto run_item = [&](int it, const uint4 (&buf)[U]) {
    const int p0 = kl + S_KL * U * (it % nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + S_KL * u;
      if (p >= np) break;
      uint32_t ev[4], od[4];                    // u of the even / odd k of word e
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t t = lane_of(buf[u], e) ^ 0x88888888u;
        ev[e] = t & 0x0F0F0F0Fu;
        od[e] = (t >> 4) & 0x0F0F0F0Fu;
      }
      const uint4* xp = xs + 2 * p;
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        if (m < M) {                            // warp-uniform
          const uint4 xa = xp[2 * m * np], xb = xp[2 * m * np + 1];
          int a = acc[m];
          a = __dp4a(static_cast<int>(xa.x), static_cast<int>(ev[0]), a);
          a = __dp4a(static_cast<int>(xa.y), static_cast<int>(od[0]), a);
          a = __dp4a(static_cast<int>(xa.z), static_cast<int>(ev[1]), a);
          a = __dp4a(static_cast<int>(xa.w), static_cast<int>(od[1]), a);
          a = __dp4a(static_cast<int>(xb.x), static_cast<int>(ev[2]), a);
          a = __dp4a(static_cast<int>(xb.y), static_cast<int>(od[2]), a);
          a = __dp4a(static_cast<int>(xb.z), static_cast<int>(ev[3]), a);
          a = __dp4a(static_cast<int>(xb.w), static_cast<int>(od[3]), a);
          acc[m] = a;
        }
      }
    }
    if (it % nb != nb - 1) return;
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      int a = acc[m];
#pragma unroll
      for (int o = 32 / S_KL; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[m] = 0;
      const int n = column(it);
      if (n < N && m < M && m == kl)
        store_out(out, out_acc, (size_t)m * N + n, a - 8 * xsum[m], w_scale, a_scale,
                  bias, m, n);
    }
  };

  uint4 ba[U], bb[U];
  if (items > 0) load_item(0, ba);
  if (tid < MS) xsum[tid] = 0;
  __syncthreads();
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  for (int i = tid; i < M * np; i += S_THREADS) {
    const int m = i / np, p = i % np;
    uint32_t v[8], t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)               // K % 8 == 0: whole words
      v[j] = 32 * p + 4 * j < K ? __ldg(xw + ((size_t)m * K + 32 * p + 4 * j) / 4) : 0u;
    int s = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t[2 * e] = __byte_perm(v[2 * e], v[2 * e + 1], 0x6420);       // even k
      t[2 * e + 1] = __byte_perm(v[2 * e], v[2 * e + 1], 0x7531);   // odd k
      s = __dp4a(static_cast<int>(v[2 * e]), 0x01010101, s);
      s = __dp4a(static_cast<int>(v[2 * e + 1]), 0x01010101, s);
    }
    xs[2 * i] = make_uint4(t[0], t[1], t[2], t[3]);
    xs[2 * i + 1] = make_uint4(t[4], t[5], t[6], t[7]);
    atomicAdd(&xsum[m], s);
  }
  __syncthreads();
  for (int it = 0; it < items; it += 2) {
    if (it + 1 < items) load_item(it + 1, bb);
    run_item(it, ba);
    if (it + 1 >= items) break;
    if (it + 2 < items) load_item(it + 2, ba);
    run_item(it + 1, bb);
  }
}

// ---------------------------------------------------------------------------
// K1: K-major int8 weights, small M
// ---------------------------------------------------------------------------

// The K-major (K, N) layout puts 16 columns of one k in a 16-byte load, so
// a lane owns COLS columns and loads them at 4 consecutive k (one k-quad),
// and a 4 x 4 byte transpose per word turns the 4 loads into one __dp4a
// word per column. A block of 128 threads owns a 32-column tile: CL column
// lanes x KL k-lanes that stride over the tile's k-quads. At llama3.2-3b's
// N = 3072 (96 tiles) that fills too few SMs, so K is also split across
// blocks: a unit is (tile, split), `splits` chosen by the launcher so that
// the units fill the card in as few rounds as it can, and persistent blocks
// walk the units with the next item's loads in flight, as in the kernels
// above. At a unit's end the KW k-lanes of a warp reduce-scatter their
// accumulators (each halving sends half of the live values to the partner
// lane and keeps the other half: log2 KW shuffle steps leave VR outputs a
// lane), the four warps add theirs in shared memory, and then either the
// block stores the tile (one split) or adds it with atomicAdd into an int32
// workspace; the block that brings the tile's counter to `splits` reads the
// sums back with atomicExch(0), stores them and zeroes the counter, so the
// workspace is zero again for the next launch. Integer sums are exact in
// any order, so every split gives the reference's dot.
template <int MS> struct I8S {
  static constexpr int CW = MS <= 4 ? 4 : 2;  // words a lane loads per k: 16 | 8 columns
  static constexpr int COLS = 4 * CW;         // columns per lane
  static constexpr int TN = 32;               // columns per tile
  static constexpr int CL = TN / COLS;        // column lanes: 2 | 4
  static constexpr int KW = 32 / CL;          // k-lanes per warp: 16 | 8
  static constexpr int KL = S_THREADS / CL;   // k-lanes per block: 64 | 32
  static constexpr int V = MS * COLS;         // accumulators per lane: 64
  static constexpr int VR = V / KW;           // outputs per lane after the reduce: 4 | 8
  static_assert((KW & (KW - 1)) == 0 && COLS % VR == 0 && VR % 4 == 0,
                "reduce-scatter layout");
};

// The warp's reduce-scatter over lane bits O, O/2, .., CL: at each step the
// lane with the bit set keeps the upper H values and sends the lower H, its
// partner the reverse. Adds the kept block's flat offset to f0.
template <int O, int H, int CL>
__device__ __forceinline__ void reduce_scatter(int* acc, int lane, int& f0) {
  if constexpr (O >= CL) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int send = up ? acc[i] : acc[i + H];
      const int keep = up ? acc[i + H] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    f0 += up ? H : 0;
    reduce_scatter<O / 2, H / 2, CL>(acc, lane, f0);
  }
}

// CW words (4 columns each) of one weight row at p; words at or past N zero.
template <int CW>
__device__ __forceinline__ void load_cols(const uint8_t* p, bool ok, int left, int vec,
                                          uint32_t* v) {
#pragma unroll
  for (int e = 0; e < CW; ++e) v[e] = 0u;
  if (!ok) return;
  if (vec) {
    if constexpr (CW == 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = t.x; v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < CW; ++e)
      if (4 * e < left) v[e] = __ldg(reinterpret_cast<const uint32_t*>(p) + e);
  }
}

template <int MS>
__global__ void __launch_bounds__(S_THREADS, 4)
i8_stream_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                 const float* __restrict__ bias, void* __restrict__ out, int out_acc,
                 int M, int N, int K, int splits, int span, int* __restrict__ ws,
                 int xvec, int vec) {
  using P = I8S<MS>;
  extern __shared__ __align__(16) uint32_t xw[];   // [M][K/4] words, then red
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = lane % P::CL, kl = warp * P::KW + lane / P::CL;
  const int nq = K / 4, tiles = (N + P::TN - 1) / P::TN, units = tiles * splits;
  const int my_units = units > (int)blockIdx.x
                           ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int items = my_units * span;
  int* red = reinterpret_cast<int*>(xw + ((M * nq + 3) & ~3));   // [4][MS][TN]

  // item it: unit blockIdx.x + (it / span) * gridDim.x = (tile, split);
  // k-lane kl takes quad split * span * KL + (it % span) * KL + kl
  auto unit = [&](int it) { return (int)blockIdx.x + (it / span) * (int)gridDim.x; };
  auto quad = [&](int it) {
    return (unit(it) / tiles * span + it % span) * P::KL + kl;
  };
  auto load_item = [&](int it, uint32_t (&buf)[4][P::CW]) {
    const int q = quad(it), n = unit(it) % tiles * P::TN + cl * P::COLS;
    const bool ok = q < nq && n < N;
    const uint8_t* p = w + (ok ? (size_t)4 * q * N + n : 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) load_cols<P::CW>(p + r * (size_t)N, ok, N - n, vec, buf[r]);
  };
  int acc[P::V];
#pragma unroll
  for (int i = 0; i < P::V; ++i) acc[i] = 0;

  auto finish = [&](int it) {
    int f0 = 0;
    reduce_scatter<16, P::V / 2, P::CL>(acc, lane, f0);
    {
      int* r = red + (warp * MS + f0 / P::COLS) * P::TN + cl * P::COLS + f0 % P::COLS;
#pragma unroll
      for (int i = 0; i < P::VR; i += 4)
        *reinterpret_cast<int4*>(r + i) = make_int4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
#pragma unroll
    for (int i = 0; i < P::V; ++i) acc[i] = 0;
    __syncthreads();
    const int t = unit(it) % tiles;
    int* part = ws + t * MS * P::TN;
    for (int o = tid; o < MS * P::TN; o += S_THREADS) {
      const int m = o / P::TN, n = t * P::TN + o % P::TN;
      int s = 0;
#pragma unroll
      for (int v = 0; v < S_THREADS / 32; ++v) s += red[v * MS * P::TN + o];
      if (m < M && n < N) {
        if (splits == 1)
          store_out(out, out_acc, (size_t)m * N + n, s, w_scale, a_scale, bias, m, n);
        else
          atomicAdd(part + o, s);
      }
    }
    if (splits > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(ws + tiles * MS * P::TN + t, 1) == splits - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        for (int o = tid; o < MS * P::TN; o += S_THREADS) {
          const int m = o / P::TN, n = t * P::TN + o % P::TN;
          if (m < M && n < N)
            store_out(out, out_acc, (size_t)m * N + n, atomicExch(part + o, 0), w_scale,
                      a_scale, bias, m, n);
        }
        if (tid == 0) atomicExch(ws + tiles * MS * P::TN + t, 0);
      }
    }
    __syncthreads();                    // red and `last` serve the next unit
  };
  auto run_item = [&](int it, const uint32_t (&buf)[4][P::CW]) {
    const int q = quad(it);
    if (q < nq) {
      uint32_t xv[MS];
#pragma unroll
      for (int m = 0; m < MS; ++m) xv[m] = m < M ? xw[m * nq + q] : 0u;
#pragma unroll
      for (int e = 0; e < P::CW; ++e) {
        uint32_t c[4];                  // columns 4e .. 4e+3, k = 4q .. 4q+3
        transpose4x4(buf[0][e], buf[1][e], buf[2][e], buf[3][e], c);
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          if (m < M) {                  // warp-uniform
#pragma unroll
            for (int l = 0; l < 4; ++l)
              acc[m * P::COLS + 4 * e + l] = __dp4a(static_cast<int>(xv[m]),
                                                    static_cast<int>(c[l]),
                                                    acc[m * P::COLS + 4 * e + l]);
          }
        }
      }
    }
    if (it % span == span - 1) finish(it);   // block-uniform
  };

  uint32_t ba[4][P::CW], bb[4][P::CW];
  if (items > 0) load_item(0, ba);
  if (xvec) {
    const uint4* src = reinterpret_cast<const uint4*>(x);
    for (int i = tid; i < M * nq / 4; i += S_THREADS)
      reinterpret_cast<uint4*>(xw)[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < M * nq; i += S_THREADS)
      xw[i] = __ldg(reinterpret_cast<const uint32_t*>(x) + i);
  }
  __syncthreads();
  for (int it = 0; it < items; it += 2) {
    if (it + 1 < items) load_item(it + 1, bb);
    run_item(it, ba);
    if (it + 1 >= items) break;
    if (it + 2 < items) load_item(it + 2, ba);
    run_item(it + 1, bb);
  }
}

// ---------------------------------------------------------------------------
// Large M, and every grouped body but K3 / K4: one int8 tensor-core tile
// ---------------------------------------------------------------------------

// A BM x BN output tile of warps of 32 x 32 (16 x 32 at BM = 16) on
// mma.sync m16n8k32 s8 with ldmatrix fragments: BM = 128 is 8 warps, 4
// along M x 2 along N (BN = 64); BM = 16 is 4 warps along N (BN = 128),
// for a grouped launch's few rows per expert (K11, and K7, K8, K10 over
// expert stacks). Measured on the card at the
// deepseek-moe-16b decode tick (16 rows an expert): with 8 warps along N
// (BN = 256) the 128-row tile took 2.7x and a 32-row one 1.09x the 16-row
// tile's time (the padding rows they stage and multiply); the 16-row tile
// with 4 warps took 0.96x and with 2 warps 1.03x of its 8-warp time: four
// blocks share an SM, and while one waits at its barriers the others
// convert and multiply. A 3-stage cp.async ring
// brings each 128-k stage of the activation tile and of the raw weights;
// each stage the block turns its raw weights into a padded int8 tile Bc (N
// rows of K-contiguous codes, the layout ldmatrix and the s8 mma need),
// once per block for all BM rows, by the body's own weight stage:
//   WK_I8      K-major (K, N) int8: cp.async in rows of BN columns (every
//              4 rows padded by 16 bytes, so the transpose's reads spread
//              over the banks), then per thread a 4 x 8 byte block is
//              transposed (2 x transpose4x4) into 8 column words of 4 k; a
//              warp's 32 lanes take 32 k-quads of one 8-column block, so
//              their stores into Bc hit 32 distinct banks
//   WK_S4      (N, K/8) s4 words: 4 words (32 k) per thread -> 8 code words
//              (s4_to_codes)
//   WK_PLANES4 / WK_PLANES8  a BITS-plane stack, np live planes: one plane
//              word of each plane per thread -> 32 composed codes
//              (compose_word)
//   WK_BITS / WK_TRITS  (N, K/32) bit words, one plane or (mask, sign): one
//              word of each per thread -> 32 ±1 or trit codes (mxu_codes)
//   WK_WT      K8: (mask, sign) trit words against int8 activations: as
//              WK_TRITS; at BM = 128 then put back in k order
//              (interleave32), since its activations are cp.async'd into As
//              in k order. At BM = 16 the 16 activation rows are put in
//              mxu_codes' order instead (Tc::WT_ACTS), not the BN = 128
//              weight columns: 8x fewer byte permutes a stage
// The int8 bodies cp.async their activations straight into the ring's
// tile As (K8 at BM = 16 into the ring, then permuted each stage into one
// padded As tile). K7's activations are bits or trits too: the ring holds
// their raw
// words (16 bytes a row and plane per stage) and, beside the weight stage,
// each stage unpacks them into one padded As tile (mxu_codes; zero codes
// past K, so the padded weight codes add nothing). K7 keeps both sides in
// mxu_codes' k-interleaved order inside each 32 k: the same permutation of
// k on both sides leaves the dot unchanged. Composing K10's codes bounds
// its tile (2*M*N*K MACs cost the tensor cores little against ~11 ops per 4
// codes, once per BM rows); K7's unpack (3 or 5 ops per 4 codes, both
// sides), the K1 transpose (~6) and the K9 unpack (~2) cost less.
//
// Grouped K7 and K8 at 16 rows (the MoE decode tick) are not bound by
// their bytes or their codes: measured on the card at deepseek-moe-16b's
// tick, a stage takes ~2 us a block whether it brings 2 KB (binary), 4 KB
// (trits) or 8 KB (K11's s4), so binary K7, ternary K7 and K8 take
// 5.4x, 3.3x and 3.1x their byte bounds, under K11's s4 tile. What moved
// nothing or lost (chip_ab.py, PERF.md): 2 or 8 warps, 4-8 ring stages,
// 5-6 blocks an SM (they spill), trit codes by prmt's sign mode (4 ops a
// word, not 5); K8's permuted activations gained 3-7 %, kept.
//
// Groups (K11, K10 over expert stacks, grouped K7 and K8; grouped K3 and
// K4 on the b1 tile below take the same TcArgs): blockIdx.z is
// the member of a grouped launch, and each block offsets x, w, w_scale (N),
// a_scale (M), bias (N) and out (M x N) by it (group_member); an ungrouped
// launch is the one member z = 0. A trit operand's sign plane lies a fixed
// word distance from its mask plane (pstride, xpstride: two contiguous
// tensors of one shape), the same for every member.
constexpr int T_THREADS = 256;     // 8 warps (4 at BM = 16)
constexpr int T_BM = 128;          // rows of the tile every body runs above SMALL_M
constexpr int T_KS = 128;          // k per stage
constexpr int T_STAGES = 3;
constexpr int T_LD = T_KS + 16;    // padded row, bytes: ldmatrix's 8 rows in distinct banks
// rows up to which a grouped launch takes the 16-row tile
constexpr int G_SMALL_M = 16;

enum { WK_I8, WK_S4, WK_PLANES4, WK_PLANES8, WK_BITS, WK_TRITS, WK_WT };

template <int WK, int BM> struct Tc {
  static constexpr int MT = BM >= 32 ? 2 : 1;            // m16 tiles a warp
  static constexpr int WARPS_M = BM / (16 * MT);         // 4 | 1
  static constexpr int THREADS = BM == 16 ? 128 : T_THREADS;
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int BN = 32 * WARPS_N;                // 64 | 128
  static_assert(WARPS_M * 16 * MT == BM && WARPS_M * WARPS_N * 32 == THREADS,
                "warp grid");
  // activation bit planes staged raw (0: int8 rows, cp.async'd into As)
  static constexpr int XP = WK == WK_BITS ? 1 : WK == WK_TRITS ? 2 : 0;
  // K8 at 16 rows: the int8 activation stage is permuted into mxu_codes'
  // order in its own As tile, and the weight codes stay in that order
  static constexpr bool WT_ACTS = WK == WK_WT && BM < BN;
  // the stage's activation codes are written into their own As tile
  static constexpr bool ACODES = XP > 0 || WT_ACTS;
  // weight bit planes staged raw (planes: the stack's BITS)
  static constexpr int WP = WK == WK_PLANES4 ? 4 : WK == WK_PLANES8 ? 8
                            : WK == WK_TRITS || WK == WK_WT ? 2 : 1;
  static constexpr int BITS = WK == WK_PLANES4 ? 4 : WK == WK_PLANES8 ? 8 : 0;
  static constexpr int KQ = 4 * BN + 16;   // WK_I8: bytes of 4 staged K-major rows + pad
  // raw weight bytes staged per stage
  static constexpr int RAW = WK == WK_I8 ? (T_KS / 4) * KQ
                             : WK == WK_S4 ? BN * (T_KS / 2)
                             : WP * BN * (T_KS / 8);
  // a ring stage of activations: raw bit words, or the int8 tile itself
  static constexpr int ARAW = XP ? XP * BM * (T_KS / 8) : BM * T_LD;
  static constexpr int SMEM = T_STAGES * (ARAW + RAW) + (ACODES ? BM * T_LD : 0) + BN * T_LD;
};

struct TcArgs {
  const uint8_t* x;
  const void* w;
  const float* w_scale;
  const float* a_scale;
  const float* bias;
  void* out;
  int out_acc, M, N, K;
  int np;                // WK_PLANES*: live planes
  long long pstride;     // WK_PLANES*, WK_TRITS, WK_WT: words from one weight plane to the next
  long long xpstride;    // WK_TRITS: words from the activation mask plane to the sign plane
  long long xg, wg;      // bytes from one group member's x / w to the next
  int xvec;              // activation rows 16-byte aligned (else 4-byte copies)
  int wvec;              // weight rows 16-byte aligned (else 4-byte copies)
};

// The arguments of one ungrouped GEMM, every other field zero.
inline TcArgs tc_args(const void* x, const void* w, const float* w_scale,
                      const float* a_scale, const float* bias, void* out, int out_acc,
                      int M, int N, int K) {
  TcArgs a{};
  a.x = static_cast<const uint8_t*>(x);
  a.w = w;
  a.w_scale = w_scale;
  a.a_scale = a_scale;
  a.bias = bias;
  a.out = out;
  a.out_acc = out_acc;
  a.M = M;
  a.N = N;
  a.K = K;
  a.np = 1;
  return a;
}

// this block's member of a grouped launch: every operand offset by it
__device__ __forceinline__ TcArgs group_member(TcArgs a) {
  const long long g = blockIdx.z;
  a.x += g * a.xg;
  a.w = static_cast<const uint8_t*>(a.w) + g * a.wg;
  if (a.w_scale) a.w_scale += g * a.N;
  if (a.a_scale) a.a_scale += g * a.M;
  if (a.bias) a.bias += g * a.N;
  a.out = static_cast<uint8_t*>(a.out) + g * a.M * a.N * (a.out_acc ? 4 : 2);
  return a;
}

// cp.async the raw weights of the stage at k0 into `raw`
template <int WK, int BM>
__device__ __forceinline__ void load_weights(const TcArgs& a, uint8_t* raw, int k0,
                                             int n0, int tid) {
  using T = Tc<WK, BM>;
  constexpr int BN = T::BN;
  if constexpr (WK == WK_I8) {
    const auto* w = static_cast<const uint8_t*>(a.w);
    if (a.wvec) {              // 16 columns a copy
      for (int i = tid; i < T_KS * (BN / 16); i += Tc<WK, BM>::THREADS) {
        const int r = i / (BN / 16), j = i % (BN / 16), k = k0 + r, n = n0 + 16 * j;
        const bool ok = k < a.K && n < a.N;
        cp_async16(raw + (r >> 2) * T::KQ + (r & 3) * BN + 16 * j,
                   ok ? w + (size_t)k * a.N + n : w, ok ? 16 : 0);
      }
    } else {                   // 4 columns a copy (N % 4 == 0)
      for (int i = tid; i < T_KS * (BN / 4); i += Tc<WK, BM>::THREADS) {
        const int r = i / (BN / 4), j = i % (BN / 4), k = k0 + r, n = n0 + 4 * j;
        const bool ok = k < a.K && n < a.N;
        cp_async4(raw + (r >> 2) * T::KQ + (r & 3) * BN + 4 * j,
                  ok ? w + (size_t)k * a.N + n : w, ok ? 4 : 0);
      }
    }
  } else {
    // row-major words: s4 (N, K/8) or each bit plane (N, K/32); W words per
    // column per stage
    constexpr int KPW = WK == WK_S4 ? 8 : 32;
    constexpr int W = T_KS / KPW;                 // 16 | 4
    const auto* w = static_cast<const uint32_t*>(a.w);
    const int kw = a.K / KPW, kw0 = k0 / KPW;
    const int planes = T::BITS ? a.np : T::WP;
    uint32_t* dst0 = reinterpret_cast<uint32_t*>(raw);
    if (a.wvec) {
      for (int i = tid; i < planes * BN * (W / 4); i += Tc<WK, BM>::THREADS) {
        const int p = i / (BN * (W / 4)), c = i / (W / 4) % BN, j = i % (W / 4);
        const int n = n0 + c, kq = kw0 + 4 * j;
        const bool ok = n < a.N && kq < kw;
        cp_async16(dst0 + (p * BN + c) * W + 4 * j,
                   ok ? w + p * a.pstride + (size_t)n * kw + kq : w, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < planes * BN * W; i += Tc<WK, BM>::THREADS) {
        const int p = i / (BN * W), c = i / W % BN, j = i % W;
        const int n = n0 + c, kq = kw0 + j;
        const bool ok = n < a.N && kq < kw;
        cp_async4(dst0 + (p * BN + c) * W + j,
                  ok ? w + p * a.pstride + (size_t)n * kw + kq : w, ok ? 4 : 0);
      }
    }
  }
}

// raw weights of one stage -> Bc [BN][T_LD] int8 codes, k-contiguous rows
template <int WK, int BM>
__device__ __forceinline__ void weights_to_codes(const TcArgs& a, const uint8_t* raw,
                                                 uint8_t* Bc, int tid) {
  using T = Tc<WK, BM>;
  constexpr int BN = T::BN;
  if constexpr (WK == WK_I8) {
    // warp = 8-column block, lane = k-quad: 4 rows of 8 bytes, transposed
    const int kq = tid & 31;
    for (int c8 = tid >> 5; c8 < BN / 8; c8 += Tc<WK, BM>::THREADS / 32) {
      uint2 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint2*>(raw + kq * T::KQ + i * BN + 8 * c8);
      uint32_t lo[4], hi[4];
      transpose4x4(r[0].x, r[1].x, r[2].x, r[3].x, lo);
      transpose4x4(r[0].y, r[1].y, r[2].y, r[3].y, hi);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        *reinterpret_cast<uint32_t*>(Bc + (8 * c8 + l) * T_LD + 4 * kq) = lo[l];
        *reinterpret_cast<uint32_t*>(Bc + (8 * c8 + 4 + l) * T_LD + 4 * kq) = hi[l];
      }
    }
  } else {
    // thread = (column c, 32-k piece e) -> 32 codes of column c
    for (int i = tid; i < BN * 4; i += Tc<WK, BM>::THREADS) {
      const int c = i >> 2, e = i & 3;
      uint32_t cw[8];
      if constexpr (WK == WK_S4) {
        const uint4 v = reinterpret_cast<const uint4*>(raw)[c * 4 + e];
        s4_to_codes(v.x, cw[0], cw[1]);
        s4_to_codes(v.y, cw[2], cw[3]);
        s4_to_codes(v.z, cw[4], cw[5]);
        s4_to_codes(v.w, cw[6], cw[7]);
      } else {
        const uint32_t* Ws = reinterpret_cast<const uint32_t*>(raw);
        uint32_t pw[T::WP];
#pragma unroll
        for (int p = 0; p < T::WP; ++p)
          pw[p] = (T::BITS == 0 || p < a.np) ? Ws[(p * BN + c) * 4 + e] : 0u;
        if constexpr (T::BITS) {
          compose_word<T::BITS, T::BITS>(pw, cw);
        } else if constexpr (WK == WK_WT && !T::WT_ACTS) {
          uint32_t t[8];
          mxu_codes<2>(pw, t);
          interleave32<true>(t, cw);
        } else {
          mxu_codes<T::WP>(pw, cw);
        }
      }
      uint4* d = reinterpret_cast<uint4*>(Bc + c * T_LD + 32 * e);
      d[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
      d[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
    }
  }
}

// K7: cp.async the raw activation words of the stage at k0 (4 words a row
// and plane) into `raw` [plane][row][4]
template <int WK, int BM>
__device__ __forceinline__ void load_act_words(const TcArgs& a, uint8_t* raw, int k0,
                                               int m0, int tid) {
  constexpr int XP = Tc<WK, BM>::XP;
  const auto* x = reinterpret_cast<const uint32_t*>(a.x);
  const int kw = a.K / 32, kw0 = k0 / 32;
  uint32_t* d = reinterpret_cast<uint32_t*>(raw);
  if (a.xvec) {              // kw % 4 == 0: a stage's 4 words are all in K
    for (int i = tid; i < XP * BM; i += Tc<WK, BM>::THREADS) {
      const int p = i / BM, r = i % BM, m = m0 + r;
      const bool ok = m < a.M;
      cp_async16(d + (p * BM + r) * 4,
                 ok ? x + p * a.xpstride + (size_t)m * kw + kw0 : x, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < XP * BM * 4; i += Tc<WK, BM>::THREADS) {
      const int p = i / (BM * 4), r = i / 4 % BM, j = i % 4, m = m0 + r;
      const bool ok = m < a.M && kw0 + j < kw;
      cp_async4(d + (p * BM + r) * 4 + j,
                ok ? x + p * a.xpstride + (size_t)m * kw + kw0 + j : x, ok ? 4 : 0);
    }
  }
}

// K7: raw activation words of the stage at k0 -> As [BM][T_LD] codes, zero
// past K
template <int WK, int BM>
__device__ __forceinline__ void acts_to_codes(const TcArgs& a, const uint8_t* raw,
                                              uint8_t* As, int k0, int tid) {
  constexpr int XP = Tc<WK, BM>::XP;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(raw);
  const int kw = a.K / 32, kw0 = k0 / 32;
  for (int i = tid; i < BM * 4; i += Tc<WK, BM>::THREADS) {
    const int r = i >> 2, e = i & 3;
    uint32_t cw[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (kw0 + e < kw) {
      uint32_t pw[XP];
#pragma unroll
      for (int p = 0; p < XP; ++p) pw[p] = xw[(p * BM + r) * 4 + e];
      mxu_codes<XP>(pw, cw);
    }
    uint4* d = reinterpret_cast<uint4*>(As + r * T_LD + 32 * e);
    d[0] = make_uint4(cw[0], cw[1], cw[2], cw[3]);
    d[1] = make_uint4(cw[4], cw[5], cw[6], cw[7]);
  }
}

// K8 at 16 rows: the stage's int8 activation rows (k order, zero past K
// and M) -> As in mxu_codes' k-interleaved order
template <int WK, int BM>
__device__ __forceinline__ void acts_to_interleaved(const uint8_t* raw, uint8_t* As,
                                                    int tid) {
  for (int i = tid; i < BM * 4; i += Tc<WK, BM>::THREADS) {
    const int r = i >> 2, e = i & 3;
    const uint4* src = reinterpret_cast<const uint4*>(raw + r * T_LD + 32 * e);
    const uint4 p = src[0], q = src[1];
    const uint32_t v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    uint32_t t[8];
    interleave32<false>(v, t);
    uint4* d = reinterpret_cast<uint4*>(As + r * T_LD + 32 * e);
    d[0] = make_uint4(t[0], t[1], t[2], t[3]);
    d[1] = make_uint4(t[4], t[5], t[6], t[7]);
  }
}

template <int WK, int BM>
__device__ __forceinline__ void mma_tile(const TcArgs& a) {
  using T = Tc<WK, BM>;
  constexpr int BN = T::BN, MT = T::MT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Ring = smem;                                  // [S][ARAW]
  constexpr int S = T_STAGES;
  uint8_t* Raw = smem + S * T::ARAW;                     // [S][RAW]
  uint8_t* As = T::ACODES ? Raw + S * T::RAW : Ring;     // K7, K8 at 16 rows: [BM][LD]
  uint8_t* Bc = Raw + S * T::RAW + (T::ACODES ? BM * T_LD : 0);   // [BN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nst = (a.K + T_KS - 1) / T_KS;

  auto load_stage = [&](int st, int buf) {
    const int k0 = st * T_KS;
    if constexpr (T::XP) {
      load_act_words<WK, BM>(a, Ring + buf * T::ARAW, k0, m0, tid);
    } else {
      for (int i = tid; i < BM * (T_KS / 16); i += Tc<WK, BM>::THREADS) {
        const int r = i / (T_KS / 16), c = i % (T_KS / 16), m = m0 + r, k = k0 + 16 * c;
        uint8_t* dst = Ring + buf * T::ARAW + r * T_LD + 16 * c;
        const uint8_t* src = a.x + (size_t)m * a.K + k;
        if (a.xvec) {
          const bool ok = m < a.M && k < a.K;
          cp_async16(dst, ok ? src : a.x, ok ? 16 : 0);
        } else {                        // K % 4 == 0: whole words
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = m < a.M && k + 4 * e < a.K;
            cp_async4(dst + 4 * e, ok ? src + 4 * e : a.x, ok ? 4 : 0);
          }
        }
      }
    }
    load_weights<WK, BM>(a, Raw + buf * T::RAW, k0, n0, tid);
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int buf = st % S;
    cp_async_wait<S - 2>();               // this stage's copies have landed
    __syncthreads();                      // ... everyone's; the last stage is consumed
    if constexpr (T::XP)
      acts_to_codes<WK, BM>(a, Ring + buf * T::ARAW, As, st * T_KS, tid);
    else if constexpr (T::WT_ACTS)
      acts_to_interleaved<WK, BM>(Ring + buf * T::ARAW, As, tid);
    weights_to_codes<WK, BM>(a, Raw + buf * T::RAW, Bc, tid);
    {
      const int nx = st + S - 1;          // into the buffer the last stage freed
      if (nx < nst) load_stage(nx, nx % S);
      cp_async_commit();
    }
    __syncthreads();                      // the code tiles are complete
    const uint8_t* A = T::ACODES ? As : Ring + buf * T::ARAW;
#pragma unroll
    for (int ks = 0; ks < T_KS / 32; ++ks) {
      uint32_t af[MT][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], A + (wm * 16 * MT + mt * 16 + (lane & 15)) * T_LD + 32 * ks +
                            16 * (lane >> 4));
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        uint32_t r[4];
        ldsm_x4(r, Bc + (wn * 32 + nt * 8 + (lane & 7) + 8 * (lane >> 4)) * T_LD +
                       32 * ks + 16 * ((lane >> 3) & 1));
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }

  // accumulator fragment: c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 * MT + mt * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
        if (m < a.M && n < a.N)
          store_out(a.out, a.out_acc, (size_t)m * a.N + n, acc[mt][nt][e], a.w_scale,
                    a.a_scale, a.bias, m, n);
      }
}

// one kernel name per body, so that its SASS can be checked on its own;
// each takes a group index (K11, K10 over expert stacks, grouped K7 and K8)
// and a row tile
template <int BM>
__global__ void __launch_bounds__(Tc<WK_I8, BM>::THREADS, 512 / Tc<WK_I8, BM>::THREADS)
i8_mma_kernel(TcArgs a) {
  mma_tile<WK_I8, BM>(group_member(a));
}
template <int BM>
__global__ void __launch_bounds__(Tc<WK_S4, BM>::THREADS, 512 / Tc<WK_S4, BM>::THREADS)
s4_mma_kernel(TcArgs a) {
  mma_tile<WK_S4, BM>(group_member(a));
}
// K10, and K10 over expert stacks: a row tile and a group index as K11's
template <int BITS> __host__ __device__ constexpr int planes_wk() { return BITS == 4 ? WK_PLANES4 : WK_PLANES8; }
template <int BITS, int BM>
__global__ void __launch_bounds__(Tc<planes_wk<BITS>(), BM>::THREADS,
                                  512 / Tc<planes_wk<BITS>(), BM>::THREADS)
planes_mma_kernel(TcArgs a) {
  mma_tile<planes_wk<BITS>(), BM>(group_member(a));
}
template <int BM>
__global__ void __launch_bounds__(Tc<WK_BITS, BM>::THREADS, 512 / Tc<WK_BITS, BM>::THREADS)
bmxu_mma_kernel(TcArgs a) {
  mma_tile<WK_BITS, BM>(group_member(a));
}
template <int BM>
__global__ void __launch_bounds__(Tc<WK_TRITS, BM>::THREADS, 512 / Tc<WK_TRITS, BM>::THREADS)
tmxu_mma_kernel(TcArgs a) {
  mma_tile<WK_TRITS, BM>(group_member(a));
}
template <int BM>
__global__ void __launch_bounds__(Tc<WK_WT, BM>::THREADS, 512 / Tc<WK_WT, BM>::THREADS)
wt_mma_kernel(TcArgs a) {
  mma_tile<WK_WT, BM>(group_member(a));
}

// ---------------------------------------------------------------------------
// K3 / K4 above 8 rows, and grouped: the packed operands on the b1 tensor cores
// ---------------------------------------------------------------------------

// An output tile of warps of 16 x 32 on mma.sync m16n8k256 b1 with AND-popc
// (mma_b1; BMMA in the SASS, so the tensor cores run it). Its fragments
// have the s8 m16n8k32 layout with a register holding one packed word (32
// k) instead of four codes, so a bit tile staged as rows of packed words is
// read by the int8 tile's ldmatrix addressing unchanged, 32 bytes = 256 k a
// step. Neither side is unpacked: a 3-stage cp.async ring brings KB bytes
// (8 KB k) of each plane of each row and column straight into the padded
// rows the fragments are loaded from (PopTile::LD: the 8 rows of an
// ldmatrix in distinct banks), and the AND-popc identities run on the
// fragments in registers:
//   binary   agree = P(x, w) + P(~x, ~w), dot = 2 agree - K. Zero words past
//            K agree under the complement (rows past M and columns past N
//            are never stored), so the epilogue takes the padding, nst * KS
//            - K, off agree.
//   ternary  positive and negative planes xq = xm & ~xs, xn = xm & xs (the
//            mask applied to the sign plane, so that a sign bit under a
//            zero mask counts for nothing, as in the gated XNOR), the same
//            for w; agree = P(xq, wq) + P(xn, wn), active = P(xm, wm), dot =
//            2 agree - active: three products per 256 k into two
//            accumulator sets.
// Each is exact in int32, so the dot is the popcount bodies' bit for bit.
// Two row tiles, each with blockIdx.z the member of a grouped launch
// (group_member, as the int8 tiles; an ungrouped launch is member 0):
//   64 rows, 8 warps (4 along M x 2 along N, BN = 64), 3 ring stages:
//            above SMALL_M rows ungrouped (verify rows, prefill buckets)
//            and above G_SMALL_M grouped. 64, not the int8 tile's 128: at
//            32 x 32 a warp the ternary accumulators and fragments spilled,
//            and a 32-row prefill bucket pads fewer rows. Bound: the b1
//            products (2 or 3 per 256 k), for which Hopper publishes no
//            rate (XOR-popc, one product for binary, compiles for sm_90a
//            but ran 1.16-1.34x slower).
//   16 rows, 4 warps along N (BN = 128), 2 ring stages: a grouped launch up
//            to G_SMALL_M rows an expert (the MoE decode tick), so that no
//            padding rows are staged or multiplied. Not wgmma, whose M is 64
//            at least. A stage covers 1024 k (binary) or 512 k (ternary),
//            against the int8 tile's 128, so an expert's K is 2-3 stages.
//            Blocks in flight decide its speed: 2 stages (41 / 46 KB) fit 4
//            blocks an SM in 128 registers, where 3 stages fit 3 and took
//            1.12-1.2x the time. Measured on the card at deepseek's tick
//            (chip_ab.py, PERF.md), against the 3-stage tile: the 64-row
//            tile with a grid z 1.6-1.7x, 8 warps 1.15-1.2x; against this
//            one, 5 blocks, 2 warps, half or whole-row stages and one b1
//            product for binary (row and column popcounts on the CUDA
//            cores) no faster. It runs at 2.0-2.4x its byte bound.
constexpr int P_BM = 64;           // rows of the tile above SMALL_M / G_SMALL_M

template <int NP, int BM> struct PopTile {
  static constexpr int STAGES = BM == 16 ? 2 : 3;          // cp.async ring
  static constexpr int THREADS = BM == 16 ? 128 : 256;
  static constexpr int WARPS_M = BM / 16;                  // 1 | 4
  static constexpr int BN = 32 * (THREADS / 32 / WARPS_M); // 128 | 64
  static constexpr int KB = NP == 1 ? 128 : 64;  // bytes of a row and plane a stage
  static constexpr int KS = 8 * KB;              // k a stage: 1024 | 512
  static constexpr int LD = KB + 16;             // padded row pitch, bytes
  static constexpr int A = NP * BM * LD;         // activation bytes of a stage
  static constexpr int STAGE = NP * (BM + BN) * LD;   // bytes of a stage
  static constexpr int SMEM = STAGES * STAGE;
  // resident blocks an SM (launch bounds: 128 registers a thread)
  static constexpr int BLOCKS = THREADS == 256 ? 2 : 4;
  static_assert(WARPS_M * 16 == BM && BN % 32 == 0, "warp grid");
};

// cp.async the words kw0 .. kw0 + KB/4 - 1 of each plane of rows row0 ..
// row0 + ROWS - 1 (`valid` of them real, plane p at src + p * pstride) into
// dst [plane][ROWS][LD], zero past `valid` and past K; `vec`: 16-byte
// copies (rows 16-byte aligned, K/32 a multiple of 4); by the threads of
// the tile P
template <int NP, typename P, int ROWS>
__device__ __forceinline__ void pop_stage(const uint32_t* src, long long pstride, int row0,
                                          int valid, int kw, int kw0, uint8_t* dst, int vec,
                                          int tid) {
  constexpr int LD = P::LD, THREADS = P::THREADS;
  constexpr int C = P::KB / 16;                  // 16-byte pieces of a row
  if (vec) {
    for (int i = tid; i < NP * ROWS * C; i += THREADS) {
      const int p = i / (ROWS * C), r = i / C % ROWS, c = i % C;
      const int row = row0 + r, kq = kw0 + 4 * c;
      const bool ok = row < valid && kq < kw;
      cp_async16(dst + (p * ROWS + r) * LD + 16 * c,
                 ok ? src + p * pstride + (size_t)row * kw + kq : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < NP * ROWS * C * 4; i += THREADS) {
      const int p = i / (ROWS * C * 4), r = i / (C * 4) % ROWS, j = i % (C * 4);
      const int row = row0 + r, kq = kw0 + j;
      const bool ok = row < valid && kq < kw;
      cp_async4(dst + (p * ROWS + r) * LD + 4 * j,
                ok ? src + p * pstride + (size_t)row * kw + kq : src, ok ? 4 : 0);
    }
  }
}

// bits (NP = 1) or (mask, sign) trits (NP = 2) on both sides: x (M, K/32)
// words a plane, the sign plane a.xpstride words on; w (N, K/32) likewise,
// a.pstride
template <int NP, int BM>
__global__ void __launch_bounds__(PopTile<NP, BM>::THREADS, PopTile<NP, BM>::BLOCKS)
pop_mma_kernel(TcArgs args) {
  using P = PopTile<NP, BM>;
  constexpr int BN = P::BN;
  const TcArgs a = group_member(args);
  const auto* x = reinterpret_cast<const uint32_t*>(a.x);
  const auto* w = static_cast<const uint32_t*>(a.w);
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % P::WARPS_M, wn = warp / P::WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = a.K, kw = K / 32, nst = (K + P::KS - 1) / P::KS;

  auto load_stage = [&](int st) {
    uint8_t* s = smem + (st % P::STAGES) * P::STAGE;
    const int kw0 = st * (P::KS / 32);
    pop_stage<NP, P, BM>(x, a.xpstride, m0, a.M, kw, kw0, s, a.xvec, tid);
    pop_stage<NP, P, BN>(w, a.pstride, n0, a.N, kw, kw0, s + P::A, a.wvec, tid);
  };

  int acc[4][4], act[4][4];          // act: ternary's active count
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = act[j][c] = 0;

#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<P::STAGES - 2>();        // this stage's copies have landed
    __syncthreads();                      // ... everyone's; the last stage is consumed
    if (st + P::STAGES - 1 < nst) load_stage(st + P::STAGES - 1);
    cp_async_commit();
    const uint8_t* As = smem + (st % P::STAGES) * P::STAGE;
    const uint8_t* Bs = As + P::A;
#pragma unroll
    for (int ks = 0; ks < P::KB / 32; ++ks) {
      uint32_t af[NP][4], bf[NP][4][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        ldsm_x4(af[p], As + (p * BM + wm * 16 + (lane & 15)) * P::LD + 32 * ks +
                           16 * (lane >> 4));
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t r[4];
          ldsm_x4(r, Bs + (p * BN + wn * 32 + nt * 8 + (lane & 7) + 8 * (lane >> 4)) *
                              P::LD + 32 * ks + 16 * ((lane >> 3) & 1));
          bf[p][nt][0] = r[0];
          bf[p][nt][1] = r[1];
          bf[p][nt + 1][0] = r[2];
          bf[p][nt + 1][1] = r[3];
        }
      }
      if constexpr (NP == 1) {
        const uint32_t na[4] = {~af[0][0], ~af[0][1], ~af[0][2], ~af[0][3]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_b1(acc[nt], af[0], bf[0][nt][0], bf[0][nt][1]);
          mma_b1(acc[nt], na, ~bf[0][nt][0], ~bf[0][nt][1]);
        }
      } else {
        uint32_t aq[4], an[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = af[0][i] & ~af[1][i];
          an[i] = af[0][i] & af[1][i];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* mk = bf[0][nt];
          const uint32_t* sg = bf[1][nt];
          mma_b1(acc[nt], aq, mk[0] & ~sg[0], mk[1] & ~sg[1]);
          mma_b1(acc[nt], an, mk[0] & sg[0], mk[1] & sg[1]);
          mma_b1(act[nt], af[0], mk[0], mk[1]);
        }
      }
    }
  }

  // accumulator fragment: c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at row g + 8
  const int g = lane >> 2, t4 = lane & 3, pad = nst * P::KS - K;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 16 + g + 8 * (e >> 1);
      const int n = n0 + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
      const int dot = NP == 1 ? 2 * (acc[nt][e] - pad) - K : 2 * acc[nt][e] - act[nt][e];
      if (m < a.M && n < a.N)
        store_out(a.out, a.out_acc, (size_t)m * a.N + n, dot, a.w_scale, a.a_scale, a.bias,
                  m, n);
    }
}

// `groups` GEMMs (gridDim.z) of a tile T's kernel (T::THREADS threads,
// T::SMEM bytes of shared memory, T::BN columns and BM rows a block)
template <typename T, int BM, typename F>
int launch_tile(F* kernel, const TcArgs& a, int groups, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + BM - 1) / BM, groups);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the b1 tile of `groups` GEMMs: BM = 16 or P_BM rows
template <int NP, int BM>
int launch_pop_mma(const TcArgs& a, int groups, cudaStream_t stream) {
  return launch_tile<PopTile<NP, BM>, BM>(pop_mma_kernel<NP, BM>, a, groups, stream);
}

// `groups` GEMMs (gridDim.z) of the int8 tile's kernel
template <int WK, int BM, typename F>
int launch_mma(F* kernel, const TcArgs& a, int groups, cudaStream_t stream) {
  return launch_tile<Tc<WK, BM>, BM>(kernel, a, groups, stream);
}

// -- launchers ---------------------------------------------------------------

// K10's streaming kernel for np live planes (a compile-time NP)
template <int BITS, int MS, int NP = 1>
int launch_stream(int np, const uint8_t* x, const uint32_t* w, const float* w_scale,
                  const float* a_scale, const float* bias, void* out, int out_acc,
                  int M, int N, int K, long long pstride, int vec,
                  cudaStream_t stream) {
  if constexpr (NP > BITS) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (np != NP)
      return launch_stream<BITS, MS, NP + 1>(np, x, w, w_scale, a_scale, bias, out,
                                             out_acc, M, N, K, pstride, vec, stream);
    auto* kernel = planes_stream_kernel<BITS, NP, MS>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_XMAX);
    if (attr != cudaSuccess) return (int)attr;
    const int smem = M * ((K / 32 + 3) / 4) * 128;   // <= S_XMAX (launch_planes)
    static std::atomic<int> fit[S_XMAX / 128 + 1];   // smem / 128 -> blocks
    int blocks = 0;
    if (int e = resident_blocks(kernel, smem, fit, &blocks)) return e;
    const int tiles = (N + S_COLS - 1) / S_COLS;
    kernel<<<min(tiles, blocks), S_THREADS, smem, stream>>>(
        x, w, w_scale, a_scale, bias, out, out_acc, M, N, K, pstride, vec);
    return (int)cudaGetLastError();
  }
}

template <int BITS>
int launch_planes(const void* x0, const void* w0, const float* w_scale,
                  const float* a_scale, const float* bias, void* out, int out_acc,
                  int M, int N, int K, int np, long long pstride,
                  cudaStream_t stream) {
  const auto* x = static_cast<const uint8_t*>(x0);
  const auto* w = static_cast<const uint32_t*>(w0);
  if (np < 1 || np > BITS || K % 32) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorMisalignedAddress;
  const int vec = K % 128 == 0 && pstride % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // the streaming kernel stages all M x K activation bytes; past S_XMAX the
  // tensor-core kernel takes the few rows too
  if (M <= SMALL_M && (long long)M * ((K / 32 + 3) / 4) * 128 <= S_XMAX) {
    if (M <= 4)
      return launch_stream<BITS, 4>(np, x, w, w_scale, a_scale, bias, out, out_acc,
                                    M, N, K, pstride, vec, stream);
    return launch_stream<BITS, SMALL_M>(np, x, w, w_scale, a_scale, bias, out,
                                        out_acc, M, N, K, pstride, vec, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.np = np;
  a.pstride = pstride;
  a.xvec = 1;
  a.wvec = vec;
  return launch_mma<planes_wk<BITS>(), T_BM>(planes_mma_kernel<BITS, T_BM>, a, 1, stream);
}

// K10 over expert stacks: `groups` plane GEMMs of one shape in one launch of
// the plane tile, blockIdx.z the member, np live planes pstride words apart
// and the members xg / wg bytes apart (a truncated stack read in place). The
// tile's row choice is K11's: 16 rows up to G_SMALL_M, 128 above.
template <int BITS>
int launch_grouped_planes(int groups, const void* x0, const void* w0,
                          const float* w_scale, const float* a_scale, const float* bias,
                          void* out, int out_acc, int M, int N, int K, int np,
                          long long pstride, long long xg, long long wg,
                          cudaStream_t stream) {
  const auto xa = reinterpret_cast<uintptr_t>(x0), wa = reinterpret_cast<uintptr_t>(w0);
  if (np < 1 || np > BITS || K % 32 || pstride < (long long)N * (K / 32))
    return (int)cudaErrorInvalidValue;
  // the activation rows are cp.async'd 16 bytes at a time, as ungrouped
  if (xa % 16 || xg % 16 || wa % 4 || wg % 4) return (int)cudaErrorMisalignedAddress;
  TcArgs a = tc_args(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.np = np;
  a.pstride = pstride;
  a.xg = xg;
  a.wg = wg;
  a.xvec = 1;
  a.wvec = K % 128 == 0 && pstride % 4 == 0 && wa % 16 == 0 && wg % 16 == 0;
  constexpr int WK = planes_wk<BITS>();
  return M <= G_SMALL_M
             ? launch_mma<WK, 16>(planes_mma_kernel<BITS, 16>, a, groups, stream)
             : launch_mma<WK, T_BM>(planes_mma_kernel<BITS, T_BM>, a, groups, stream);
}

// words from a to b (two int32 operands, so a multiple of 4 bytes apart)
inline long long words_between(const void* a, const void* b) {
  return ((long long)reinterpret_cast<uintptr_t>(b) -
          (long long)reinterpret_cast<uintptr_t>(a)) / 4;
}

enum { S_MXU, S_WT, S_POP };

// The streaming kernels over bit-plane weight words: K7's (S_MXU), K8's
// (S_WT) or K3's / K4's (S_POP)
template <int NP, int MS, int SIDE = S_MXU>
int launch_mxu_stream(const uint32_t* x, long long xps, const uint32_t* w, long long wps,
                      const float* w_scale, const float* a_scale, const float* bias,
                      void* out, int out_acc, int M, int N, int K, int vec,
                      cudaStream_t stream) {
  auto* kernel = SIDE == S_WT    ? wt_stream_kernel<MS>
                 : SIDE == S_POP ? (NP == 1 ? bpop_stream_kernel<MS> : tpop_stream_kernel<MS>)
                 : NP == 1       ? bmxu_stream_kernel<MS>
                                 : tmxu_stream_kernel<MS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_XMAX);
  if (attr != cudaSuccess) return (int)attr;
  // staged: int8 codes, 128 bytes a k-quad, or packed words, 16 a plane
  const int smem = M * ((K / 32 + 3) / 4) * (SIDE == S_POP ? 16 * NP : 128);   // <= S_XMAX
  static std::atomic<int> fit[S_XMAX / 128 + 1];
  int blocks = 0;
  if (int e = resident_blocks(kernel, smem, fit, &blocks)) return e;
  const int tiles = (N + S_COLS - 1) / S_COLS;
  kernel<<<min(tiles, blocks), S_THREADS, smem, stream>>>(
      x, xps, w, wps, w_scale, a_scale, bias, out, out_acc, M, N, K, vec);
  return (int)cudaGetLastError();
}

// K7: bits (NP = 1) or (mask, sign) trit planes (NP = 2) on both sides, x
// (M, K/32) and w (N, K/32) words a plane; x1 / w1 the sign planes
template <int NP>
int launch_mxu(const void* x0, const void* x1, const void* w0, const void* w1,
               const float* w_scale, const float* a_scale, const float* bias, void* out,
               int out_acc, int M, int N, int K, cudaStream_t stream) {
  const auto* x = static_cast<const uint32_t*>(x0);
  const auto* w = static_cast<const uint32_t*>(w0);
  if (K % 32 || (NP == 2 && (!x1 || !w1))) return (int)cudaErrorInvalidValue;
  const long long xps = NP == 2 ? words_between(x0, x1) : 0;
  const long long wps = NP == 2 ? words_between(w0, w1) : 0;
  const int kw = K / 32;
  const int wvec = kw % 4 == 0 && wps % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= SMALL_M && (long long)M * ((kw + 3) / 4) * 128 <= S_XMAX) {
    if (M <= 4)
      return launch_mxu_stream<NP, 4>(x, xps, w, wps, w_scale, a_scale, bias, out,
                                      out_acc, M, N, K, wvec, stream);
    return launch_mxu_stream<NP, SMALL_M>(x, xps, w, wps, w_scale, a_scale, bias, out,
                                          out_acc, M, N, K, wvec, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.pstride = wps;
  a.xpstride = xps;
  a.xvec = kw % 4 == 0 && xps % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.wvec = wvec;
  if constexpr (NP == 1) return launch_mma<WK_BITS, T_BM>(bmxu_mma_kernel<T_BM>, a, 1, stream);
  else return launch_mma<WK_TRITS, T_BM>(tmxu_mma_kernel<T_BM>, a, 1, stream);
}

// K3 / K4: bits (NP = 1) or (mask, sign) trit planes (NP = 2) on both
// sides, packed, x (M, K/32) and w (N, K/32) words a plane; x1 / w1 the sign
// planes. Up to SMALL_M rows the packed weight stream, above the b1 tile.
template <int NP>
int launch_pop(const void* x0, const void* x1, const void* w0, const void* w1,
               const float* w_scale, const float* a_scale, const float* bias, void* out,
               int out_acc, int M, int N, int K, cudaStream_t stream) {
  const auto* x = static_cast<const uint32_t*>(x0);
  const auto* w = static_cast<const uint32_t*>(w0);
  if (K % 32 || (NP == 2 && (!x1 || !w1))) return (int)cudaErrorInvalidValue;
  const long long xps = NP == 2 ? words_between(x0, x1) : 0;
  const long long wps = NP == 2 ? words_between(w0, w1) : 0;
  const int kw = K / 32;
  const int wvec = kw % 4 == 0 && wps % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= SMALL_M && (long long)M * ((kw + 3) / 4) * 16 * NP <= S_XMAX) {
    if (M <= 4)
      return launch_mxu_stream<NP, 4, S_POP>(x, xps, w, wps, w_scale, a_scale, bias, out,
                                             out_acc, M, N, K, wvec, stream);
    return launch_mxu_stream<NP, SMALL_M, S_POP>(x, xps, w, wps, w_scale, a_scale, bias,
                                                 out, out_acc, M, N, K, wvec, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.pstride = wps;
  a.xpstride = xps;
  a.xvec = kw % 4 == 0 && xps % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.wvec = wvec;
  return launch_pop_mma<NP, P_BM>(a, 1, stream);
}

// K8: int8 activations (M, K), 16-byte aligned, x (mask, sign) trit weight
// planes (N, K/32) words each, w1 the sign plane
int launch_wt(const void* x0, const void* w0, const void* w1, const float* w_scale,
              const float* a_scale, const float* bias, void* out, int out_acc, int M,
              int N, int K, cudaStream_t stream) {
  const auto* x = static_cast<const uint32_t*>(x0);
  const auto* w = static_cast<const uint32_t*>(w0);
  if (K % 32 || !w1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorMisalignedAddress;
  const long long wps = words_between(w0, w1);
  const int kw = K / 32;
  const int wvec = kw % 4 == 0 && wps % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= SMALL_M && (long long)M * ((kw + 3) / 4) * 128 <= S_XMAX) {
    if (M <= 4)
      return launch_mxu_stream<2, 4, S_WT>(x, 0, w, wps, w_scale, a_scale, bias, out,
                                           out_acc, M, N, K, wvec, stream);
    return launch_mxu_stream<2, SMALL_M, S_WT>(x, 0, w, wps, w_scale, a_scale, bias, out,
                                               out_acc, M, N, K, wvec, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.pstride = wps;
  a.xvec = 1;                 // K % 32 == 0: every row starts 16-byte aligned
  a.wvec = wvec;
  return launch_mma<WK_WT, T_BM>(wt_mma_kernel<T_BM>, a, 1, stream);
}

template <int MS>
int launch_s4_stream(const uint8_t* x, const uint32_t* w, const float* w_scale,
                     const float* a_scale, const float* bias, void* out, int out_acc,
                     int M, int N, int K, int vec, cudaStream_t stream) {
  auto* kernel = s4_stream_kernel<MS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_XMAX);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = M * ((K / 8 + 3) / 4) * 32;     // <= S_XMAX (launch_s4)
  static std::atomic<int> fit[S_XMAX / 128 + 1];
  int blocks = 0;
  if (int e = resident_blocks(kernel, smem, fit, &blocks)) return e;
  const int tiles = (N + S_COLS - 1) / S_COLS;
  kernel<<<min(tiles, blocks), S_THREADS, smem, stream>>>(
      x, w, w_scale, a_scale, bias, out, out_acc, M, N, K, vec);
  return (int)cudaGetLastError();
}

// K9: s4 weights (N, K/8) x int8 activations (M, K)
int launch_s4(const void* x0, const void* w0, const float* w_scale,
              const float* a_scale, const float* bias, void* out, int out_acc, int M,
              int N, int K, cudaStream_t stream) {
  const auto* x = static_cast<const uint8_t*>(x0);
  const auto* w = static_cast<const uint32_t*>(w0);
  if (K % 8) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(w) % 4)
    return (int)cudaErrorMisalignedAddress;
  const int wvec = K % 32 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= SMALL_M && (long long)M * ((K / 8 + 3) / 4) * 32 <= S_XMAX) {
    if (M <= 4)
      return launch_s4_stream<4>(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K,
                                 wvec, stream);
    return launch_s4_stream<SMALL_M>(x, w, w_scale, a_scale, bias, out, out_acc, M, N,
                                     K, wvec, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.xvec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.wvec = wvec;
  return launch_mma<WK_S4, T_BM>(s4_mma_kernel<T_BM>, a, 1, stream);
}

// K1's split of K across blocks: `splits` units per 32-column tile, each of
// `span` items per k-lane. Fewest (rounds of resident blocks) x (items + 1,
// the reduction) wins; a tie keeps fewer splits (fewer atomics).
inline void i8_split(int tiles, int groups, int blocks, int* splits, int* span) {
  *splits = 1;
  *span = groups;
  if (tiles >= blocks) return;
  long long best = -1;
  for (int s = 1; s <= groups; ++s) {
    const int sp = (groups + s - 1) / s;
    if ((groups + sp - 1) / sp != s) continue;     // s is not the fewest for sp
    const long long cost = (((long long)tiles * s + blocks - 1) / blocks) * (sp + 1);
    if (best < 0 || cost < best) {
      best = cost;
      *splits = s;
      *span = sp;
    }
  }
}

template <int MS>
int launch_i8_stream(const uint8_t* x, const uint8_t* w, const float* w_scale,
                     const float* a_scale, const float* bias, void* out, int out_acc,
                     int M, int N, int K, int* ws, long long ws_ints,
                     cudaStream_t stream) {
  using P = I8S<MS>;
  auto* kernel = i8_stream_kernel<MS>;
  constexpr int RED = 4 * (S_THREADS / 32) * MS * P::TN;   // bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_XMAX + RED);
  if (attr != cudaSuccess) return (int)attr;
  const int nq = K / 4;
  const int smem = ((M * nq + 3) & ~3) * 4 + RED;  // <= S_XMAX + RED (launch_i8)
  static std::atomic<int> fit[(S_XMAX + RED) / 128 + 1];
  int blocks = 0;
  if (int e = resident_blocks(kernel, smem, fit, &blocks)) return e;
  const int tiles = (N + P::TN - 1) / P::TN;
  int splits = 1, span = 1;
  i8_split(tiles, (nq + P::KL - 1) / P::KL, blocks, &splits, &span);
  if (splits > 1 && (!ws || (long long)tiles * (MS * P::TN + 1) > ws_ints))
    return (int)cudaErrorInvalidValue;
  const int xvec = (M * nq) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec = N % P::COLS == 0 && reinterpret_cast<uintptr_t>(w) % (4 * P::CW) == 0;
  kernel<<<min(tiles * splits, blocks), S_THREADS, smem, stream>>>(
      x, w, w_scale, a_scale, bias, out, out_acc, M, N, K, splits, span, ws, xvec, vec);
  return (int)cudaGetLastError();
}

// K1: int8 activations (M, K) x K-major int8 weights (K, N)
int launch_i8(const void* x0, const void* w0, const float* w_scale,
              const float* a_scale, const float* bias, void* out, int out_acc, int M,
              int N, int K, int* ws, long long ws_ints, cudaStream_t stream) {
  const auto* x = static_cast<const uint8_t*>(x0);
  const auto* w = static_cast<const uint8_t*>(w0);
  if (K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(w) % 4)
    return (int)cudaErrorMisalignedAddress;
  if (M <= SMALL_M && (long long)M * K <= S_XMAX) {
    if (M <= 4)
      return launch_i8_stream<4>(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K,
                                 ws, ws_ints, stream);
    return launch_i8_stream<SMALL_M>(x, w, w_scale, a_scale, bias, out, out_acc, M, N,
                                     K, ws, ws_ints, stream);
  }
  TcArgs a = tc_args(x, w, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.xvec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return launch_mma<WK_I8, T_BM>(i8_mma_kernel<T_BM>, a, 1, stream);
}

// K11's int8 (K1) and s4 (K9) bodies: `groups` GEMMs of one shape in one
// launch of the tensor-core tile, blockIdx.z the group; x and w advance by
// xg / wg bytes from one member to the next. Up to G_SMALL_M rows (decode:
// slots x capacity rows an expert, 16 for 4 slots) the 16-row tile, so
// that no padding rows are staged and multiplied; above, the 128-row one.
int launch_grouped_tc(int body, int groups, const void* x0, const void* w0,
                      const float* w_scale, const float* a_scale, const float* bias,
                      void* out, int out_acc, int M, int N, int K, long long xg,
                      long long wg, cudaStream_t stream) {
  const auto xa = reinterpret_cast<uintptr_t>(x0), wa = reinterpret_cast<uintptr_t>(w0);
  if (body == BODY_I8 ? (K % 4 || N % 4) : K % 8) return (int)cudaErrorInvalidValue;
  if (xa % 4 || wa % 4 || xg % 4 || wg % 4) return (int)cudaErrorMisalignedAddress;
  TcArgs a = tc_args(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.xg = xg;
  a.wg = wg;
  a.xvec = K % 16 == 0 && xa % 16 == 0 && xg % 16 == 0;
  a.wvec = (body == BODY_I8 ? N % 16 == 0 : K % 32 == 0) && wa % 16 == 0 && wg % 16 == 0;
  if (body == BODY_I8)
    return M <= G_SMALL_M
               ? launch_mma<WK_I8, 16>(i8_mma_kernel<16>, a, groups, stream)
               : launch_mma<WK_I8, T_BM>(i8_mma_kernel<T_BM>, a, groups, stream);
  return M <= G_SMALL_M
             ? launch_mma<WK_S4, 16>(s4_mma_kernel<16>, a, groups, stream)
             : launch_mma<WK_S4, T_BM>(s4_mma_kernel<T_BM>, a, groups, stream);
}

// The K7 / K8 kernel of a row tile
template <int WK, int BM> auto bits_mma_kernel() {
  if constexpr (WK == WK_BITS) return bmxu_mma_kernel<BM>;
  else if constexpr (WK == WK_TRITS) return tmxu_mma_kernel<BM>;
  else return wt_mma_kernel<BM>;
}

// K7 (WK_BITS, WK_TRITS) and K8 (WK_WT) grouped: `groups` GEMMs of one shape
// in one launch of the tensor-core tile, blockIdx.z the member; x0 / w0
// advance by xg / wg bytes from one member to the next, and the sign planes
// x1 / w1 (trits) lie a fixed distance from them, the same for every
// member. The rows as K11's: the 16-row tile up to G_SMALL_M, 128 above.
template <int WK>
int launch_grouped_bits(int groups, const void* x0, const void* x1, const void* w0,
                        const void* w1, const float* w_scale, const float* a_scale,
                        const float* bias, void* out, int out_acc, int M, int N, int K,
                        long long xg, long long wg, cudaStream_t stream) {
  constexpr int XP = Tc<WK, T_BM>::XP, WP = Tc<WK, T_BM>::WP;
  const auto xa = reinterpret_cast<uintptr_t>(x0), wa = reinterpret_cast<uintptr_t>(w0);
  if (K % 32 || (XP == 2 && !x1) || (WP == 2 && !w1)) return (int)cudaErrorInvalidValue;
  if (xa % 4 || wa % 4 || xg % 4 || wg % 4) return (int)cudaErrorMisalignedAddress;
  // K8's activation rows are cp.async'd 16 bytes at a time, as ungrouped
  if (WK == WK_WT && (xa % 16 || xg % 16)) return (int)cudaErrorMisalignedAddress;
  TcArgs a = tc_args(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.xg = xg;
  a.wg = wg;
  a.pstride = WP == 2 ? words_between(w0, w1) : 0;
  a.xpstride = XP == 2 ? words_between(x0, x1) : 0;
  const int kw = K / 32;
  a.xvec = WK == WK_WT || (kw % 4 == 0 && a.xpstride % 4 == 0 && xa % 16 == 0 && xg % 16 == 0);
  a.wvec = kw % 4 == 0 && a.pstride % 4 == 0 && wa % 16 == 0 && wg % 16 == 0;
  return M <= G_SMALL_M
             ? launch_mma<WK, 16>(bits_mma_kernel<WK, 16>(), a, groups, stream)
             : launch_mma<WK, T_BM>(bits_mma_kernel<WK, T_BM>(), a, groups, stream);
}

// K3 (NP = 1) and K4 (NP = 2) grouped: `groups` GEMMs of one shape in one
// launch of the b1 tile, blockIdx.z the member; x0 / w0 advance by xg / wg
// bytes from one member to the next, and the sign planes x1 / w1 (trits)
// lie a fixed distance from them, the same for every member. The 16-row
// tile up to G_SMALL_M rows, the 64-row one above.
template <int NP>
int launch_grouped_pop(int groups, const void* x0, const void* x1, const void* w0,
                       const void* w1, const float* w_scale, const float* a_scale,
                       const float* bias, void* out, int out_acc, int M, int N, int K,
                       long long xg, long long wg, cudaStream_t stream) {
  const auto xa = reinterpret_cast<uintptr_t>(x0), wa = reinterpret_cast<uintptr_t>(w0);
  if (K % 32 || (NP == 2 && (!x1 || !w1))) return (int)cudaErrorInvalidValue;
  if (xa % 4 || wa % 4 || xg % 4 || wg % 4) return (int)cudaErrorMisalignedAddress;
  TcArgs a = tc_args(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K);
  a.xg = xg;
  a.wg = wg;
  a.pstride = NP == 2 ? words_between(w0, w1) : 0;
  a.xpstride = NP == 2 ? words_between(x0, x1) : 0;
  const int kw = K / 32;
  a.xvec = kw % 4 == 0 && a.xpstride % 4 == 0 && xa % 16 == 0 && xg % 16 == 0;
  a.wvec = kw % 4 == 0 && a.pstride % 4 == 0 && wa % 16 == 0 && wg % 16 == 0;
  return M <= G_SMALL_M ? launch_pop_mma<NP, 16>(a, groups, stream)
                        : launch_pop_mma<NP, P_BM>(a, groups, stream);
}

}  // namespace

// body: one of the BODY_* constants. x1/w1 are the sign planes of trit
// operands (NULL otherwise); w_scale/a_scale/bias may be NULL (identity).
// K: the contraction length in elements (a multiple of every side's
// storage unit; the wrapper checks). w_planes / w_plane_stride: the live
// planes P (1 <= P <= the body's BITS) of a plane-stacked weight and the
// words between two planes; ignored by the other bodies. The int8 (K1),
// mxu (K7), wt-i8a (K8), s4 (K9) and plane (K10) bodies run their
// streaming kernel up to SMALL_M rows and their tensor-core kernel above;
// the plane bodies' and K8's activation rows must be 16-byte aligned, K1's
// and K9's operands 4-byte aligned.
// ws / ws_ints: a zeroed int32 scratch of ws_ints ints for K1's split of K
// across blocks; the kernel leaves it zeroed. Launches on one stream may
// share it, launches on two streams may not.
extern "C" int repro_gemm(int body, const void* x0, const void* x1,
                          const void* w0, const void* w1, const float* w_scale,
                          const float* a_scale, const float* bias, void* out,
                          int out_acc, int M, int N, int K, int w_planes,
                          long long w_plane_stride, int* ws, long long ws_ints,
                          cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  switch (body) {
    case BODY_PLANES_W4:
      return launch_planes<4>(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K,
                              w_planes, w_plane_stride, stream);
    case BODY_PLANES_W8:
      return launch_planes<8>(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K,
                              w_planes, w_plane_stride, stream);
    case BODY_I8:
      return launch_i8(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K, ws,
                       ws_ints, stream);
    case BODY_INT4_W_I8A:
      return launch_s4(x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K, stream);
    case BODY_BINARY_MXU:
      return launch_mxu<1>(x0, x1, w0, w1, w_scale, a_scale, bias, out, out_acc, M, N, K,
                           stream);
    case BODY_TERNARY_MXU:
      return launch_mxu<2>(x0, x1, w0, w1, w_scale, a_scale, bias, out, out_acc, M, N, K,
                           stream);
    case BODY_TERNARY_W_I8A:
      return launch_wt(x0, w0, w1, w_scale, a_scale, bias, out, out_acc, M, N, K, stream);
    case BODY_BINARY:
      return launch_pop<1>(x0, x1, w0, w1, w_scale, a_scale, bias, out, out_acc, M, N, K,
                           stream);
    case BODY_TERNARY:
      return launch_pop<2>(x0, x1, w0, w1, w_scale, a_scale, bias, out, out_acc, M, N, K,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K11: `groups` GEMMs of one (M, N, K) shape in one launch. Every operand
// has a leading group axis: x0/x1 and w0/w1 advance by x_group_words /
// w_group_words 32-bit words from one group to the next, w_scale and bias
// by N floats, a_scale by M floats, out by M * N elements. w_planes /
// w_plane_stride: the live planes P of a plane-stacked weight (G, P, N,
// K/32) and the words between two planes of a member (ignored by the other
// bodies); the member stride may exceed P planes (a leading-P slice of a
// deeper stack). Every body runs its tensor-core tile: the int8 tiles, or
// for the popcount bodies (K3, K4) the b1 tile.
extern "C" int repro_gemm_grouped(int body, int groups, const void* x0,
                                  const void* x1, const void* w0,
                                  const void* w1, const float* w_scale,
                                  const float* a_scale, const float* bias,
                                  void* out, int out_acc, int M, int N, int K,
                                  long long x_group_words,
                                  long long w_group_words, int w_planes,
                                  long long w_plane_stride,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || groups <= 0 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (body == BODY_PLANES_W4 || body == BODY_PLANES_W8) {
    if (w_group_words < (long long)w_planes * w_plane_stride)
      return (int)cudaErrorInvalidValue;
    return (body == BODY_PLANES_W4 ? launch_grouped_planes<4> : launch_grouped_planes<8>)(
        groups, x0, w0, w_scale, a_scale, bias, out, out_acc, M, N, K, w_planes,
        w_plane_stride, 4 * x_group_words, 4 * w_group_words, stream);
  }
  const long long xg = 4 * x_group_words, wg = 4 * w_group_words;
  switch (body) {
    case BODY_I8:
    case BODY_INT4_W_I8A:
      return launch_grouped_tc(body, groups, x0, w0, w_scale, a_scale, bias, out,
                               out_acc, M, N, K, xg, wg, stream);
    case BODY_BINARY_MXU:
      return launch_grouped_bits<WK_BITS>(groups, x0, x1, w0, w1, w_scale, a_scale, bias,
                                          out, out_acc, M, N, K, xg, wg, stream);
    case BODY_TERNARY_MXU:
      return launch_grouped_bits<WK_TRITS>(groups, x0, x1, w0, w1, w_scale, a_scale,
                                           bias, out, out_acc, M, N, K, xg, wg, stream);
    case BODY_TERNARY_W_I8A:
      return launch_grouped_bits<WK_WT>(groups, x0, x1, w0, w1, w_scale, a_scale, bias,
                                        out, out_acc, M, N, K, xg, wg, stream);
    case BODY_BINARY:
      return launch_grouped_pop<1>(groups, x0, x1, w0, w1, w_scale, a_scale, bias, out,
                                   out_acc, M, N, K, xg, wg, stream);
    case BODY_TERNARY:
      return launch_grouped_pop<2>(groups, x0, x1, w0, w1, w_scale, a_scale, bias, out,
                                   out_acc, M, N, K, xg, wg, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
