// Output-stationary packed GEMM with a fused requant epilogue: one template,
// the MAC body a compile-time parameter.
//
// Replaces the TPU kernels `repro/kernels/harness.py` `gemm` + `_kernel`
// (one pallas_call skeleton) with nine of its MacBodies, and `gemm_grouped`
// (the same call vmapped over a leading group axis, K11) through a second
// entry point, `repro_gemm_grouped`, over the bodies below except the two
// plane bodies:
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
//   F_I8        (R, K) int8 codes, read four to a word (K/4 words per row)
//   F_I8_KMAJOR (K, N) int8 weight codes
//   F_BITS      K/32 words, bit k of word j = operand 32j+k (1 encodes +1)
//   F_TRITS     two F_BITS planes, mask (non-zero) and sign (negative)
//   F_S4        K/8 words, nibble j of word i = s4 code 8i+j
//   F_PLANES    a stack of P <= BITS binary planes (P, N, K/32), MSB-first
//               two's complement: plane 0 is the sign plane (coefficient
//               -2^(BITS-1)), plane i has coefficient 2^(BITS-1-i); plane i
//               of row n starts at w0 + i * plane_stride + n * K/32
// The two sides of a body may differ (the mixed bodies: int8 codes against
// trit planes or s4 nibbles), so each side is staged by its own density.
//
// MAC kinds. The popcount bodies work on packed words directly: XNOR sums
// __popc(x ^ w) mismatches (dot = K - 2 * mismatches), gated XNOR keeps
// active and disagree counts (dot = active - 2 * disagree). Every other
// body is a __dp4a body: each side is staged as words of four consecutive
// int8 values of k (little-endian, the byte order of an int8 activation
// row read as a word), so one __dp4a does four MACs. The tile load builds
// those words: int8 rows are copied; K-major int8 weights are transposed
// four columns at a time; bits, trits and nibbles are unpacked to ±1,
// {-1, 0, +1} and sign-extended s4 bytes; the P live plane words of a plane
// stack are composed into the codes sum_i coeff_i * bit_i (each fits an
// int8, truncated or not: a missing plane contributes 0), so the __dp4a
// loop's dot is integer-identical to the reference's per-plane sum
// sum_i coeff_i * (x . plane_i). The reference's MXU bodies dot the
// unpacked values in f32 and cast; this port takes the integer dot, which
// is the same number and equals the popcount bodies' dot bit for bit.
//
// Design. The TPU grid's sequential K axis becomes a loop inside the block:
// a block owns one BM x BN output tile, walks K in KT-word stages through
// shared memory (KT packed words = 1024 k for the popcount bodies, KT
// four-code words = 128 k for the __dp4a bodies), and keeps its int32
// accumulators in registers. Each warp owns one output column per lane and
// rows warp, warp+4, ... of the tile; rows past M are skipped warp-uniformly
// and columns past N are masked, so ragged M and N need no padding (the
// Pallas path pads M to 8).
//
// Bound. At decode (M = 4..32 rows) every weight word is used by only M
// rows, so the kernel is bound by the bytes of the packed weights (1, 2, 4
// or 8 bits per weight), far below the integer-op roof. This first version
// coalesces the weight loads and keeps the tile small (BN = 32) so that the
// N/32 blocks spread over all SMs; it does not yet pipeline the loads
// (cp.async/TMA) or use the int8 tensor cores (mma/wgmma) — later work.
//
// Groups (K11). `repro_gemm_grouped` runs G independent GEMMs of one shape
// in one launch, the grid's third dimension over the groups: every operand
// carries a leading G axis (x (G, M, .), w (G, N, .) or (G, K, N), w_scale
// and bias (G, N), a_scale (G, M), out (G, M, N)), and a block offsets each
// pointer by its group's stride and runs the unchanged body and epilogue.
// An ungrouped launch is the one-group case. The MoE expert projections are
// G = E weight stacks at decode M = slots x capacity (16 for 4 slots): the
// same weight-byte bound, summed over the experts, with E times the blocks
// of one expert's GEMM in flight.
//
// Exactness. The epilogue keeps the reference's order exactly and uses
// __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA, and rounds
// with __float2bfloat16_rn, so the bf16 output is bit-equal to
// `harness.requant` on the same int32 dot and scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // output rows per block
constexpr int BN = 32;        // output columns per block (one per lane)
constexpr int KT = 32;        // K stage, in 32-bit staged words
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = BM / WARPS;  // rows per thread

enum { BODY_I8 = 0, BODY_BINARY = 1, BODY_TERNARY = 2, BODY_BINARY_MXU = 3,
       BODY_TERNARY_MXU = 4, BODY_TERNARY_W_I8A = 5, BODY_INT4_W_I8A = 6,
       BODY_PLANES_W4 = 7, BODY_PLANES_W8 = 8 };
enum { F_I8, F_I8_KMAJOR, F_BITS, F_TRITS, F_S4, F_PLANES };
enum { MAC_XNOR, MAC_GXNOR, MAC_DP4A };

template <int MAC> struct Mac;

template <> struct Mac<MAC_XNOR> {
  static constexpr int PLANES = 1, NACC = 1, K_PER_WORD = 32;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    acc[0] += __popc(x[0] ^ w[0]);                 // mismatches
  }
  __device__ static int finish(const int* acc, int k) { return k - 2 * acc[0]; }
};

template <> struct Mac<MAC_GXNOR> {
  static constexpr int PLANES = 2, NACC = 2, K_PER_WORD = 32;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    const uint32_t active = x[0] & w[0];           // both trits non-zero
    acc[0] += __popc(active);
    acc[1] += __popc(active & (x[1] ^ w[1]));      // signs disagree
  }
  __device__ static int finish(const int* acc, int) { return acc[0] - 2 * acc[1]; }
};

template <> struct Mac<MAC_DP4A> {
  static constexpr int PLANES = 1, NACC = 1, K_PER_WORD = 4;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    acc[0] = __dp4a(static_cast<int>(x[0]), static_cast<int>(w[0]), acc[0]);
  }
  __device__ static int finish(const int* acc, int) { return acc[0]; }
};

// BITS: planes of a full F_PLANES weight stack (0 for the other formats)
template <int BODY> struct Body;
template <> struct Body<BODY_I8>            { static constexpr int XF = F_I8,    WF = F_I8_KMAJOR, MAC = MAC_DP4A,  BITS = 0; };
template <> struct Body<BODY_BINARY>        { static constexpr int XF = F_BITS,  WF = F_BITS,      MAC = MAC_XNOR,  BITS = 0; };
template <> struct Body<BODY_TERNARY>       { static constexpr int XF = F_TRITS, WF = F_TRITS,     MAC = MAC_GXNOR, BITS = 0; };
template <> struct Body<BODY_BINARY_MXU>    { static constexpr int XF = F_BITS,  WF = F_BITS,      MAC = MAC_DP4A,  BITS = 0; };
template <> struct Body<BODY_TERNARY_MXU>   { static constexpr int XF = F_TRITS, WF = F_TRITS,     MAC = MAC_DP4A,  BITS = 0; };
template <> struct Body<BODY_TERNARY_W_I8A> { static constexpr int XF = F_I8,    WF = F_TRITS,     MAC = MAC_DP4A,  BITS = 0; };
template <> struct Body<BODY_INT4_W_I8A>    { static constexpr int XF = F_I8,    WF = F_S4,        MAC = MAC_DP4A,  BITS = 0; };
template <> struct Body<BODY_PLANES_W4>     { static constexpr int XF = F_I8,    WF = F_PLANES,    MAC = MAC_DP4A,  BITS = 4; };
template <> struct Body<BODY_PLANES_W8>     { static constexpr int XF = F_I8,    WF = F_PLANES,    MAC = MAC_DP4A,  BITS = 8; };

// K elements per stored 32-bit word of a (row-major) format
template <int F> struct Fmt { static constexpr int K_PER_WORD = F == F_S4 ? 8 : F == F_I8 ? 4 : 32; };

// Bytes b0..b3 (each the low 8 bits of an int) as one little-endian word.
__device__ __forceinline__ uint32_t word4(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xFF) | ((uint32_t)(b1 & 0xFF) << 8) |
         ((uint32_t)(b2 & 0xFF) << 16) | ((uint32_t)(b3 & 0xFF) << 24);
}

// Four ±1 int8 values from four bits (1 encodes +1).
__device__ __forceinline__ uint32_t unpack_bits4(uint32_t b) {
  return word4((b & 1) ? 1 : -1, (b & 2) ? 1 : -1, (b & 4) ? 1 : -1, (b & 8) ? 1 : -1);
}

// Four trits {-1, 0, +1} as int8 from four mask bits and four sign bits.
__device__ __forceinline__ uint32_t unpack_trits4(uint32_t m, uint32_t s) {
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = ((m >> i) & 1) ? (((s >> i) & 1) ? -1 : 1) : 0;
  return word4(v[0], v[1], v[2], v[3]);
}

// Four sign-extended s4 codes from the low 16 bits of `nib`.
__device__ __forceinline__ uint32_t unpack_s4x4(uint32_t nib) {
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (nib >> (4 * i)) & 0xF;
    v[i] = c >= 8 ? c - 16 : c;
  }
  return word4(v[0], v[1], v[2], v[3]);
}

// Four bits of a word (its low nibble) spread to the low bit of four bytes.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return ((nib & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Four int8 codes, bits sh..sh+3 of each plane word composed as
// sum_i coeff_i * bit_i. Byte-wise: the sign plane adds -2^(BITS-1) mod 256
// (0x80 for 8 bits, 0xF8 = -8 for 4 bits: the sign-extended byte), plane i
// sets bit BITS-1-i; the fields are disjoint, so no carry crosses a byte.
// A truncated stack's missing planes are zero words and add nothing.
template <int BITS>
__device__ __forceinline__ uint32_t compose_planes4(const uint32_t* pw, int sh) {
  constexpr uint32_t SIGN = (0x100u - (1u << (BITS - 1))) & 0xFFu;
  uint32_t v = spread4(pw[0] >> sh) * SIGN;
#pragma unroll
  for (int i = 1; i < BITS; ++i) v |= spread4(pw[i] >> sh) << (BITS - 1 - i);
  return v;
}

// Stage words ku0 .. ku0+KT-1 (in the MAC's units) of rows r0 .. r0+R-1 of
// one operand into dst[plane][row][word]. Rows past `nrows` and words past
// K are zero: they are never read by the MAC loop (it stops at K) and a zero
// row only feeds outputs that are never written. For F_PLANES, `np` live
// planes of BITS lie `pstride` words apart.
template <int F, int MAC, int P, int R, int BITS = 0>
__device__ __forceinline__ void stage_rows(uint32_t (*dst)[R][KT + 1],
                                           const uint32_t* s0, const uint32_t* s1,
                                           int r0, int nrows, int ku0, int K,
                                           int tid, int np = 0,
                                           long long pstride = 0) {
  constexpr int KPW = Fmt<F>::K_PER_WORD;          // k per source word
  constexpr int KPU = Mac<MAC>::K_PER_WORD;        // k per staged word
  const int W = K / KPW;                           // source words per row
  if constexpr (KPW == KPU) {
    // copy: packed words for the popcount MACs, int8 rows for __dp4a
    for (int i = tid; i < R * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, kw = ku0 + c;
      const bool ok = r < nrows && kw < W;
      dst[0][r][c] = ok ? s0[(size_t)(r0 + r) * W + kw] : 0u;
      if constexpr (P > 1) dst[1][r][c] = ok ? s1[(size_t)(r0 + r) * W + kw] : 0u;
    }
  } else {
    // unpack: each source word becomes Q words of four int8 values
    constexpr int Q = KPW / KPU;
    constexpr int SW = KT / Q;                      // source words per stage
    for (int i = tid; i < R * SW; i += THREADS) {
      const int r = i / SW, c = i % SW, kw = ku0 / Q + c;
      const bool ok = r < nrows && kw < W;
      const size_t off = (size_t)(r0 + r) * W + kw;
      if constexpr (F == F_PLANES) {
        uint32_t pw[BITS];
#pragma unroll
        for (int i = 0; i < BITS; ++i)
          pw[i] = ok && i < np ? s0[(size_t)i * pstride + off] : 0u;
#pragma unroll
        for (int j = 0; j < Q; ++j)
          dst[0][r][c * Q + j] = ok ? compose_planes4<BITS>(pw, 4 * j) : 0u;
        continue;
      }
      const uint32_t a = ok ? s0[off] : 0u;
      uint32_t b = 0u;
      if constexpr (F == F_TRITS) b = ok ? s1[off] : 0u;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        uint32_t v;
        if constexpr (F == F_BITS) v = unpack_bits4(a >> (4 * j));
        else if constexpr (F == F_TRITS) v = unpack_trits4(a >> (4 * j), b >> (4 * j));
        else v = unpack_s4x4(a >> (16 * j));
        dst[0][r][c * Q + j] = ok ? v : 0u;
      }
    }
  }
}

// K-major (K, N) int8 weights: load 4 columns of one k row as a word
// (coalesced along N) and scatter its bytes so that dst[0][n][c] holds
// k = 4(ku0+c) .. 4(ku0+c)+3 of column n, little-endian like x.
__device__ __forceinline__ void stage_kmajor(uint32_t (*dst)[BN][KT + 1],
                                             const uint32_t* w, int n0, int N,
                                             int ku0, int K, int tid) {
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  uint8_t* d = reinterpret_cast<uint8_t*>(&dst[0][0][0]);
  for (int i = tid; i < 4 * KT * (BN / 4); i += THREADS) {
    const int kr = i / (BN / 4), cw = i % (BN / 4);
    const int k = 4 * ku0 + kr, n = n0 + 4 * cw;
    uint32_t v = 0;
    if (k < K && n < N) v = *reinterpret_cast<const uint32_t*>(wb + (size_t)k * N + n);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[(4 * cw + j) * (KT + 1) * 4 + kr] = static_cast<uint8_t>(v >> (8 * j));
  }
}

template <int BODY>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
            const uint32_t* __restrict__ w0, const uint32_t* __restrict__ w1,
            const float* __restrict__ w_scale, const float* __restrict__ a_scale,
            const float* __restrict__ bias, void* __restrict__ out, int out_acc,
            int M, int N, int K, int w_planes, long long w_plane_stride,
            long long x_group_words, long long w_group_words) {
  using B = Body<BODY>;
  using C = Mac<B::MAC>;
  // this block's group member: offset every operand by the group's stride
  const long long g = blockIdx.z;
  x0 += g * x_group_words;
  if (x1) x1 += g * x_group_words;
  w0 += g * w_group_words;
  if (w1) w1 += g * w_group_words;
  if (w_scale) w_scale += g * N;
  if (a_scale) a_scale += g * M;
  if (bias) bias += g * N;
  const size_t obase = (size_t)g * M * N;
  // +1 word of padding: lane-strided reads of ws hit 32 distinct banks
  __shared__ uint32_t xs[C::PLANES][BM][KT + 1];
  __shared__ uint32_t ws[C::PLANES][BN][KT + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int KU = K / C::K_PER_WORD;                // staged words per row

  int acc[RPT][C::NACC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int a = 0; a < C::NACC; ++a) acc[i][a] = 0;

  for (int ku0 = 0; ku0 < KU; ku0 += KT) {
    stage_rows<B::XF, B::MAC, C::PLANES, BM>(xs, x0, x1, m0, rows, ku0, K, tid);
    if constexpr (B::WF == F_I8_KMAJOR)
      stage_kmajor(ws, w0, n0, N, ku0, K, tid);
    else
      stage_rows<B::WF, B::MAC, C::PLANES, BN, B::BITS>(
          ws, w0, w1, n0, min(BN, N - n0), ku0, K, tid, w_planes, w_plane_stride);
    __syncthreads();

    const int kt = min(KT, KU - ku0);
    for (int c = 0; c < kt; ++c) {
      uint32_t wv[C::PLANES];
#pragma unroll
      for (int p = 0; p < C::PLANES; ++p) wv[p] = ws[p][lane][c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = warp + i * WARPS;
        if (r < rows) {                         // warp-uniform
          uint32_t xv[C::PLANES];
#pragma unroll
          for (int p = 0; p < C::PLANES; ++p) xv[p] = xs[p][r][c];
          C::mac(acc[i], xv, wv);
        }
      }
    }
    __syncthreads();
  }

  const int n = n0 + lane;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp + i * WARPS;
    if (r >= rows) continue;
    const int m = m0 + r;
    const int dot = C::finish(acc[i], K);
    if (out_acc) {
      static_cast<int*>(out)[obase + (size_t)m * N + n] = dot;
    } else {
      float y = __int2float_rn(dot);
      if (w_scale) y = __fmul_rn(y, w_scale[n]);
      if (a_scale) y = __fmul_rn(y, a_scale[m]);
      if (bias) y = __fadd_rn(y, bias[n]);
      static_cast<__nv_bfloat16*>(out)[obase + (size_t)m * N + n] = __float2bfloat16_rn(y);
    }
  }
}

}  // namespace

extern "C" void repro_gemm_tile(int* bm, int* bn, int* kt) {
  *bm = BM;
  *bn = BN;
  *kt = KT;
}

// One launch of `groups` GEMMs (groups = 1: the ungrouped call) on `stream`;
// returns the launch's cudaError_t.
static int launch(int body, int groups, const void* x0, const void* x1,
                  const void* w0, const void* w1, const float* w_scale,
                  const float* a_scale, const float* bias, void* out,
                  int out_acc, int M, int N, int K, int w_planes,
                  long long w_plane_stride, long long x_group_words,
                  long long w_group_words, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, groups);
  const auto* a0 = static_cast<const uint32_t*>(x0);
  const auto* a1 = static_cast<const uint32_t*>(x1);
  const auto* b0 = static_cast<const uint32_t*>(w0);
  const auto* b1 = static_cast<const uint32_t*>(w1);
#define LAUNCH(ID)                                                            \
  case ID:                                                                    \
    gemm_kernel<ID><<<grid, THREADS, 0, stream>>>(                            \
        a0, a1, b0, b1, w_scale, a_scale, bias, out, out_acc, M, N, K,        \
        w_planes, w_plane_stride, x_group_words, w_group_words);              \
    break;
  switch (body) {
    LAUNCH(BODY_I8)
    LAUNCH(BODY_BINARY)
    LAUNCH(BODY_TERNARY)
    LAUNCH(BODY_BINARY_MXU)
    LAUNCH(BODY_TERNARY_MXU)
    LAUNCH(BODY_TERNARY_W_I8A)
    LAUNCH(BODY_INT4_W_I8A)
    LAUNCH(BODY_PLANES_W4)
    LAUNCH(BODY_PLANES_W8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}

// body: one of the BODY_* constants. x1/w1 are the sign planes of trit
// operands (NULL otherwise); w_scale/a_scale/bias may be NULL (identity).
// K: the contraction length in elements (a multiple of every side's
// storage unit; the wrapper checks). w_planes / w_plane_stride: the live
// planes P (1 <= P <= the body's BITS) of a plane-stacked weight and the
// words between two planes; ignored by the other bodies.
extern "C" int repro_gemm(int body, const void* x0, const void* x1,
                          const void* w0, const void* w1, const float* w_scale,
                          const float* a_scale, const float* bias, void* out,
                          int out_acc, int M, int N, int K, int w_planes,
                          long long w_plane_stride, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((body == BODY_PLANES_W4 && (w_planes < 1 || w_planes > 4)) ||
      (body == BODY_PLANES_W8 && (w_planes < 1 || w_planes > 8)))
    return (int)cudaErrorInvalidValue;
  return launch(body, 1, x0, x1, w0, w1, w_scale, a_scale, bias, out, out_acc,
                M, N, K, w_planes, w_plane_stride, 0, 0, stream);
}

// K11: `groups` GEMMs of one (M, N, K) shape in one launch. Every operand is
// contiguous with a leading group axis: x0/x1 and w0/w1 advance by
// x_group_words / w_group_words 32-bit words from one group to the next,
// w_scale and bias by N floats, a_scale by M floats, out by M * N elements.
// The plane bodies are refused.
extern "C" int repro_gemm_grouped(int body, int groups, const void* x0,
                                  const void* x1, const void* w0,
                                  const void* w1, const float* w_scale,
                                  const float* a_scale, const float* bias,
                                  void* out, int out_acc, int M, int N, int K,
                                  long long x_group_words,
                                  long long w_group_words,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || groups <= 0 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (body == BODY_PLANES_W4 || body == BODY_PLANES_W8)
    return (int)cudaErrorInvalidValue;
  return launch(body, groups, x0, x1, w0, w1, w_scale, a_scale, bias, out,
                out_acc, M, N, K, 1, 0, x_group_words, w_group_words, stream);
}
