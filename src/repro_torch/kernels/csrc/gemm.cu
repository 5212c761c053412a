// Output-stationary packed GEMM with a fused requant epilogue: one template,
// the MAC body a compile-time parameter.
//
// Replaces the TPU kernel `repro/kernels/harness.py` `gemm` + `_kernel`
// (one pallas_call skeleton) with three of its MacBodies:
//   BODY_I8      `repro/kernels/i8gemm.py`  `_i8_step`        (I8_DOT)
//   BODY_BINARY  `repro/kernels/bgemm.py`   `_popcount_step`  (BINARY_POPCOUNT)
//   BODY_TERNARY `repro/kernels/tgemm.py`   `_popcount_step`  (TERNARY_POPCOUNT)
//
// What it computes, for an (M, N) output:
//   dot[m, n] = finish(sum over K of mac(x[m, k], w[n, k]))   (int32, exact)
//   out       = ((float)dot * w_scale[n]) * a_scale[m] + bias[n]  -> bf16
// or the raw int32 dot when out_acc != 0 (the reference's out="acc").
//
// Storage: every operand row is a run of 32-bit words. Binary/ternary rows
// are K/32 packed words (bit k of word j = operand 32j+k; ternary has two
// planes, mask and sign). int8 activations are (M, K) codes read four to a
// word; int8 weights are K-major (K, N) codes, which the tile load turns
// into words of four consecutive k per column so that one __dp4a does four
// MACs. KW below is the word count of one activation row.
//
// Design. The TPU grid's sequential K axis becomes a loop inside the block:
// a block owns one BM x BN output tile, walks K in KT-word tiles staged
// through shared memory, and keeps its int32 accumulators in registers.
// Each warp owns one output column per lane and rows warp, warp+4, ... of
// the tile; rows past M are skipped warp-uniformly and columns past N are
// masked, so ragged M and N need no padding (the Pallas path pads M to 8).
//
// Bound. At decode (M = 4..32 rows) every weight word is used by only M
// rows, so the kernel is bound by the bytes of the packed weights (1, 2 or
// 8 bits per weight), far below the integer-op roof. This first version
// coalesces the weight loads and keeps the tile small (BN = 32) so that the
// N/32 blocks spread over all SMs; it does not yet pipeline the loads
// (cp.async/TMA) or use the int8 tensor cores (mma/wgmma) — later work.
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
constexpr int KT = 32;        // K tile, in 32-bit words
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = BM / WARPS;  // rows per thread

enum { BODY_I8 = 0, BODY_BINARY = 1, BODY_TERNARY = 2 };

template <int BODY> struct Body;

template <> struct Body<BODY_BINARY> {
  static constexpr int NX = 1, NW = 1, NACC = 1;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    acc[0] += __popc(x[0] ^ w[0]);                 // mismatches
  }
  __device__ static int finish(const int* acc, int k) { return k - 2 * acc[0]; }
};

template <> struct Body<BODY_TERNARY> {
  static constexpr int NX = 2, NW = 2, NACC = 2;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    const uint32_t active = x[0] & w[0];           // both trits non-zero
    acc[0] += __popc(active);
    acc[1] += __popc(active & (x[1] ^ w[1]));      // signs disagree
  }
  __device__ static int finish(const int* acc, int) { return acc[0] - 2 * acc[1]; }
};

template <> struct Body<BODY_I8> {
  static constexpr int NX = 1, NW = 1, NACC = 1;
  __device__ static void mac(int* acc, const uint32_t* x, const uint32_t* w) {
    acc[0] = __dp4a(static_cast<int>(x[0]), static_cast<int>(w[0]), acc[0]);
  }
  __device__ static int finish(const int* acc, int) { return acc[0]; }
};

template <int BODY>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
            const uint32_t* __restrict__ w0, const uint32_t* __restrict__ w1,
            const float* __restrict__ w_scale, const float* __restrict__ a_scale,
            const float* __restrict__ bias, void* __restrict__ out, int out_acc,
            int M, int N, int KW, int k_total) {
  using B = Body<BODY>;
  // +1 word of padding: lane-strided reads of ws hit 32 distinct banks
  __shared__ uint32_t xs[B::NX][BM][KT + 1];
  __shared__ uint32_t ws[B::NW][BN][KT + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const uint32_t* xp[2] = {x0, x1};
  const uint32_t* wp[2] = {w0, w1};

  int acc[RPT][B::NACC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int a = 0; a < B::NACC; ++a) acc[i][a] = 0;

  for (int kw0 = 0; kw0 < KW; kw0 += KT) {
    // activation tile: BM rows x KT words, zero past M and past K (a zero
    // word adds nothing to any body: no mismatch, no active trit, 0 * w)
    for (int i = tid; i < BM * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, kw = kw0 + c;
      const bool ok = r < rows && kw < KW;
#pragma unroll
      for (int p = 0; p < B::NX; ++p)
        xs[p][r][c] = ok ? xp[p][(size_t)(m0 + r) * KW + kw] : 0u;
    }
    if constexpr (BODY == BODY_I8) {
      // K-major (K, N) int8 weights: load 4 columns of one k row as a word
      // (coalesced along N) and scatter its bytes so that ws[0][n][c] holds
      // k = 4(kw0+c) .. 4(kw0+c)+3 of column n, little-endian like x.
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(w0);
      uint8_t* dst = reinterpret_cast<uint8_t*>(&ws[0][0][0]);
      for (int i = tid; i < 4 * KT * (BN / 4); i += THREADS) {
        const int kr = i / (BN / 4), cw = i % (BN / 4);
        const int k = 4 * kw0 + kr, n = n0 + 4 * cw;
        uint32_t v = 0;
        if (k < 4 * KW && n < N)
          v = *reinterpret_cast<const uint32_t*>(wb + (size_t)k * N + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[(4 * cw + j) * (KT + 1) * 4 + kr] = static_cast<uint8_t>(v >> (8 * j));
      }
    } else {
      // (N, KW) packed weight words, coalesced along K
      for (int i = tid; i < BN * KT; i += THREADS) {
        const int r = i / KT, c = i % KT, n = n0 + r, kw = kw0 + c;
        const bool ok = n < N && kw < KW;
#pragma unroll
        for (int p = 0; p < B::NW; ++p)
          ws[p][r][c] = ok ? wp[p][(size_t)n * KW + kw] : 0u;
      }
    }
    __syncthreads();

    const int kt = min(KT, KW - kw0);
    for (int c = 0; c < kt; ++c) {
      uint32_t wv[B::NW];
#pragma unroll
      for (int p = 0; p < B::NW; ++p) wv[p] = ws[p][lane][c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = warp + i * WARPS;
        if (r < rows) {                         // warp-uniform
          uint32_t xv[B::NX];
#pragma unroll
          for (int p = 0; p < B::NX; ++p) xv[p] = xs[p][r][c];
          B::mac(acc[i], xv, wv);
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
    const int dot = B::finish(acc[i], k_total);
    if (out_acc) {
      static_cast<int*>(out)[(size_t)m * N + n] = dot;
    } else {
      float y = __int2float_rn(dot);
      if (w_scale) y = __fmul_rn(y, w_scale[n]);
      if (a_scale) y = __fmul_rn(y, a_scale[m]);
      if (bias) y = __fadd_rn(y, bias[n]);
      static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16_rn(y);
    }
  }
}

}  // namespace

extern "C" void repro_gemm_tile(int* bm, int* bn, int* kt) {
  *bm = BM;
  *bn = BN;
  *kt = KT;
}

// body: BODY_I8 | BODY_BINARY | BODY_TERNARY. x1/w1 are the second planes of
// the ternary body (NULL otherwise); w_scale/a_scale/bias may be NULL
// (identity). KW: 32-bit words per activation row (K/32 packed, K/4 int8).
extern "C" int repro_gemm(int body, const void* x0, const void* x1,
                          const void* w0, const void* w1, const float* w_scale,
                          const float* a_scale, const float* bias, void* out,
                          int out_acc, int M, int N, int KW, int k_total,
                          cudaStream_t stream) {
  if (M <= 0 || N <= 0 || KW <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* a0 = static_cast<const uint32_t*>(x0);
  const auto* a1 = static_cast<const uint32_t*>(x1);
  const auto* b0 = static_cast<const uint32_t*>(w0);
  const auto* b1 = static_cast<const uint32_t*>(w1);
  switch (body) {
    case BODY_I8:
      gemm_kernel<BODY_I8><<<grid, THREADS, 0, stream>>>(
          a0, a1, b0, b1, w_scale, a_scale, bias, out, out_acc, M, N, KW, k_total);
      break;
    case BODY_BINARY:
      gemm_kernel<BODY_BINARY><<<grid, THREADS, 0, stream>>>(
          a0, a1, b0, b1, w_scale, a_scale, bias, out, out_acc, M, N, KW, k_total);
      break;
    case BODY_TERNARY:
      gemm_kernel<BODY_TERNARY><<<grid, THREADS, 0, stream>>>(
          a0, a1, b0, b1, w_scale, a_scale, bias, out, out_acc, M, N, KW, k_total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
