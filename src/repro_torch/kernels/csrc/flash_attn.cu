// Causal GQA flash attention for prefill: online softmax over KV tiles.
//
// Replaces the TPU kernel `repro/kernels/flash_attn.py` `flash_attention` +
// `_flash_kernel` (one pallas_call, grid (BH, nq, nk)).
//
// What it computes, per query head h (kv head h / G) and query row t:
//   s[j]  = (q[t] . k[j]) * scale            (f32, scale = 1/sqrt(dh))
//   s[j]  = -1e30 where causal and j > t      (the reference's NEG_INF)
//   online over KV tiles:  m' = max(m, max s); p = exp(s - m');
//                          c = exp(m - m');   l' = l * c + sum p;
//                          acc' = acc * c + round_v(p) . v
//   out[t] = acc / max(l, 1e-20)              -> q's dtype
// round_v rounds p to v's dtype before the PV product, as the reference
// does (`p.astype(v.dtype)`); m, l and acc stay f32.
//
// Layout: q (B, H, Tq, dh), k/v (B, Hk, Tk, dh), out (B, H, Tq, dh), each
// through its own strides with dh contiguous, so the caller passes views of
// its (B, T, H, dh) activations and no transposed copy is made.
//
// Design. The TPU grid's sequential KV axis becomes a loop inside the
// block. One block of 128 threads owns one (b, h, 64-row query tile); each
// warp owns 16 query rows, each lane two of the 64 columns of a KV tile for
// the scores and dh/32 output columns of the PV product, so softmax row
// reductions are warp shuffles and no block-wide reduction is needed. Q, K,
// V and P tiles are staged in f32 in (dynamic) shared memory, rows padded
// by one word so lane-strided reads hit distinct banks. The walk stops at
// the causal edge: the reference iterates fully masked tiles too, but there
// p = exp(-1e30 - m) = 0 and c = 1, so they change nothing.
//
// Bound. At the serve path's prefill (T = 256, 24/8 heads, dh = 128) one
// layer moves ~4.2 MB of bf16 q/k/v/out (1.3 us at 3.35 TB/s) and does
// ~0.4 GFLOP in its causal half (0.4 us on the bf16 tensor cores), so bytes
// bound it. This first version is far from both: it does its MACs in f32 on
// the CUDA cores (no mma/wgmma) with both operands read from shared memory,
// which bounds it; the tensor-core version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // KV rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = BQ / (THREADS / 32);  // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Hk,
             int Tq, int Tk, long long sqb, long long sqh, long long sqt,
             long long skb, long long skh, long long skt, long long svb,
             long long svh, long long svt, long long sob, long long soh,
             long long sot, int causal, float scale) {
  constexpr int DJ = DH / 32;                      // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                                // [BQ][DH + 1]
  float* Ks = Qs + BQ * (DH + 1);                  // [BK][DH + 1]
  float* Vs = Ks + BK * (DH + 1);                  // [BK][DH]
  float* Ps = Vs + BK * DH;                        // [BQ][BK + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + hk * skh;
  const T* vp = v + b * svb + hk * svh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = q0 + r;
    Qs[r * (DH + 1) + d] = t < Tq ? to_f(qp[t * sqt + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Tq) - 1) / BK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                               // previous tile consumed
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, t = k0 + r;
      Ks[r * (DH + 1) + d] = t < Tk ? to_f(kp[t * skt + d]) : 0.f;
      Vs[r * DH + d] = t < Tk ? to_f(vp[t * svt + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {               // unrolled: m, l, acc in registers
      const int r = warp * ROWS + i, tq = q0 + r;
      const float* qr = Qs + r * (DH + 1);
      const float* k0r = Ks + lane * (DH + 1);
      const float* k1r = Ks + (lane + 32) * (DH + 1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        s0 = fmaf(qr[d], k0r[d], s0);
        s1 = fmaf(qr[d], k1r[d], s1);
      }
      s0 *= scale;
      s1 *= scale;
      const int j0 = k0 + lane, j1 = k0 + lane + 32;
      if (j0 >= Tk || (causal && j0 > tq)) s0 = NEG_INF;
      if (j1 >= Tk || (causal && j1 > tq)) s1 = NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
      m[i] = m_new;
      Ps[r * (BK + 1) + lane] = round_to(p0, (T*)nullptr);
      Ps[r * (BK + 1) + lane + 32] = round_to(p1, (T*)nullptr);
      __syncwarp();
      const float* pr = Ps + r * (BK + 1);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < BK; ++c) a = fmaf(pr[c], Vs[c * DH + lane + 32 * j], a);
        acc[i][j] = acc[i][j] * corr + a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int t = q0 + warp * ROWS + i;
    if (t >= Tq) continue;
    const float inv = fmaxf(l[i], 1e-20f);
    T* op = out + b * sob + h * soh + t * sot;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(op + lane + 32 * j, acc[i][j] / inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hk, int Tq, int Tk, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hk, Tq, Tk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int B, int H, int Hk, int Tq, int Tk, const long long* st,
              int causal, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, Hk, Tq, Tk, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Hk, Tq, Tk, st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Hk, Tq, Tk, st, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). strides: 12
// element strides (b, h, t) of q, k, v, out in that order; dh is contiguous.
extern "C" int repro_flash_attn(int dtype, const void* q, const void* k,
                                const void* v, void* out, int B, int H, int Hk,
                                int Tq, int Tk, int dh, const long long* strides,
                                int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, out, B, H, Hk, Tq, Tk, strides, causal,
                            scale, stream);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, H, Hk, Tq, Tk, strides,
                                    causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}
