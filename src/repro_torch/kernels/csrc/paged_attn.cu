// Paged flash-decode: one-token GQA attention through the page table.
//
// Replaces the TPU kernel `repro/kernels/paged_attn.py`
// `paged_flash_decode` + `_paged_decode_kernel`.
//
// What it computes, for slot b and query head h (kv head h / G, G = Hq/Hk):
//   s_t  = <q[b, h], dequant(K[pages[b, t / P], t % P, h / G])> * scale
//   out  = sum_t softmax(s)_t * dequant(V[...])     over t = 0 .. pos[b]
// The new token's K/V are already in the pool (the caller writes first).
// Table entries past the slot's length point at the scratch page 0; the
// walk never reaches them, which is the reference's `tok <= pos` mask and
// its early page bound in one.
//
// Design. One block per (slot, kv head): the G query heads of one GQA group
// share every K/V row the block reads, so each K/V byte is read once. The
// block reads its own page-table row and positions from device memory (the
// TPU kernel's scalar prefetch). Its 4 warps take tokens round-robin; a
// warp reads one token's K row (dh values, contiguous per lane) for all G
// heads, reduces the G dot products with shuffles, and folds the token into
// per-warp online-softmax state m, l, acc in f32. int8 codes are
// dequantized at kv_scale and rounded to the query dtype, as the
// reference's `_kv_dequant` does. At the end the warps' states are merged
// through shared memory and out = acc / max(l, 1e-20).
//
// Bound. Decode attention reads each live K/V byte once and does ~4 flops
// per byte: it is bound by memory bytes. With 4 slots and 8 kv heads the
// grid is only 32 blocks, so this first version does not fill the card at
// the serve path's sizes; splitting the token range over more blocks
// (split-K with a merge pass) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;  // query heads per kv head
constexpr int MAXE = 8;  // head-dim elements per lane (dh <= 256)
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename QT> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one pool element as f32: int8 codes dequantized at kv_scale and rounded
// to the query dtype (the reference's `_kv_dequant`), other dtypes as is
template <typename QT, typename KVT>
__device__ __forceinline__ float load_kv(const KVT* p, float kv_scale) {
  if constexpr (std::is_same<KVT, int8_t>::value)
    return round_to<QT>(static_cast<float>(*p) * kv_scale);
  else
    return to_f32(*p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool, const int* __restrict__ pages,
                    const int* __restrict__ pos, QT* __restrict__ out,
                    int max_pages, int page_size, int hq, int hk, int dh,
                    float scale, float kv_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = hq / hk, epl = dh / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * epl;                     // this lane's dims d0 .. d0+epl-1

  float qv[MAXG][MAXE], acc[MAXG][MAXE], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = (g < G && e < epl)
          ? to_f32(q[((size_t)b * hq + h * G + g) * dh + d0 + e]) : 0.f;
    }
  }

  const int last = min(pos[b], max_pages * page_size - 1);
  const int* row = pages + (size_t)b * max_pages;
  for (int t = warp; t <= last; t += WARPS) {
    const int page = row[t / page_size];
    const size_t base = (((size_t)page * page_size + t % page_size) * hk + h) * dh + d0;
    float kf[MAXE], vf[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      kf[e] = e < epl ? load_kv<QT>(k_pool + base + e, kv_scale) : 0.f;
      vf[e] = e < epl ? load_kv<QT>(v_pool + base + e, kv_scale) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) s += qv[g][e] * kf[e];
      s = warp_sum(s) * scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
      m[g] = m_new;
    }
  }

  // merge the warps' online-softmax states
  float* sm_m = smem;                     // [WARPS][G]
  float* sm_l = sm_m + WARPS * G;         // [WARPS][G]
  float* sm_a = sm_l + WARPS * G;         // [WARPS][G][dh]
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < MAXE; ++e)
      if (e < epl) sm_a[(warp * G + g) * dh + d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += THREADS) {
    const int g = i / dh, d = i % dh;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * c;
      a += sm_a[(w * G + g) * dh + d] * c;
    }
    store(out + ((size_t)b * hq + h * G + g) * dh + d, a / fmaxf(lsum, 1e-20f));
  }
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* pages,
           const int* pos, void* out, int B, int max_pages, int page_size, int hq,
           int hk, int dh, float scale, float kv_scale, cudaStream_t stream) {
  const dim3 grid(B, hk);
  const size_t smem = sizeof(float) * WARPS * (hq / hk) * (2 + dh);
  paged_decode_kernel<QT, KVT><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), pages, pos, static_cast<QT*>(out),
      max_pages, page_size, hq, hk, dh, scale, kv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out: (B, Hq, dh) of q_dtype (DT_F32 | DT_BF16); pools: (num_pages,
// page_size, Hk, dh) of kv_dtype (the q dtype, or DT_I8 codes at kv_scale);
// pages: (B, max_pages) int32; pos: (B,) int32.
extern "C" int repro_paged_decode(int q_dtype, int kv_dtype, const void* q,
                                  const void* k_pool, const void* v_pool,
                                  const int* pages, const int* pos, void* out,
                                  int B, int max_pages, int page_size, int hq,
                                  int hk, int dh, float scale, float kv_scale,
                                  cudaStream_t stream) {
  if (B <= 0 || hk <= 0 || hq % hk || hq / hk > MAXG || dh % 32 || dh / 32 > MAXE)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, pages, pos, out, B,
        max_pages, page_size, hq, hk, dh, scale, kv_scale, stream);
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, pages, pos, out, B,
        max_pages, page_size, hq, hk, dh, scale, kv_scale, stream);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch<float, float>(q, k_pool, v_pool, pages, pos, out, B,
        max_pages, page_size, hq, hk, dh, scale, kv_scale, stream);
  if (q_dtype == DT_F32 && kv_dtype == DT_I8)
    return launch<float, int8_t>(q, k_pool, v_pool, pages, pos, out, B,
        max_pages, page_size, hq, hk, dh, scale, kv_scale, stream);
  return (int)cudaErrorInvalidValue;
}
