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
// its early page bound in one. int8 codes are dequantized at kv_scale and
// rounded to the query dtype, as the reference's `_kv_dequant` does.
//
// Design. Each (slot, kv head)'s tokens are cut into CHUNK = 64-token
// chunks at fixed positions (chunk c holds tokens 64c .. 64c+63), one block
// of 4 warps each: the grid is (chunks of the longest table, Hk, B), and a
// block whose chunk starts past pos[b] returns at once. The G query heads
// of the GQA group share every K/V row the block reads, so each K/V byte is
// read once. A block
//   1. loads pos[b] and the table entries its chunk may touch, together;
//   2. cp.async's the chunk's K rows, then its V rows, into shared memory,
//      16 bytes a copy and every copy in flight at once (V lands while the
//      scores are computed);
//   3. scores: L lanes a token (dh / 8 rounded up to a power of two: 16 at
//      dh = 128), 8 dims a lane, so a warp pass covers 32 / L tokens with
//      one 16-byte shared load a lane (bf16); the G query heads sit in
//      registers, G x 8 floats a lane, and each head's dot takes log2(L)
//      shuffles; the passes are unrolled, so no token waits on another's
//      reduction;
//   4. an exact softmax over the chunk (max, exp, sum), one warp a head;
//   5. acc = sum_t p_t V_t in the lane layout of 3, summed over the warp's
//      token slots by shuffles and over the warps in shared memory;
//   6. a row of one chunk stores out = acc / max(l, 1e-20). Otherwise the
//      block writes its partial (m, l, acc) to the workspace, and the last
//      of the row's chunks to finish (a ticket from an atomic counter, which
//      it resets to 0) merges the partials in chunk order: M = max_c m_c,
//      out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-20).
// Every sum runs in an order that the token positions alone fix, never B,
// max_pages or another row: a row's output is bit-identical in a launch of
// any batch, and a speculative verify row's equals the decode step's at the
// same position. No float is added through an atomic.
//
// Registers are sized to the head: the kernel is instantiated on G and dh
// for the served archs (llama3.2-3b G = 3, deepseek-moe-16b G = 1,
// phi3.5-moe G = 4, all dh = 128) and the reduced / test shapes (dh 32 and
// 64); any other G <= 8, dh <= 256 (dh % 32 == 0) runs the generic
// instantiation of the same kernel, whose arrays are sized to 8 x 8, and G =
// G_WIDE = 12 (nemotron-4-340b: 96 query heads over 8 kv heads, dh 192) an
// instantiation of its own with 12 heads in registers and the dh generic.
//
// Bound. Decode attention reads each live K/V byte once and does ~4 flops
// per byte: bytes bound it, ~2 MB a layer at the serve path's 4 slots
// (0.6 us at HBM rate), far under the launch floor (5-8 us). The design
// goes for latency: three dependent memory round trips (position and table,
// K/V, the merge's partials) and enough blocks to spread a layer over the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;  // tokens a block; the wrapper's paged_attn.CHUNK
constexpr int MAXG = 8;    // query heads per kv head (the generic kernel)
constexpr int G_WIDE = 12; // ... and the one wider group served
constexpr int MAXD = 8;    // head-dim elements per lane
constexpr int MAXDH = 256;
constexpr float NEG_INF = -1e30f;

enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

// lanes that share one token's row: 8 dims a lane, a power of two
__host__ __device__ constexpr int lanes_per_token(int dh) {
  int l = 1;
  while (l * MAXD < dh) l <<= 1;
  return l;
}

// dynamic shared memory: K and V tiles [CHUNK][dh], scores [G][CHUNK],
// warp partials [WARPS][G][dh], m and l [G], table entries [CHUNK + 1] and
// the merge flag
template <typename KVT>
__host__ __device__ constexpr size_t smem_bytes(int G, int dh) {
  return 2 * sizeof(KVT) * CHUNK * dh +
         sizeof(float) * (G * CHUNK + WARPS * G * dh + 2 * G) + sizeof(int) * (CHUNK + 2);
}

// partial floats of a launch: G * (dh + 2) per (slot, kv head, chunk)
inline long long part_need(int B, int hk, int chunks, int G, int dh) {
  return (long long)B * hk * chunks * G * (dh + 2);
}

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

// n (<= DM) consecutive staged K/V elements at p as f32. VEC8: n == 8 and
// p aligned to 8 elements, read with one 16-byte (bf16), two 16-byte (f32)
// or one 8-byte (int8) shared load.
template <typename QT, typename KVT, int DM, bool VEC8>
__device__ __forceinline__ void row_vals(const KVT* p, int n, float kv_scale, float* f) {
  if constexpr (VEC8) {
    static_assert(DM == 8, "8 dims a lane");
    if constexpr (std::is_same<KVT, __nv_bfloat16>::value) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else if constexpr (std::is_same<KVT, float>::value) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int code = static_cast<int8_t>((i < 4 ? v.x : v.y) >> (8 * (i & 3)));
        f[i] = round_to<QT>(static_cast<float>(code) * kv_scale);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < DM; ++e) f[e] = e < n ? load_kv<QT>(p + e, kv_scale) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// G_ / DH_: the instantiation's G and dh, or 0 for the generic kernel
template <typename QT, typename KVT, int G_, int DH_>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool, const int* __restrict__ pages,
                    const int* __restrict__ pos, QT* __restrict__ out, int max_pages,
                    int page_size, int hq, int hk, int dh, float scale, float kv_scale,
                    int* __restrict__ cnt, float* __restrict__ part) {
  constexpr int GM = G_ ? G_ : MAXG;                        // register heads
  constexpr int DM = DH_ ? DH_ / lanes_per_token(DH_) : MAXD;   // register dims
  static_assert(DH_ == 0 || DM == 8, "a specialised dh gives 8 dims a lane");
  if constexpr (DH_ != 0) dh = DH_;
  const int G = G_ ? G_ : hq / hk;
  const int L = DH_ ? lanes_per_token(DH_) : lanes_per_token(dh);
  const int D = DH_ ? DM : dh / L;                          // dims a lane
  const int T = 32 / L;                                     // tokens a warp pass
  const int passes = CHUNK / (WARPS * T);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = lane / L, seg = lane % L, d0 = seg * D;
  const int t0 = c * CHUNK;

  extern __shared__ __align__(16) unsigned char smem[];
  KVT* Ks = reinterpret_cast<KVT*>(smem);                   // [CHUNK][dh]
  KVT* Vs = Ks + CHUNK * dh;                                // [CHUNK][dh]
  float* sc = reinterpret_cast<float*>(Vs + CHUNK * dh);    // [G][CHUNK]
  float* red = sc + G * CHUNK;                              // [WARPS][G][dh]
  float* sm_m = red + WARPS * G * dh;                       // [G]
  float* sm_l = sm_m + G;                                   // [G]
  int* spg = reinterpret_cast<int*>(sm_l + G);              // [CHUNK + 1]
  int* last_block = spg + CHUNK + 1;

  // 1. the row's position and the table entries the chunk may touch
  const int* row = pages + (size_t)b * max_pages;
  const int pg0 = t0 / page_size, npg = (CHUNK - 1) / page_size + 2;
  const int posb = __ldg(pos + b);
  if (tid < npg && pg0 + tid < max_pages) spg[tid] = __ldg(row + pg0 + tid);
  const int last = min(posb, max_pages * page_size - 1);
  if (t0 > last) return;                                    // block-uniform
  const int nt = min(CHUNK, last + 1 - t0), nc = last / CHUNK + 1;
  float qv[GM][DM];
  {
    const QT* qh = q + ((size_t)b * hq + (size_t)h * G) * dh + d0;
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < DM; ++e)
        qv[g][e] = (g < G && e < D) ? to_f32(qh[g * dh + e]) : 0.f;
  }
  __syncthreads();

  // 2. K rows, then V rows, 16 bytes a copy
  {
    constexpr int VEC = 16 / sizeof(KVT);
    const int rp = dh / VEC;                                // pieces a row
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const KVT* pool = which ? v_pool : k_pool;
      KVT* dst = which ? Vs : Ks;
      for (int i = tid; i < nt * rp; i += THREADS) {
        const int j = i / rp, piece = i - j * rp, t = t0 + j;
        const int page = spg[t / page_size - pg0];
        cp_async16(dst + j * dh + piece * VEC,
                   pool + (((size_t)page * page_size + t % page_size) * hk + h) * dh +
                       piece * VEC,
                   16);
      }
      cp_async_commit();
    }
  }
  cp_async_wait<1>();                                       // K has landed
  __syncthreads();

  // 3. scores, L lanes a token
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int j = (p * WARPS + warp) * T + slot;
    float kf[DM];
    row_vals<QT, KVT, DM, DH_ != 0>(Ks + j * dh + d0, D, kv_scale, kf);
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      s[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DM; ++e) s[g] += qv[g][e] * kf[e];
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      for (int o = L / 2; o > 0; o >>= 1) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    if (seg == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) sc[g * CHUNK + j] = j < nt ? s[g] * scale : NEG_INF;
    }
  }
  __syncthreads();

  // 4. softmax over the chunk, one warp a head
  for (int g = warp; g < G; g += WARPS) {
    float v[CHUNK / 32], mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      v[i] = sc[g * CHUNK + lane + 32 * i];
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      v[i] = expf(v[i] - mx);
      sum += v[i];
      sc[g * CHUNK + lane + 32 * i] = v[i];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm_m[g] = mx;
      sm_l[g] = sum;
    }
  }
  cp_async_wait<0>();                                       // V has landed
  __syncthreads();

  // 5. acc = sum_t p_t V_t: over the passes, the warp's token slots, the warps
  float acc[GM][DM];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < DM; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int j = (p * WARPS + warp) * T + slot;
    if (j < nt) {                     // rows past the chunk's end are not staged
      float vf[DM];
      row_vals<QT, KVT, DM, DH_ != 0>(Vs + j * dh + d0, D, kv_scale, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pr = g < G ? sc[g * CHUNK + j] : 0.f;
#pragma unroll
        for (int e = 0; e < DM; ++e) acc[g][e] += pr * vf[e];
      }
    }
  }
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < DM; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < DM; ++e)
        if (g < G && e < D) red[(warp * G + g) * dh + d0 + e] = acc[g][e];
  }
  __syncthreads();

  // 6. one chunk: the output; else the partial, and the last chunk merges
  QT* ob = out + ((size_t)b * hq + (size_t)h * G) * dh;
  if (nc == 1) {
    for (int i = tid; i < G * dh; i += THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += red[w * G * dh + i];
      store(ob + i, a / fmaxf(sm_l[i / dh], 1e-20f));
    }
    return;
  }
  const int ps = G * (dh + 2);                              // floats a partial
  const size_t bh = (size_t)b * hk + h;
  float* base = part + bh * gridDim.x * ps;                 // the row's partials
  {
    float* mine = base + (size_t)c * ps;
    for (int i = tid; i < G * dh; i += THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += red[w * G * dh + i];
      mine[i] = a;
    }
    if (tid < G) {
      mine[G * dh + tid] = sm_m[tid];
      mine[G * dh + G + tid] = sm_l[tid];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_block = atomicAdd(cnt + bh, 1) == nc - 1;
  __syncthreads();
  if (!*last_block) return;
  __threadfence();
  if (tid == 0) cnt[bh] = 0;          // every chunk of the row has its ticket
  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh;
    float mx = NEG_INF;
    for (int cc = 0; cc < nc; ++cc) mx = fmaxf(mx, __ldcg(base + cc * ps + G * dh + g));
    float lsum = 0.f, a = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const float* pc = base + (size_t)cc * ps;
      const float e = expf(__ldcg(pc + G * dh + g) - mx);
      lsum += __ldcg(pc + G * dh + G + g) * e;
      a += __ldcg(pc + i) * e;
    }
    store(ob + i, a / fmaxf(lsum, 1e-20f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *pages, *pos;
  void* out;
  int B, max_pages, page_size, hq, hk, dh;
  float scale, kv_scale;
  int* cnt;
  long long cnt_ints;
  float* part;
  long long part_floats;
};

template <typename QT, typename KVT, int G_, int DH_>
int launch(const Args& a, cudaStream_t stream) {
  auto* kernel = paged_decode_kernel<QT, KVT, G_, DH_>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<KVT>(G_ ? G_ : MAXG, DH_ ? DH_ : MAXDH));
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.hq / a.hk;
  const int chunks = (a.max_pages * a.page_size + CHUNK - 1) / CHUNK;
  if (!a.cnt || !a.part || a.cnt_ints < (long long)a.B * a.hk ||
      a.part_floats < part_need(a.B, a.hk, chunks, G, a.dh))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, a.hk, a.B);
  kernel<<<grid, THREADS, smem_bytes<KVT>(G, a.dh), stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), a.pages, a.pos, static_cast<QT*>(a.out),
      a.max_pages, a.page_size, a.hq, a.hk, a.dh, a.scale, a.kv_scale, a.cnt, a.part);
  return (int)cudaGetLastError();
}

// the instantiation for (G, dh): the served archs' and the reduced / test
// shapes', else the generic one
template <typename QT, typename KVT>
int launch_for(const Args& a, cudaStream_t stream) {
  const int G = a.hq / a.hk;
#define SHAPE(g, d) \
  if (G == g && a.dh == d) return launch<QT, KVT, g, d>(a, stream);
  SHAPE(3, 128)   // llama3.2-3b
  SHAPE(1, 128)   // deepseek-moe-16b
  SHAPE(4, 128)   // phi3.5-moe
  SHAPE(2, 32)    // reduced llama3.2-3b / phi3.5-moe
  SHAPE(1, 32)    // reduced deepseek-moe-16b
  SHAPE(1, 64)
#undef SHAPE
  if (G == G_WIDE) return launch<QT, KVT, G_WIDE, 0>(a, stream);   // nemotron-4-340b
  return launch<QT, KVT, 0, 0>(a, stream);
}

}  // namespace

// q/out: (B, Hq, dh) of q_dtype (DT_F32 | DT_BF16); pools: (num_pages,
// page_size, Hk, dh) of kv_dtype (the q dtype, or DT_I8 codes at kv_scale),
// 16-byte aligned; pages: (B, max_pages) int32; pos: (B,) int32.
// cnt / cnt_ints: at least B * Hk int32 counters, zero (the kernel leaves
// them zero); part / part_floats: at least B * Hk * ceil(max_pages *
// page_size / 64) * G * (dh + 2) floats for the chunks' partials. Two
// buffers, so that no launch's partials overlap another's counters.
// Launches on one stream may share them, launches on two may not.
extern "C" int repro_paged_decode(int q_dtype, int kv_dtype, const void* q,
                                  const void* k_pool, const void* v_pool,
                                  const int* pages, const int* pos, void* out,
                                  int B, int max_pages, int page_size, int hq,
                                  int hk, int dh, float scale, float kv_scale,
                                  int* cnt, long long cnt_ints, float* part,
                                  long long part_floats, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || hk <= 0 || hk > 65535 || page_size <= 0 || max_pages <= 0 ||
      hq % hk || (hq / hk > MAXG && hq / hk != G_WIDE) || dh % 32 || dh > MAXDH)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k_pool) % 16 || reinterpret_cast<uintptr_t>(v_pool) % 16)
    return (int)cudaErrorMisalignedAddress;
  const Args a{q, k_pool, v_pool, pages, pos, out, B, max_pages, page_size,
               hq, hk, dh, scale, kv_scale, cnt, cnt_ints, part, part_floats};
  if (q_dtype == DT_BF16 && kv_dtype == DT_BF16)
    return launch_for<__nv_bfloat16, __nv_bfloat16>(a, stream);
  if (q_dtype == DT_BF16 && kv_dtype == DT_I8)
    return launch_for<__nv_bfloat16, int8_t>(a, stream);
  if (q_dtype == DT_F32 && kv_dtype == DT_F32)
    return launch_for<float, float>(a, stream);
  if (q_dtype == DT_F32 && kv_dtype == DT_I8)
    return launch_for<float, int8_t>(a, stream);
  return (int)cudaErrorInvalidValue;
}
