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
// Both kernels turn the TPU grid's sequential KV axis into a loop inside the
// block: one block owns one (b, h, 64-row query tile), each of its 4 warps 16
// query rows, so softmax row statistics never leave a warp. The walk stops
// at the causal edge: the reference iterates fully masked tiles too, but
// there p = exp(-1e30 - m) = 0 and c = 1, so they change nothing.
//
// bf16 (the serve path): `flash_mma_kernel`, on the tensor cores. Bound: at
// the serve path's prefill (T = 256, 24/8 heads, dh = 128) one layer moves
// ~4.2 MB of q/k/v/out (1.3 us at 3.35 TB/s) and does ~0.4 GFLOP in its
// causal half (0.4 us at 989 TFLOP/s), so bytes bound it; at T = 2048 the
// products (26 GFLOP) do. Design:
// - QK^T and PV run as mma.sync m16n8k16 bf16 -> f32, fragments loaded by
//   ldmatrix (V with .trans). Q's fragments are loaded once and stay in
//   registers; S, m, l and the output accumulator are f32 registers. A row's
//   max and sum are reduced over the 4 lanes of a quad by shuffles.
// - P goes from the S accumulator fragment straight into the PV A fragment,
//   rounded to bf16: exactly the reference's `p.astype(v.dtype)`.
// - Q, K and V are staged in bf16 by cp.async, K/V in a 2-stage ring, so the
//   next tile loads while this one multiplies; rows are padded by 16 bytes so
//   the 8 rows an ldmatrix reads fall in distinct banks. 87 KB of shared
//   memory per block: 2 blocks (8 warps) per SM.
// - The grid walks the query tiles longest causal walk first. At T = 256 it
//   has 4 x 24 = 96 blocks, one per SM: each warp's walk over at most 256
//   keys is the critical path whatever the tile, and 64-row tiles read K/V
//   once per 4 warps. At T = 2048 its 768 blocks fill the card ~3 times.
// - Scores are scaled after the dot in f32, masked with NEG_INF (only in a
//   tile that crosses the causal edge or Tk), and the output divided by
//   max(l, 1e-20), as in the reference; exp(x - m) is taken as
//   exp2(x log2(e) - m log2(e)).
//
// f32: `flash_kernel` keeps the first port's body, its MACs in f32 on the
// CUDA cores with Q, K, V and P staged in f32 (rows padded by one word): a
// tf32 product would round q and k to 10 mantissa bits and miss the f32 bar
// of 2e-4, and f32 is off the serve path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // KV rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = BQ / (THREADS / 32);  // query rows per warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// -- f32: CUDA cores ---------------------------------------------------------

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int H, int Hk,
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
  const float* qp = q + b * sqb + h * sqh;
  const float* kp = k + b * skb + hk * skh;
  const float* vp = v + b * svb + hk * svh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, t = q0 + r;
    Qs[r * (DH + 1) + d] = t < Tq ? qp[t * sqt + d] : 0.f;
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
      Ks[r * (DH + 1) + d] = t < Tk ? kp[t * skt + d] : 0.f;
      Vs[r * DH + d] = t < Tk ? vp[t * svt + d] : 0.f;
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
      Ps[r * (BK + 1) + lane] = p0;
      Ps[r * (BK + 1) + lane + 32] = p1;
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
    float* op = out + b * sob + h * soh + t * sot;
#pragma unroll
    for (int j = 0; j < DJ; ++j) op[lane + 32 * j] = acc[i][j] / inv;
  }
}

// -- bf16: tensor cores ------------------------------------------------------

// d += a (16 x 16 bf16, row) . b (16 x 8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * (DH + 8) * 2;            // Q + 2 stages of K and V
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int H, int Hk, int Tq, int Tk,
                 long long sqb, long long sqh, long long sqt, long long skb,
                 long long skh, long long skt, long long svb, long long svh,
                 long long svt, long long sob, long long soh, long long sot,
                 int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DH + 8;          // padded row, in bf16
  constexpr int CH = DH / 8;          // 16-byte chunks per row
  constexpr int KS = DH / 16;         // k-steps of QK^T
  constexpr int NT = BK / 8;          // 8-key column tiles of S
  constexpr int DT = DH / 8;          // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                          // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                      // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest walk first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const bf16* qp = q + b * sqb + h * sqh;
  const bf16* kp = k + b * skb + hk * skh;
  const bf16* vp = v + b * svb + hk * svh;

  // rows r0 .. r0 + BK - 1 of src (row stride st), zero past nvalid
  static_assert(BQ == BK, "Q and KV tiles share load_rows");
  auto load_rows = [&](bf16* dst, const bf16* src, long long st, int r0, int nvalid) {
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, t = r0 + r;
      const bool ok = t < nvalid;
      cp_async16(dst + r * LD + 8 * c, ok ? src + t * st + 8 * c : src,
                 ok ? 16 : 0);
    }
  };

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Tq) - 1) / BK + 1);
  load_rows(Qs, qp, sqt, q0, Tq);
  load_rows(Ks, kp, skt, 0, Tk);
  load_rows(Vs, vp, svt, 0, Tk);
  cp_async_commit();

  // fragment coordinates: this lane's rows ra, rb and key columns 2tg, 2tg+1
  const int g = lane >> 2, tg = lane & 3;
  const int w0 = q0 + warp * 16;      // the warp's first query row
  const int ra = w0 + g, rb = ra + 8;
  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_tiles) {           // the next tile loads while this one runs
      load_rows(Ks + (st ^ 1) * BK * LD, kp, skt, k0 + BK, Tk);
      load_rows(Vs + (st ^ 1) * BK * LD, vp, svt, k0 + BK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + 16 * ks + 8 * (lane >> 4));
    }
    // warp-uniform: skip a warp past Tq, or one whose rows all precede the tile
    if (w0 < Tq && (!causal || k0 <= w0 + 15)) {
      const bf16* Kt = Ks + st * BK * LD;
      const bf16* Vt = Vs + st * BK * LD;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kb[4];
          ldsm_x4(kb, Kt + (8 * n + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * ks +
                          8 * ((lane >> 3) & 1));
          mma_bf16(s[n], qf[ks], kb[0], kb[1]);
          mma_bf16(s[n + 1], qf[ks], kb[2], kb[3]);
        }
      // only a tile across the causal edge or past Tk masks (warp-uniform)
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > w0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge) {
            const int j = k0 + 8 * n + 2 * tg + (e & 1), r = e < 2 ? ra : rb;
            if (j >= Tk || (causal && j > r)) x = NEG_INF;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      // exp(x - m) as exp2(x log2(e) - m log2(e)): one FMA and one EX2
      const float ml0 = mx[0] * LOG2E, ml1 = mx[1] * LOG2E;
      const float c0 = exp2f(fmaf(m[0], LOG2E, -ml0));
      const float c1 = exp2f(fmaf(m[1], LOG2E, -ml1));
      // P: S's accumulator fragment of key tiles 2kk, 2kk+1 is the A
      // fragment of PV's k-step kk, rounded to bf16
      uint32_t pf[NT / 2][4];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2f(fmaf(s[n][0], LOG2E, -ml0));
        const float p1 = exp2f(fmaf(s[n][1], LOG2E, -ml0));
        const float p2 = exp2f(fmaf(s[n][2], LOG2E, -ml1));
        const float p3 = exp2f(fmaf(s[n][3], LOG2E, -ml1));
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pf[n >> 1][2 * (n & 1)] = pack_bf16(p0, p1);
        pf[n >> 1][2 * (n & 1) + 1] = pack_bf16(p2, p3);
      }
      l[0] = l[0] * c0 + rs0;         // a lane's share; the quad adds them at the end
      l[1] = l[1] * c1 + rs1;
      m[0] = mx[0];
      m[1] = mx[1];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= c0;
        o[d][1] *= c0;
        o[d][2] *= c1;
        o[d][3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t vb[4];
          ldsm_x4_t(vb, Vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * d +
                            8 * (lane >> 4));
          mma_bf16(o[d], pf[kk], vb[0], vb[1]);
          mma_bf16(o[d + 1], pf[kk], vb[2], vb[3]);
        }
    }
    __syncthreads();                  // this stage is consumed before it reloads
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float la = fmaxf(l[0], 1e-20f), lb = fmaxf(l[1], 1e-20f);
  bf16* ob = out + b * sob + h * soh;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = 8 * d + 2 * tg;
    if (ra < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ra * sot + col) =
          __floats2bfloat162_rn(o[d][0] / la, o[d][1] / la);
    if (rb < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + rb * sot + col) =
          __floats2bfloat162_rn(o[d][2] / lb, o[d][3] / lb);
  }
}

// -- launch ------------------------------------------------------------------

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hk, int Tq, int Tk, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  // once per process, not per launch (a runtime call costs host time)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hk, Tq, Tk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int H, int Hk, int Tq, int Tk, const long long* st, int causal,
                float scale, cudaStream_t stream) {
  // cp.async moves 16 bytes: every row must start 16-byte aligned
  const void* ptrs[] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
  constexpr int smem = mma_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_mma_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Hk,
      Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). strides: 12
// element strides (b, h, t) of q, k, v, out in that order; dh is contiguous.
// bf16 needs 16-byte aligned pointers and strides that are multiples of 8.
extern "C" int repro_flash_attn(int dtype, const void* q, const void* k,
                                const void* v, void* out, int B, int H, int Hk,
                                int Tq, int Tk, int dh, const long long* strides,
                                int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
#define DISPATCH(FN)                                                       \
  switch (dh) {                                                            \
    case 32: return FN<32>(q, k, v, out, B, H, Hk, Tq, Tk, strides, causal, \
                           scale, stream);                                  \
    case 64: return FN<64>(q, k, v, out, B, H, Hk, Tq, Tk, strides, causal, \
                           scale, stream);                                  \
    case 128: return FN<128>(q, k, v, out, B, H, Hk, Tq, Tk, strides,       \
                             causal, scale, stream);                        \
    default: return (int)cudaErrorInvalidValue;                             \
  }
  if (dtype == 0) DISPATCH(launch_f32)
  if (dtype == 1) DISPATCH(launch_bf16)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}
