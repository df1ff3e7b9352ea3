// Online-softmax attention forward shared by the port's attention kernels
// (sm_90a). A kernel source supplies a logit policy (what is added to, or
// replaces, the raw product q.k) and instantiates the core with it.
//
// Design: one block of NT = 128 threads per (q tile of BQ = 64 rows, h, b).
// K and V stream through shared memory in tiles of BK = 64 keys with an
// online softmax (running max and sum per row in f32, one divide at the
// end), so the (Lq, Lk) logits never reach device memory and each K/V
// element is read from device memory once per q tile. Output in q's dtype.
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   Each warp owns 16 query rows, keeps its q fragments in registers, and
//   reuses the logits' accumulator layout as the A operand of P v (P rounded
//   to bf16, as the plain version casts the exp tensor to v's dtype); V is
//   stored transposed in shared memory so each B fragment is one 32-bit load.
// * f32: CUDA-core FMAs with a 4 x 8 (S) and 4 x DP/8 (O) register tile per
//   thread, which keeps f32 inputs exact (no TF32).
// Loads are synchronous (no cp.async/TMA pipeline) and there is no wgmma:
// both are later work.
//
// A logit policy P, passed to the kernel by value:
//   P::kSmemBytes                         shared memory it needs per block
//   P::Block P::block(smem, b, h, q0)     per-block state; may stage data into
//                                         its shared memory (all threads run
//                                         it; it is read only after the first
//                                         key tile's barrier)
//   Block::stage_keys(k0)                 per key tile, by all threads, between
//                                         the tile's two barriers
//   Block::logit(x, lr, j, k0)            the logit of block row lr (row
//                                         q0 + lr) and tile key j (key k0 + j)
//                                         from the raw product x; -inf for a
//                                         key past Lk, so such keys add nothing
// Keys past Lk get -inf and every tile holds at least one real key, so the
// running max is finite after the first tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per streamed tile
constexpr int NT = 128;     // threads per block
constexpr int QS = BQ + 4;  // f32 path: row stride of the d-major q tile (pads banks)
constexpr int KS = BK + 4;  // f32 path: row stride of the d-major k tile
constexpr int PS = BQ + 4;  // f32 path: row stride of the key-major P tile
constexpr float NEG_INF_LOGIT = -1e9f;

// ---------------------------------------------------------------- f32 path

template <int DP>
constexpr size_t f32_core_bytes() {
  return sizeof(float) * (size_t(DP) * QS + size_t(DP) * KS + size_t(BK) * DP + size_t(BK) * PS);
}

// DP is the head dim padded up to 32, 64 or 128; columns d >= D hold zeros.
// Threads: ty = tid / 8 owns rows ty*4..+3, tx = tid % 8 owns S columns
// tx*4+{0..3} and 32+tx*4+{0..3} and O columns c*32+tx*4+{0..3}.
template <int DP, class P>
__global__ void __launch_bounds__(NT)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int H, int Lq,
                     int Lk, int D, const P policy) {
  constexpr int NC = DP / 32;  // float4 groups of output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [DP][QS]  q^T
  float* Ks = Qs + DP * QS;                        // [DP][KS]  k^T
  float* Vs = Ks + DP * KS;                        // [BK][DP]
  float* Ps = Vs + BK * DP;                        // [BK][PS]  P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* qb = q + bh * Lq * D;
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    Qs[d * QS + r] = (row < Lq && d < D) ? qb[(long long)row * D + d] : 0.f;
  }
  const typename P::Block blk = policy.block(reinterpret_cast<char*>(Ps + BK * PS), b, h, q0);

  float o[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // previous tile's readers of Ks / Vs / Ps / policy data are done
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int j = idx / DP, d = idx % DP;
      const int key = k0 + j;
      const bool in = key < Lk && d < D;
      Ks[d * KS + j] = in ? kb[(long long)key * D + d] : 0.f;
      Vs[j * DP + d] = in ? vb[(long long)key * D + d] : 0.f;
    }
    blk.stage_keys(k0);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * QS + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ks[d * KS + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ks[d * KS + 32 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
    }

    // online softmax; the 8 threads of a row are 8 consecutive lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = jj < 4 ? tx * 4 + jj : 32 + tx * 4 + (jj - 4);
        s[i][jj] = blk.logit(s[i][jj], ty * 4 + i, j, k0);
        tmax = fmaxf(tmax, s[i][jj]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);  // finite: k0 < Lk
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float tsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        tsum += s[i][jj];
      }
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 4);
      l[i] = l[i] * alpha + tsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = jj < 4 ? tx * 4 + jj : 32 + tx * 4 + (jj - 4);
      *reinterpret_cast<float4*>(&Ps[j * PS + ty * 4]) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * PS + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * DP + c * 32 + tx * 4]);
        const float vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c * 4 + e] = fmaf(pv[i], vs[e], o[i][c * 4 + e]);
      }
    }
  }

  float* ob = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 32 + tx * 4 + e;
        if (d < D) ob[(long long)row * D + d] = o[i][c * 4 + e] * inv;
      }
  }
}

// --------------------------------------------------------------- bf16 path

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DP>
constexpr size_t bf16_core_bytes() {
  return sizeof(__nv_bfloat16) * (size_t(BK) * (DP + 8) + size_t(DP) * (BK + 8));
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):        c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// S = q k^T: A = q rows x d, B[k=d][n=key] = K[key][d], a pair along d.
// O += P v:  A = P rows x keys (from S's accumulators), B[k=key][n=d] =
//            Vt[d][key], a pair along keys.
// DP (32, 64, 128) is the head dim padded; the wrapper guarantees D % 8 == 0
// and 16-byte aligned q, k, v, so a row is whole 16-byte chunks.
template <int DP, class P>
__global__ void __launch_bounds__(NT)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int H, int Lq, int Lk, int D, const P policy) {
  constexpr int KSTR = DP + 8;  // bf16 per K row in shared memory (conflict-free b loads)
  constexpr int VSTR = BK + 8;  // bf16 per Vt row
  constexpr int NKD = DP / 16;  // k-steps over d for S
  constexpr int NOD = DP / 8;   // n-tiles over d for O
  constexpr int NSK = BK / 8;   // n-tiles over keys for S
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BK][KSTR]
  __nv_bfloat16* Vt = Ks + BK * KSTR;                               // [DP][VSTR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // this lane's block rows
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  uint32_t qa[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
    const int d = kk * 16 + 2 * t;
    qa[kk][0] = (r0 < Lq && d < D) ? ld32(qb + (long long)r0 * D + d) : 0u;
    qa[kk][1] = (r1 < Lq && d < D) ? ld32(qb + (long long)r1 * D + d) : 0u;
    qa[kk][2] = (r0 < Lq && d + 8 < D) ? ld32(qb + (long long)r0 * D + d + 8) : 0u;
    qa[kk][3] = (r1 < Lq && d + 8 < D) ? ld32(qb + (long long)r1 * D + d + 8) : 0u;
  }
  const typename P::Block blk =
      policy.block(reinterpret_cast<char*>(Vt + DP * VSTR), b, h, q0);

  float o[NOD][4];
#pragma unroll
  for (int j = 0; j < NOD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // previous tile's readers of Ks / Vt / policy data are done
    for (int c = tid; c < BK * (DP / 8); c += NT) {
      const int j = c / (DP / 8), d0 = (c % (DP / 8)) * 8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < Lk && d0 < D) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)key * D + d0);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)key * D + d0);
      }
      *reinterpret_cast<uint4*>(&Ks[j * KSTR + d0]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d0 + e) * VSTR + j] = ve[e];
    }
    blk.stage_keys(k0);
    __syncthreads();

    float s[NSK][4];
#pragma unroll
    for (int n = 0; n < NSK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + g) * KSTR + 2 * t];
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        const uint32_t bf[2] = {ld32(krow + kk * 16), ld32(krow + kk * 16 + 8)};
        mma_16816(s[n], qa[kk], bf);
      }
    }

    // online softmax over rows r0 (s[n][0..1]) and r1 (s[n][2..3]); a row's
    // 64 keys sit in the 4 lanes of one g, so xor-shuffles 1, 2 reduce it
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NSK; ++n) {
      const int j = n * 8 + 2 * t;
      s[n][0] = blk.logit(s[n][0], lr0, j, k0);
      s[n][1] = blk.logit(s[n][1], lr0, j + 1, k0);
      s[n][2] = blk.logit(s[n][2], lr1, j, k0);
      s[n][3] = blk.logit(s[n][3], lr1, j + 1, k0);
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: k0 < Lk
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);  // 0 on the first tile
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NSK; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NOD; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NOD; ++j) {
        const __nv_bfloat16* vrow = &Vt[(j * 8 + g) * VSTR + kk * 16 + 2 * t];
        const uint32_t bf[2] = {ld32(vrow), ld32(vrow + 8)};
        mma_16816(o[j], pa, bf);
      }
    }
  }

  __nv_bfloat16* ob = out + bh * Lq * D;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < NOD; ++j) {
    const int d = j * 8 + 2 * t;
    if (d >= D) continue;
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * D + d) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * D + d) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// ----------------------------------------------------------------- launch

// Opt in to the kernel's dynamic shared memory (needed above 48 KB; set on
// every launch, so it holds on whichever device is current), then launch.
// Returns cudaGetLastError() after the launch (0 = launched).
template <typename T, int DP, class P>
int launch_dp(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
              int Lk, int D, const P& policy, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t bytes = (kBf16 ? bf16_core_bytes<DP>() : f32_core_bytes<DP>()) + P::kSmemBytes;
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, const P);
  if constexpr (kBf16) kernel = attention_bf16_kernel<DP, P>;
  else kernel = attention_f32_kernel<DP, P>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), H, Lq, Lk,
                                      D, policy);
  return (int)cudaGetLastError();
}

// q (B,H,Lq,D), k and v (B,H,Lk,D) contiguous and 16-byte aligned, D a
// multiple of 8 and at most 128; is_bf16 selects bf16 tensors, else f32.
template <class P>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq, int Lk,
           int D, int is_bf16, const P& policy, cudaStream_t stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : 128;
  if (is_bf16) {
    if (dp == 32) return launch_dp<__nv_bfloat16, 32>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
    if (dp == 64) return launch_dp<__nv_bfloat16, 64>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
    return launch_dp<__nv_bfloat16, 128>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
  }
  if (dp == 32) return launch_dp<float, 32>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
  if (dp == 64) return launch_dp<float, 64>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
  return launch_dp<float, 128>(q, k, v, out, B, H, Lq, Lk, D, policy, stream);
}

}  // namespace attn
