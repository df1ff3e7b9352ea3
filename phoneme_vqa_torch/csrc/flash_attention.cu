// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: phoneme_vqa_tpu/ops/flash_attention.py: fused_attention (the
// Pallas kernels _attn_kernel / _attn_kernel_nobias), reached through
// ops/attention.py: dot_product_attention for every attention with
// Lq >= 16: the 12 ViT layers and the 12 T5 encoder layers on the serving
// path.
//
// Computes, per (b, h):
//   out = softmax(scale * q k^T + bias; masked keys -> -1e9; causal -> -1e9) v
// with f32 logits, an f32 softmax and f32 accumulation of P v, output in
// q's dtype (f32 or bf16). A masked or causal key's logit is REPLACED by
// -1e9, as in reference_attention; keys past Lk in this kernel's own tiling
// get -inf and contribute nothing, so a fully masked row averages v over
// the Lk real keys. The bias (1 or B, H, Lq, Lk) is f32; a bias batch of 1
// is broadcast over b (bias_bstride == 0).
//
// What bounds it: at the serving shapes (B=32, H=12, D=64, bf16) the least
// time per call is set by bytes, not operations. T5 encoder, L=327: q, k, v
// and out are 4 * 32*12*327*64*2 B = 64.3 MB plus the 5.1 MB f32 bias,
// ~20.7 us at 3.35 TB/s, against 4*32*12*327^2*64 = 10.5 GFLOP, ~10.6 us at
// 989 TFLOP/s. ViT, L=197: 38.7 MB, ~11.6 us.
//
// Design: one block of 128 threads per (q tile of 64 rows, h, b). K and V
// stream through shared memory in tiles of 64 keys with an online softmax
// (running max and sum per row in f32, one divide at the end), so the
// (Lq, Lk) logits never reach device memory and each K/V element is read
// from device memory once per q tile.
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16
//   (bf16 in, f32 accumulate). Each warp owns 16 query rows, keeps its q
//   fragments in registers, and reuses the logits' accumulator layout as
//   the A operand of P v (P rounded to bf16, as the plain version casts
//   the exp tensor to v's dtype); V is stored transposed in shared memory
//   so each B fragment is one 32-bit load.
// * f32: CUDA-core FMAs with a 4 x 8 (S) and 4 x DP/8 (O) register tile per
//   thread, which keeps f32 inputs exact (no TF32).
// Loads are synchronous (no cp.async/TMA pipeline) and there is no wgmma:
// both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int NT = 128;       // threads per block
constexpr int QS = BQ + 4;    // f32 path: row stride of the d-major q tile (pads banks)
constexpr int KS = BK + 4;    // f32 path: row stride of the d-major k tile
constexpr int PS = BQ + 4;    // f32 path: row stride of the key-major P tile
constexpr float NEG_INF_LOGIT = -1e9f;

// The logit of query row `row`, key `col` (in the whole sequence) from the
// raw product x: scale, bias, key mask, causal mask; -inf past Lk.
__device__ __forceinline__ float logit(float x, int row, int col, int Lq, int Lk, float scale,
                                       const float* biasb, const int* maskb, int causal) {
  if (col >= Lk) return -INFINITY;
  x *= scale;
  if (biasb && row < Lq) x += biasb[(long long)row * Lk + col];
  if (maskb && maskb[col] == 0) x = NEG_INF_LOGIT;
  if (causal && col > row) x = NEG_INF_LOGIT;
  return x;
}

// ---------------------------------------------------------------- f32 path

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t(DP) * QS + size_t(DP) * KS + size_t(BK) * DP + size_t(BK) * PS);
}

// DP is the head dim padded up to 32, 64 or 128; columns d >= D hold zeros.
// Threads: ty = tid / 8 owns rows ty*4..+3, tx = tid % 8 owns S columns
// tx*4+{0..3} and 32+tx*4+{0..3} and O columns c*32+tx*4+{0..3}.
template <int DP>
__global__ void __launch_bounds__(NT)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ mask, float* __restrict__ out,
                     int H, int Lq, int Lk, int D, long long bias_bstride,
                     int causal, float scale) {
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
  const float* biasb = bias ? bias + (long long)b * bias_bstride + (long long)h * Lq * Lk : nullptr;
  const int* maskb = mask ? mask + (long long)b * Lk : nullptr;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    Qs[d * QS + r] = (row < Lq && d < D) ? qb[(long long)row * D + d] : 0.f;
  }

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
    __syncthreads();  // previous tile's readers of Ks / Vs / Ps are done
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int j = idx / DP, d = idx % DP;
      const int key = k0 + j;
      const bool in = key < Lk && d < D;
      Ks[d * KS + j] = in ? kb[(long long)key * D + d] : 0.f;
      Vs[j * DP + d] = in ? vb[(long long)key * D + d] : 0.f;
    }
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
      const int row = q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = k0 + (jj < 4 ? tx * 4 + jj : 32 + tx * 4 + (jj - 4));
        s[i][jj] = logit(s[i][jj], row, col, Lq, Lk, scale, biasb, maskb, causal);
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

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):        c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
// S = q k^T: A = q rows x d, B[k=d][n=key] = K[key][d], a pair along d.
// O += P v:  A = P rows x keys (from S's accumulators), B[k=key][n=d] =
//            Vt[d][key], a pair along keys.
// DP (32, 64, 128) is the head dim padded; the wrapper guarantees D % 8 == 0
// and 16-byte aligned q, k, v, so a row is whole 16-byte chunks.
template <int DP>
__global__ void __launch_bounds__(NT)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                      int H, int Lq, int Lk, int D, long long bias_bstride,
                      int causal, float scale) {
  constexpr int KSTR = DP + 8;  // bf16 per K row in shared memory (conflict-free b loads)
  constexpr int VSTR = BK + 8;  // bf16 per Vt row
  constexpr int NKD = DP / 16;  // k-steps over d for S
  constexpr int NOD = DP / 8;   // n-tiles over d for O
  constexpr int NSK = BK / 8;   // n-tiles over keys for S
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP * VSTR];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qb = q + bh * Lq * D;
  const __nv_bfloat16* kb = k + bh * Lk * D;
  const __nv_bfloat16* vb = v + bh * Lk * D;
  const float* biasb = bias ? bias + (long long)b * bias_bstride + (long long)h * Lq * Lk : nullptr;
  const int* maskb = mask ? mask + (long long)b * Lk : nullptr;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t qa[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
    const int d = kk * 16 + 2 * t;
    qa[kk][0] = (r0 < Lq && d < D) ? ld32(qb + (long long)r0 * D + d) : 0u;
    qa[kk][1] = (r1 < Lq && d < D) ? ld32(qb + (long long)r1 * D + d) : 0u;
    qa[kk][2] = (r0 < Lq && d + 8 < D) ? ld32(qb + (long long)r0 * D + d + 8) : 0u;
    qa[kk][3] = (r1 < Lq && d + 8 < D) ? ld32(qb + (long long)r1 * D + d + 8) : 0u;
  }

  float o[NOD][4];
#pragma unroll
  for (int j = 0; j < NOD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // previous tile's readers of Ks / Vt are done
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
      const int col = k0 + n * 8 + 2 * t;
      s[n][0] = logit(s[n][0], r0, col, Lq, Lk, scale, biasb, maskb, causal);
      s[n][1] = logit(s[n][1], r0, col + 1, Lq, Lk, scale, biasb, maskb, causal);
      s[n][2] = logit(s[n][2], r1, col, Lq, Lk, scale, biasb, maskb, causal);
      s[n][3] = logit(s[n][3], r1, col + 1, Lq, Lk, scale, biasb, maskb, causal);
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

struct Args {
  const void *q, *k, *v;
  const float* bias;
  const int* mask;
  void* out;
  int B, H, Lq, Lk, D;
  long long bias_bstride;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int DP>
int launch_f32(const Args& a) {
  constexpr size_t bytes = f32_smem_bytes<DP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  attention_f32_kernel<DP><<<grid, NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.mask, static_cast<float*>(a.out), a.H, a.Lq,
      a.Lk, a.D, a.bias_bstride, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const Args& a) {
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  attention_bf16_kernel<DP><<<grid, NT, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bias, a.mask,
      static_cast<__nv_bfloat16*>(a.out), a.H, a.Lq, a.Lk, a.D, a.bias_bstride, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Shapes are
// checked by the Python wrapper: q (B,H,Lq,D), k and v (B,H,Lk,D) contiguous
// and 16-byte aligned; D a multiple of 8 and at most 128; bias f32
// (1|B,H,Lq,Lk) or null; mask int32 (B,Lk) or null. is_bf16 selects bf16
// tensors, else f32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int B,
                                   int H, int Lq, int Lk, int D, long long bias_bstride,
                                   int causal, float scale, int is_bf16, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(bias), static_cast<const int*>(mask), out,
               B, H, Lq, Lk, D, bias_bstride, causal, scale, static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (D <= 32) return launch_bf16<32>(a);
    if (D <= 64) return launch_bf16<64>(a);
    return launch_bf16<128>(a);
  }
  if (D <= 32) return launch_f32<32>(a);
  if (D <= 64) return launch_f32<64>(a);
  return launch_f32<128>(a);
}
