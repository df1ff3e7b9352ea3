// Attention backward shared by the port's attention kernels (sm_90a), bf16
// inputs. A kernel source instantiates it with the logit policy of its
// forward (attention_core.cuh), which gives each logit and whether a
// position is live (neither masked, causal nor past Lk), so the backward
// sees exactly the forward's logits:
//   attn_bwd_dq (a block a query tile): the f32-path Block, with
//     Block::live(lr, j, k0) beside Block::logit
//   attn_bwd_dkdv (a block a key tile):
//     P::kKeySmemBytes                    shared memory it needs per block
//     P::KeyBlock P::key_block(smem, b, h, k0)
//                                         stages the key tile's data (all
//                                         threads; read after the next barrier)
//     KeyBlock::stage_rows(q0)            per query tile, between its barriers
//     KeyBlock::logit(x, lr, j, q0), KeyBlock::live(lr, j, q0)
//                                         Block's, for block row lr of the
//                                         query tile at q0
//
// Given q, k, v, the forward's output o and the upstream gradient g (all
// (B, H, L, D) by element strides (b, h, l) with a unit D stride), it writes
// dq, dk, dv in bf16 and, when asked, the logits' gradient dS (B, H, Lq, Lk)
// f32, which the caller reduces into the bias's gradient:
//   P  = softmax(logits)            f32, recomputed from the logits
//   dP = g v^T                      bf16 operands, f32 accumulation
//   Di = rowsum(g o)                f32
//   dS = live ? P (dP - Di) : 0     f32
//   dv = P^T g                      P rounded to bf16, as the forward's P V
//   dq = scale dS k,  dk = scale dS^T q
// dq and dk are products of the f32 dS: dS is split into two TF32 terms
// (hi = dS rounded to TF32, lo = the rest rounded to TF32) and each is
// multiplied with k or q, which bf16 holds exactly in TF32, on the tensor
// cores (mma.sync m16n8k8 tf32); the two products carry dS to ~2^-22,
// against a single TF32 or bf16 rounding of dS at 2^-11 / 2^-8.
//
// Two kernels, each over one (64-row tile, h, b) a block, 4 warps of 16 rows:
// * attn_bwd_dq: a block owns 64 query rows. It stages q, g and o, takes the
//   row term Di, walks the key tiles once for the softmax statistics (row
//   max m and 1 / sum), then again for dP, dS and dq += dS k; it writes dq,
//   the rows' (m, 1/l, Di) for the second kernel and dS where asked.
// * attn_bwd_dkdv: a block owns 64 keys. It walks the query tiles, recomputes
//   S^T = k q^T and dP^T = v g^T from the staged tiles and the rows' stats,
//   and accumulates dv += P^T g and dk += dS^T q in registers.
// Neither kernel uses atomics, so the gradients are the same bit for bit on
// every run. Each block stages its tiles with 16-byte loads into rows DP + 8
// bf16 apart, so the fragment loads of mma.sync hit 32 distinct banks.
// A fully masked row (every real key's logit -1e9) has P = 1 / Lk over its
// real keys and dS = 0, as the plain version's masked_fill gives; rows past
// Lq and keys past Lk give nothing.
//
// What bounds it: at the T5 encoder's training shape (B=16, H=12, L=327,
// D=64, bias gradient) the two kernels run 10 products of 64x64x64 a tile
// pair (S, then S and dP, and the two dq terms in the first; S, dP, dv and
// the two dk terms in the second) on ~6.9k tile pairs: 21.7 GFLOP of bf16
// (~0.022 ms at 989 TFLOP/s) and 14.5 of TF32 (~0.029 ms at 495), against
// ~146 MB moved (q, k, v, o, g read, dq, dk, dv and 82 MB of dS written:
// ~0.044 ms at 3.35 TB/s). It runs at ~15x that bound (PERF.md): each warp's
// chain of fragment loads, mma.sync and per-element logit work.

#pragma once

#include "attention_core.cuh"

namespace attn {

constexpr int BWD_T = 64;    // query rows or keys per tile
constexpr int BWD_NT = 128;  // 4 warps, 16 rows (or keys) each
static_assert(BWD_T == BQ && BWD_T == BK && BWD_NT == NT,
              "the policies' f32-path Blocks stage BQ rows and BK keys with NT threads");

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *o, *g;
  __nv_bfloat16 *dq, *dk, *dv;
  float4* stats;  // (B, H, Lq): m, 1 / l, Di, 0; written by attn_bwd_dq
  float* ds;      // (B, H, Lq, Lk) contiguous f32, or null
  Strides sq, sk, sv, so, sg, sdq, sdk, sdv;
  int B, H, Lq, Lk, D;
  float scale;  // the logits' factor on q k^T (1 where the policy has none)
};

// Shared memory of both kernels: four (64, DP + 8) bf16 tiles, 64 rows'
// stats, then the policy's block data (attn_bwd_dq: its f32-path Block;
// attn_bwd_dkdv: its KeyBlock).
template <int DP, class P>
constexpr int bwd_smem_bytes() {
  return 4 * BWD_T * (DP + 8) * 2 + BWD_T * 16 +
         int(P::kSmemBytes > P::kKeySmemBytes ? P::kSmemBytes : P::kKeySmemBytes);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of different rows as one register, p0 in the low half.
__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* p0, const __nv_bfloat16* p1) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(p0)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(p1)) << 16);
}

// A bf16 value as a TF32 operand: its f32 bits, exact.
__device__ __forceinline__ uint32_t tf32_of(const __nv_bfloat16* p) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0 .. r0 + 63 of a (L, D) slice with row stride sl into a (64, DP + 8)
// tile, zeros past L and past D, 16 bytes a load (D % 8 == 0, rows 16-byte
// aligned: the wrappers' layout contract).
template <int DP>
__device__ __forceinline__ void bwd_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long sl, int r0, int L, int D) {
  constexpr int CH = DP / 8, S = DP + 8;
  for (int idx = threadIdx.x; idx < BWD_T * CH; idx += BWD_NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L && c < D) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * sl + c);
    *reinterpret_cast<uint4*>(dst + r * S + c) = val;
  }
}

// acc[n][e] = (A B^T) of rows r0 + g (e < 2) or r0 + g + 8 (e >= 2) of tile
// a and rows 8n + 2t + (e & 1) of tile b, both (64, DP + 8) bf16: the mma
// accumulator layout over 16 rows x 64 columns.
template <int DP>
__device__ __forceinline__ void bwd_abt(float (&acc)[8][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int r0, int g, int t) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* pa = a + (r0 + g) * S + 16 * kk + 2 * t;
    const uint32_t af[4] = {ld32(pa), ld32(pa + 8 * S), ld32(pa + 8), ld32(pa + 8 * S + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* pb = b + (8 * n + g) * S + 16 * kk + 2 * t;
      mma_bf16(acc[n], af, ld32(pb), ld32(pb + 8));
    }
  }
}

// acc[dn] += X T, X (16 x 64) f32 in the accumulator layout of bwd_abt, T a
// (64, DP + 8) bf16 tile, as two TF32 products (X's hi and lo terms). The
// k index of each m16n8k8 step is permuted: its k = t and t + 4 are the
// columns 8n + 2t and 8n + 2t + 1 the thread holds, and T's rows follow.
template <int DP>
__device__ __forceinline__ void bwd_split_xt(float (&acc)[DP / 8][4], const float (&x)[8][4],
                                             const __nv_bfloat16* tile, int g, int t) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float v[4] = {x[n][0], x[n][2], x[n][1], x[n][3]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = to_tf32(v[i]);
      lo[i] = to_tf32(v[i] - __uint_as_float(hi[i]));
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const __nv_bfloat16* p = tile + (8 * n + 2 * t) * S + 8 * dn + g;
      const uint32_t b0 = tf32_of(p), b1 = tf32_of(p + S);
      mma_tf32(acc[dn], lo, b0, b1);
      mma_tf32(acc[dn], hi, b0, b1);
    }
  }
}

// Rows r (acc[.][0..1]) and r + 8 (acc[.][2..3]) of a 16 x DP accumulator,
// times `mul`, into bf16 rows of `dst` (row stride sl), columns below D,
// rows below L.
template <int DP>
__device__ __forceinline__ void bwd_store_rows(__nv_bfloat16* dst, long long sl,
                                               const float (&acc)[DP / 8][4], int r, int L,
                                               int D, int t, float mul) {
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    const int c = 8 * dn + 2 * t;
    if (c >= D) continue;
    if (r < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * sl + c) =
          __floats2bfloat162_rn(acc[dn][0] * mul, acc[dn][1] * mul);
    if (r + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * sl + c) =
          __floats2bfloat162_rn(acc[dn][2] * mul, acc[dn][3] * mul);
  }
}

template <int DP, class P>
__global__ void __launch_bounds__(BWD_NT)
attn_bwd_dq(const BwdArgs a, const P policy) {
  constexpr int S = DP + 8, TILE = BWD_T * S;
  extern __shared__ float4 bwd_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* Gs = Qs + TILE;
  __nv_bfloat16* Ks = Gs + TILE;
  __nv_bfloat16* Vs = Ks + TILE;  // o first, for the row term
  char* psm = reinterpret_cast<char*>(Vs + TILE) + BWD_T * 16;

  const int q0 = blockIdx.x * BWD_T, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;  // the warp's first block row
  const long long bh = (long long)b * a.H + h;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + h * a.sv.h;

  bwd_load_tile<DP>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.l, q0, a.Lq, a.D);
  bwd_load_tile<DP>(Gs, a.g + b * a.sg.b + h * a.sg.h, a.sg.l, q0, a.Lq, a.D);
  bwd_load_tile<DP>(Vs, a.o + b * a.so.b + h * a.so.h, a.so.l, q0, a.Lq, a.D);
  const typename P::Block blk = policy.block(psm, b, h, q0);
  __syncthreads();

  // Di of rows wr + g and wr + g + 8; the 4 lanes of a g split the columns
  float di0 = 0.f, di1 = 0.f;
#pragma unroll
  for (int c = 2 * t; c < DP; c += 8) {
    const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Gs + (wr + g) * S + c));
    const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + (wr + g) * S + c));
    const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Gs + (wr + g + 8) * S + c));
    const float2 o1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + (wr + g + 8) * S + c));
    di0 = fmaf(g0.x, o0.x, fmaf(g0.y, o0.y, di0));
    di1 = fmaf(g1.x, o1.x, fmaf(g1.y, o1.y, di1));
  }
  di0 += __shfl_xor_sync(0xffffffffu, di0, 1);
  di0 += __shfl_xor_sync(0xffffffffu, di0, 2);
  di1 += __shfl_xor_sync(0xffffffffu, di1, 1);
  di1 += __shfl_xor_sync(0xffffffffu, di1, 2);

  const int n_kt = (a.Lk + BWD_T - 1) / BWD_T;
  float s[8][4];
  // pass 1: each row's max m and sum l of exp(logit - m)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BWD_T;
    __syncthreads();  // the readers of Ks / Vs and the key data before are done
    bwd_load_tile<DP>(Ks, kb, a.sk.l, k0, a.Lk, a.D);
    blk.stage_keys(k0);
    __syncthreads();
    bwd_abt<DP>(s, Qs, Ks, wr, g, t);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = blk.logit(s[n][e], wr + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1), k0);
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a real key
    l0 *= expf(m0 - mn0);
    l1 *= expf(m1 - mn1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      l0 += expf(s[n][0] - mn0) + expf(s[n][1] - mn0);
      l1 += expf(s[n][2] - mn1) + expf(s[n][3] - mn1);
    }
    m0 = mn0;
    m1 = mn1;
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + wr + g;  // this thread's rows row0 and row0 + 8
  const bool in0 = row0 < a.Lq, in1 = row0 + 8 < a.Lq;

  // pass 2: dP, dS and dq += dS k
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float* dsb = a.ds ? a.ds + bh * a.Lq * a.Lk : nullptr;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BWD_T;
    __syncthreads();
    bwd_load_tile<DP>(Ks, kb, a.sk.l, k0, a.Lk, a.D);
    bwd_load_tile<DP>(Vs, vb, a.sv.l, k0, a.Lk, a.D);
    blk.stage_keys(k0);
    __syncthreads();
    float dp[8][4];
    bwd_abt<DP>(s, Qs, Ks, wr, g, t);
    bwd_abt<DP>(dp, Gs, Vs, wr, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wr + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        const bool in = e < 2 ? in0 : in1;
        const float x = blk.logit(s[n][e], lr, j, k0);
        const float p = in ? expf(x - (e < 2 ? m0 : m1)) * (e < 2 ? inv0 : inv1) : 0.f;
        const float d = in && blk.live(lr, j, k0) ? p * (dp[n][e] - (e < 2 ? di0 : di1)) : 0.f;
        s[n][e] = d;
        if (dsb && in && k0 + j < a.Lk) dsb[(long long)(q0 + lr) * a.Lk + k0 + j] = d;
      }
    bwd_split_xt<DP>(acc, s, Ks, g, t);
  }

  bwd_store_rows<DP>(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.l, acc, row0, a.Lq, a.D, t,
                     a.scale);
  if (t == 0) {
    if (in0) a.stats[bh * a.Lq + row0] = make_float4(m0, inv0, di0, 0.f);
    if (in1) a.stats[bh * a.Lq + row0 + 8] = make_float4(m1, inv1, di1, 0.f);
  }
}

template <int DP, class P>
__global__ void __launch_bounds__(BWD_NT)
attn_bwd_dkdv(const BwdArgs a, const P policy) {
  constexpr int S = DP + 8, TILE = BWD_T * S;
  extern __shared__ float4 bwd_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* Gs = Qs + TILE;
  __nv_bfloat16* Ks = Gs + TILE;
  __nv_bfloat16* Vs = Ks + TILE;
  float4* St = reinterpret_cast<float4*>(Vs + TILE);  // the query tile's stats
  char* psm = reinterpret_cast<char*>(St + BWD_T);

  const int k0 = blockIdx.x * BWD_T, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wk = 16 * warp;  // the warp's first tile key
  const long long bh = (long long)b * a.H + h;
  const __nv_bfloat16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* gb = a.g + b * a.sg.b + h * a.sg.h;

  bwd_load_tile<DP>(Ks, a.k + b * a.sk.b + h * a.sk.h, a.sk.l, k0, a.Lk, a.D);
  bwd_load_tile<DP>(Vs, a.v + b * a.sv.b + h * a.sv.h, a.sv.l, k0, a.Lk, a.D);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  const typename P::KeyBlock kb = policy.key_block(psm, b, h, k0);
  const int n_qt = (a.Lq + BWD_T - 1) / BWD_T;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BWD_T;
    __syncthreads();  // the readers of Qs / Gs / St and the query tile's data before are done
    bwd_load_tile<DP>(Qs, qb, a.sq.l, q0, a.Lq, a.D);
    bwd_load_tile<DP>(Gs, gb, a.sg.l, q0, a.Lq, a.D);
    if (threadIdx.x < BWD_T)
      St[threadIdx.x] = q0 + (int)threadIdx.x < a.Lq ? a.stats[bh * a.Lq + q0 + threadIdx.x]
                                                     : make_float4(0.f, 1.f, 0.f, 0.f);
    kb.stage_rows(q0);
    __syncthreads();

    // S^T and dP^T: rows = keys wk + g (+ 8), columns = query rows 8n + 2t (+ 1)
    float st[8][4], dpt[8][4];
    bwd_abt<DP>(st, Ks, Qs, wk, g, t);
    bwd_abt<DP>(dpt, Vs, Gs, wk, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = wk + g + 8 * (e >> 1), lr = 8 * n + 2 * t + (e & 1);
        const float4 r = St[lr];
        const bool in = q0 + lr < a.Lq;
        const float x = kb.logit(st[n][e], lr, j, q0);
        const float p = in ? expf(x - r.x) * r.y : 0.f;
        dpt[n][e] = in && kb.live(lr, j, q0) ? p * (dpt[n][e] - r.z) : 0.f;
        st[n][e] = p;
      }

    // dv += P^T g: P^T's accumulator layout of two 8-query blocks is the A
    // layout of one 16-query step; g's rows 2t, 2t + 1 (+ 8) pair up as B
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kq][0], st[2 * kq][1]),
                              pack_bf16(st[2 * kq][2], st[2 * kq][3]),
                              pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]),
                              pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const __nv_bfloat16* p = Gs + (16 * kq + 2 * t) * S + 8 * dn + g;
        mma_bf16(dv[dn], pa, pack2(p, p + S), pack2(p + 8 * S, p + 9 * S));
      }
    }
    // dk += dS^T q
    bwd_split_xt<DP>(dk, dpt, Qs, g, t);
  }

  const int key0 = k0 + wk + g;
  bwd_store_rows<DP>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.l, dk, key0, a.Lk, a.D, t,
                     a.scale);
  bwd_store_rows<DP>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.l, dv, key0, a.Lk, a.D, t, 1.f);
}

// The arguments from the entry points' pointers and strides: q, k, v, o, g,
// dq, dk, dv, each (b, h, l) at s[0..23].
inline BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* o,
                        const void* g, void* dq, void* dk, void* dv, void* stats, void* ds,
                        const long long* s, int B, int H, int Lq, int Lk, int D, float scale) {
  using bf = __nv_bfloat16;
  BwdArgs a;
  a.q = static_cast<const bf*>(q);
  a.k = static_cast<const bf*>(k);
  a.v = static_cast<const bf*>(v);
  a.o = static_cast<const bf*>(o);
  a.g = static_cast<const bf*>(g);
  a.dq = static_cast<bf*>(dq);
  a.dk = static_cast<bf*>(dk);
  a.dv = static_cast<bf*>(dv);
  a.stats = static_cast<float4*>(stats);
  a.ds = static_cast<float*>(ds);
  Strides* st[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sg, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *st[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  return a;
}

template <int DP, class P>
int launch_bwd_dp(const BwdArgs& a, const P& policy, cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<DP, P>();
  const auto k_dq = attn_bwd_dq<DP, P>;
  const auto k_dkdv = attn_bwd_dkdv<DP, P>;
  cudaError_t err = prepare(reinterpret_cast<const void*>(k_dq), BWD_NT, bytes, nullptr, nullptr);
  if (err == cudaSuccess)
    err = prepare(reinterpret_cast<const void*>(k_dkdv), BWD_NT, bytes, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  k_dq<<<dim3((a.Lq + BWD_T - 1) / BWD_T, a.H, a.B), BWD_NT, bytes, stream>>>(a, policy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // reads the stats the first kernel wrote: same stream, so after it
  k_dkdv<<<dim3((a.Lk + BWD_T - 1) / BWD_T, a.H, a.B), BWD_NT, bytes, stream>>>(a, policy);
  return (int)cudaGetLastError();
}

// Returns 0 once both kernels are launched, else a CUDA error.
template <class P>
int launch_bwd(const BwdArgs& a, const P& policy, cudaStream_t stream) {
  if (a.D <= 0 || a.D > 128 || a.D % 8 != 0 || a.Lq <= 0 || a.Lk <= 0 || a.H > 65535 ||
      a.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.D <= 64) return launch_bwd_dp<64>(a, policy, stream);
  return launch_bwd_dp<128>(a, policy, stream);
}

}  // namespace attn
