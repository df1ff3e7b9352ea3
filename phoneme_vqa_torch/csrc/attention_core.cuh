// Online-softmax attention forward shared by the port's attention kernels
// (sm_90a). A kernel source supplies a logit policy (what is added to, or
// replaces, the raw product q.k) and instantiates the core with it.
//
// q, k, v and out are (B, H, L, D) by element strides (b, h, l) with a unit
// stride along D, so a transposed view of (B, L, H, D) storage - the models'
// own layout - is read and written in place. Output in q's dtype.
//
// bf16 path: TMA + wgmma over work items (q tile of TQ = 64 * NC rows, h, b).
// * Roles. NC consumer warpgroups (wgmma's M = 64 query rows each) and one
//   producer warp. The producer loads each item's Q tile into one of two
//   slots and keeps two rings of up to MAX_STAGES stages in flight with
//   cp.async.bulk.tensor (TMA): K (with the policy's tile and the key
//   tile's fix-ups) and V, each stage guarded by a full/empty mbarrier pair.
//   A K stage frees as soon as the tile's logits are made, its V stage once
//   the tile's P V has run, so the next tile's K load never waits on a P V.
//   It reads a tile's mask / cell ids before it waits for a free stage, so
//   those loads overlap the wait.
// * Grid. Persistent: as many blocks as fit on the card at once, each
//   walking items with the q tile fastest (blocks on one (b, h) share its
//   K/V in L2); the producer fetches the next item's Q and K/V while the
//   consumers finish the current one, and the output's TMA store runs on
//   into the next item.
// * Copies. 4-D tensor maps (D, L, H, B) over the caller's strides, boxes of
//   64 columns (128 bytes, 128B swizzle) by 64 or TQ rows. TMA zero-fills
//   rows past L inside each (b, h) and columns past D, so D pads to DP
//   (64 or 128) and ragged tiles need no code. The policy's per-tile data
//   (a bias tile by TMA, the key tile's fix-ups by the producer's lanes) rides
//   in the K stage, so no logit reads device memory; a tile with no masked
//   key and none past Lk is marked clean and skips the fix-ups.
// * S = Q K^T: wgmma m64n64k16, A = Q and B = the K tile, both K-major from
//   swizzled shared memory. Online softmax in f32 on the accumulator layout
//   (exp2; the policy's factor to log2 units - log2(e), times the scale on
//   a clean tile - rides in the exponent's FMA; one divide at the end); P
//   is rounded to bf16, as the plain version casts the exp tensor to v's
//   dtype.
// * O += P V: wgmma with A = P from registers and B = the V tile read
//   MN-major through the descriptor's transpose bit: V is never transposed.
// * The output tile goes out through shared memory and one TMA store per 64
//   columns, which clips rows past Lq and columns past D.
// What bounds it: bytes at the serving shapes (see the kernel sources), but
// the kernel runs at 2.3-4.5x that bound. The copies alone come near it
// where no bias tile rides along; the rest is each warpgroup's
// S -> logits -> softmax -> P V chain, latency-bound with two consumer
// warpgroups an SM (the register cap of two blocks an SM). Two consumer
// warpgroups a block (one block an SM) measured no faster, nor did a grid
// of one block per item, nor issuing a tile's P V beside the next tile's
// softmax as FlashAttention-3 does (PERF.md), so a block has one consumer
// warpgroup and a tile's P V runs right after its own softmax.
//
// f32 path: CUDA-core FMAs, one 128-thread block per 64 query rows, K/V
// streamed through shared memory with plain loads; it keeps f32 inputs exact
// (no TF32) and serves the f32 parity checks and f32 models.
//
// A logit policy P, passed to the kernel by value, gives both paths:
// f32 path:
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
// bf16 path:
//   bool encode(H)                        host: build the policy's tensor map
//   prefetch()                            producer lane 0: prefetch that map
//   int tile_bytes()                      bytes its TMA adds to each stage
//   P::kBlockBytes                        shared memory it needs per block
//   Keys load_keys(b, k0, lane)           producer lane: its keys' data, in registers
//   bool store_keys(info, keys, k0, lane) producer lane: its keys' fix-ups
//                                         (key_fixup) into the stage; true if
//                                         one is masked or past Lk
//   produce_tile(dst, bar, b, h, q0, k0)  producer lane 0: the TMA of its tile
//   prepare_rows(blk, b, h, q0, r0, wt)   a consumer warpgroup (thread wt of
//                                         128) stages block rows r0..r0+63
//   float apply_logits(s, tile, info, blk, lr0, q0, k0, t, clean)
//                                         turns a thread's 32 raw products
//                                         (block rows lr0, lr0 + 8; keys
//                                         k0 + 8n + 2t + {0, 1}) into values
//                                         whose logits in log2 units are the
//                                         returned factor (> 0) times them;
//                                         `clean` (no key of the tile masked
//                                         or past Lk) lets it skip the
//                                         fix-ups
// Keys past Lk get -inf and every tile holds at least one real key, so the
// running max is finite after the first tile; a fully masked row (every key
// -1e9) averages v over the Lk real keys, as the plain version does.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int BQ = 64;      // f32 path: query rows per block
constexpr int BK = 64;      // keys per streamed tile (both paths)
constexpr int NT = 128;     // f32 path: threads per block
constexpr int QS = BQ + 4;  // f32 path: row stride of the d-major q tile (pads banks)
constexpr int KS = BK + 4;  // f32 path: row stride of the d-major k tile
constexpr int PS = BQ + 4;  // f32 path: row stride of the key-major P tile
constexpr float NEG_INF_LOGIT = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// Element strides of a (B, H, L, D) tensor whose D stride is 1.
struct Strides {
  long long b, h, l;
};
struct Layout {
  Strides q, k, v, o;
};

// f32 path: key flags a policy stages per key tile.
constexpr uint8_t KEY_ATTEND = 0, KEY_MASKED = 1, KEY_PAST_L = 2;

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
                     const float* __restrict__ v, float* __restrict__ out, const Layout lay,
                     int Lq, int Lk, int D, const P policy) {
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
  const float* qb = q + b * lay.q.b + h * lay.q.h;
  const float* kb = k + b * lay.k.b + h * lay.k.h;
  const float* vb = v + b * lay.v.b + h * lay.v.h;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    const int row = q0 + r;
    Qs[d * QS + r] = (row < Lq && d < D) ? qb[row * lay.q.l + d] : 0.f;
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
      Ks[d * KS + j] = in ? kb[key * lay.k.l + d] : 0.f;
      Vs[j * DP + d] = in ? vb[key * lay.v.l + d] : 0.f;
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

  float* ob = out + b * lay.o.b + h * lay.o.h;
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
        if (d < D) ob[row * lay.o.l + d] = o[i][c * 4 + e] * inv;
      }
  }
}

// ------------------------------------------------ bf16 path: TMA + wgmma

constexpr int NC = 1;                  // consumer warpgroups per block
constexpr int MAX_STAGES = 3;          // K/V ring depth (less if shared memory is short)
constexpr int MIN_BLOCKS = 2;          // blocks an SM should hold (registers and ring depth follow)
constexpr int TQ = 64 * NC;            // query rows per block
constexpr int NT_TMA = 128 * NC + 32;  // consumers + one producer warp
constexpr int CHUNK = 64;              // bf16 columns per 128-byte swizzled row (one TMA box)
constexpr int INFO_BYTES = 1024;       // per stage: the key tile's fix-ups (and cell ids)
constexpr int INFO_CLEAN = INFO_BYTES - 4;  // of it, a u32: 1 if no key is masked or past Lk

// A key's fix-up of its logit x, applied as fmaf(x, keep, repl): (1, 0)
// keeps x, (0, -1e9) replaces it (a masked key), (0, -inf) drops a key past
// Lk. x is finite, so one FMA does what two compares and selects did.
__device__ __forceinline__ float2 key_fixup(bool past, bool masked) {
  return past ? make_float2(0.f, -INFINITY)
              : masked ? make_float2(0.f, NEG_INF_LOGIT) : make_float2(1.f, 0.f);
}

// Applies the fix-ups at `fix` (a float2 per key of the tile) to a
// thread's 32 logits, keys 8n + 2t + {0, 1} of rows lr0 and lr0 + 8.
__device__ __forceinline__ void apply_fixups(float (&s)[32], const uint8_t* fix, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float4 f = *reinterpret_cast<const float4*>(fix + (8 * n + 2 * t) * 8);
    s[4 * n] = fmaf(s[4 * n], f.x, f.y);
    s[4 * n + 1] = fmaf(s[4 * n + 1], f.z, f.w);
    s[4 * n + 2] = fmaf(s[4 * n + 2], f.x, f.y);
    s[4 * n + 3] = fmaf(s[4 * n + 3], f.z, f.w);
  }
}
constexpr int SMEM_LIMIT = 232448;     // shared memory a block may opt in to (H100)
constexpr int SM_SMEM = 233472;        // shared memory of an SM (H100)
constexpr int BLOCK_RESERVED = 1024;   // of it, reserved by the system for each block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of the given parity has completed. A wait that
// outlasts any real copy or tile (2^22 polls, each suspending the thread up
// to a hardware time limit) traps: a pipeline fault becomes a launch error,
// not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 22)) __trap();
}

// A box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Brings a tensor map (a kernel parameter) into the TMA unit's cache.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the registers of an
// in-flight wgmma across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// D (64 x 64, f32) (+)= A (64 x 16, shared memory) * B (16 x 64, shared memory); both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Element pair (r, c), (r, c + 1) of a tile of `rows` rows that TMA stored as
// 128-byte swizzled boxes of 128 / sizeof(T) columns each.
template <typename T>
__device__ __forceinline__ float2 swizzled_pair(const uint8_t* tile, int rows, int r, int c) {
  constexpr int EPB = 128 / sizeof(T);
  const int byte = (c % EPB) * int(sizeof(T));
  const uint8_t* p = tile + (c / EPB) * rows * 128 + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) +
                     (byte & 15);
  if constexpr (sizeof(T) == 4) return *reinterpret_cast<const float2*>(p);
  else return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// O += P V over one key tile as one committed wgmma group: A = P from
// registers, B = the tile's V at shared address v (DP / 64 boxes of 64 keys
// x 128 B, BK * 128 bytes apart) read MN-major through the transpose bit.
template <int N>
__device__ __forceinline__ void pv(float (&o)[N], const uint32_t (&pa)[BK / 16][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // 16 keys = two 8-row groups (SBO 1024 B); 64-column boxes LBO apart
    const uint64_t dv = desc128(v + kk * 16 * 128, BK * 128, 1024);
    if constexpr (N == 32) wgmma_rs_n64(o, pa[kk], dv);
    else wgmma_rs_n128(o, pa[kk], dv);
  }
  wgmma_commit();
}

struct TmaArgs {
  CUtensorMap q, k, v, o;  // (D, L, H, B) bf16; boxes {64, TQ} (q), {64, BK} (k, v), {64, 64} (o)
  int Lq, Lk, H, B;
};

// One block walks work items w = blockIdx.x, + gridDim.x, ...: (q tile,
// h, b) with the q tile fastest, so the blocks working on one (b, h) at a
// time share its K/V in L2. The grid is persistent (as many blocks as fit
// on the card at once, or one per item where there are fewer), so the
// producer loads an item's Q and first K/V tiles while the consumers still
// work on the one before.
// Shared memory (from a 1024-byte aligned base): two Q slots (each DP / 64
// boxes of TQ x 128 B), the output tile (the same shape), the K ring (per
// stage: K as DP / 64 boxes of BK x 128 B, then the policy's tile), the V
// ring (V, the same shape as K), the K stages' key info, the policy's block
// data, the barriers. K and V of a tile share a stage index but not a
// barrier pair: a K stage frees once the tile's S has run and its logits
// are made, its V stage once the tile's P V has run. A Q slot is free once
// the item's last S has run; the output tile's TMA store runs on while the
// next item starts and is waited for only before the tile is written again.
// DP = 128 asks for one block an SM: its registers (o alone is 64 a
// thread) would spill under the cap of two, and its shared memory rarely
// leaves room for two blocks anyway.
template <int DP, class P>
__global__ void __launch_bounds__(NT_TMA, DP == 64 ? MIN_BLOCKS : 1)
attention_tma_kernel(const __grid_constant__ TmaArgs a, const __grid_constant__ P policy,
                     int stages, int k_stage_bytes) {
  constexpr int NCH = DP / CHUNK;
  constexpr int Q_BYTES = NCH * TQ * 128;   // one Q slot
  constexpr int KV_BYTES = NCH * BK * 128;  // one K or V tile
  constexpr int M = MAX_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                            ~uintptr_t(1023));
  uint8_t* out_s = q_s + 2 * Q_BYTES;
  uint8_t* k_ring = out_s + Q_BYTES;
  uint8_t* v_ring = k_ring + stages * k_stage_bytes;
  uint8_t* info = v_ring + stages * KV_BYTES;
  uint8_t* blk = info + stages * INFO_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(blk + P::kBlockBytes);
  const auto full_k = [&](int s) { return smem_addr(bars + s); };
  const auto empty_k = [&](int s) { return smem_addr(bars + M + s); };
  const auto full_v = [&](int s) { return smem_addr(bars + 2 * M + s); };
  const auto empty_v = [&](int s) { return smem_addr(bars + 3 * M + s); };
  const auto q_full = [&](int slot) { return smem_addr(bars + 4 * M + slot); };
  const auto q_empty = [&](int slot) { return smem_addr(bars + 4 * M + 2 + slot); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (a.Lq + TQ - 1) / TQ, n_items = n_qt * a.H * a.B;
  const int n_tiles = (a.Lk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_k(s), 33);       // the TMA's expect_tx, then every producer lane
      mbar_init(empty_k(s), 4 * NC);  // lane 0 of every consumer warp
      mbar_init(full_v(s), 1);        // the TMA's expect_tx
      mbar_init(empty_v(s), 4 * NC);
    }
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(q_full(slot), 1);
      mbar_init(q_empty(slot), NC);  // thread 0 of every consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer warp
    if (lane == 0) {
      prefetch_map(&a.q);
      prefetch_map(&a.k);
      prefetch_map(&a.v);
      prefetch_map(&a.o);
      policy.prefetch();
    }
    const int tile_bytes = policy.tile_bytes();
    int s = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x, i = 0; w < n_items; w += gridDim.x, ++i) {
      const int q0 = (w % n_qt) * TQ, h = (w / n_qt) % a.H, b = w / (n_qt * a.H);
      if (lane == 0) {
        const int slot = i & 1;
        mbar_wait(q_empty(slot), ((i >> 1) & 1) ^ 1);
        mbar_arrive_tx(q_full(slot), Q_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(q_s + slot * Q_BYTES + c * TQ * 128, &a.q, q_full(slot), c * CHUNK, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        uint8_t* ks = k_ring + s * k_stage_bytes;
        // the key tile's data from device memory while the stage drains
        const typename P::Keys keys = policy.load_keys(b, j * BK, lane);
        mbar_wait(empty_k(s), phase ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full_k(s), KV_BYTES + tile_bytes);
          for (int c = 0; c < NCH; ++c)
            tma_load(ks + c * BK * 128, &a.k, full_k(s), c * CHUNK, j * BK, h, b);
          policy.produce_tile(ks + KV_BYTES, full_k(s), b, h, q0, j * BK);
        }
        // the tile is clean when none of its keys is masked or past Lk
        const bool special = policy.store_keys(info + s * INFO_BYTES, keys, j * BK, lane);
        const uint32_t any = __ballot_sync(0xffffffffu, special);
        if (lane == 0) *reinterpret_cast<uint32_t*>(info + s * INFO_BYTES + INFO_CLEAN) = any == 0;
        mbar_arrive(full_k(s));
        // V, read by the tile's P V a tile later
        mbar_wait(empty_v(s), phase ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full_v(s), KV_BYTES);
          for (int c = 0; c < NCH; ++c)
            tma_load(v_ring + s * KV_BYTES + c * BK * 128, &a.v, full_v(s), c * CHUNK, j * BK, h,
                     b);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroup wg: block rows wg * 64 .. + 63; this thread's rows
    // lr0 and lr0 + 8, columns 2t, 2t + 1 of every 8-column block
    const int wg = warp >> 2, wt = tid & 127;
    const int g = lane >> 2, t = lane & 3;
    const int lr0 = wg * 64 + (warp & 3) * 16 + g;
    int s = 0;
    uint32_t phase = 0;
    // wgmma's S accumulator; its values going in are never read (the first
    // k-step of every tile does not accumulate)
    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    for (int w = blockIdx.x, i = 0; w < n_items; w += gridDim.x, ++i) {
      const int q0 = (w % n_qt) * TQ, h = (w / n_qt) % a.H, b = w / (n_qt * a.H);
      const int slot = i & 1;
      // the warpgroup's rows of the item before are done (its epilogue barrier)
      policy.prepare_rows(blk, b, h, q0, wg * 64, wt);
      named_sync(1 + wg, 128);
      mbar_wait(q_full(slot), (i >> 1) & 1);

      uint8_t* q_slot = q_s + slot * Q_BYTES;
      const uint32_t q_base = smem_addr(q_slot) + wg * 64 * 128;
      float o[DP / 2];
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) o[r] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units; partial sums
      for (int j = 0; j < n_tiles; ++j) {
        const uint8_t* ks = k_ring + s * k_stage_bytes;
        const uint32_t ks_addr = smem_addr(ks);
        mbar_wait(full_k(s), phase);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          // 16 columns of d: box kk / 4, then 32 bytes into its swizzled rows
          const uint32_t col = (kk % 4) * 32;
          wgmma_ss_n64(sc, desc128(q_base + (kk / 4) * TQ * 128 + col, 16, 1024),
                       desc128(ks_addr + (kk / 4) * BK * 128 + col, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        const uint8_t* inf = info + s * INFO_BYTES;
        // the logits in log2 units are kl * sc[]
        const float kl = policy.apply_logits(
            sc, ks + KV_BYTES, inf, blk, lr0, q0, j * BK, t,
            *reinterpret_cast<const uint32_t*>(inf + INFO_CLEAN) != 0);
        // the K stage (K, the policy's tile, the key info) is read
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_k(s));

        // online softmax over rows lr0 (sc[4n], sc[4n+1]) and lr0 + 8
        // (sc[4n+2], sc[4n+3]) in log2 units, with kl > 0 folded into the
        // max and the exponent's FMA; a row's 64 keys sit in the 4 lanes of
        // one g
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0 * kl), mn1 = fmaxf(m1, mx1 * kl);  // finite: a real key
        const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);  // 0 on the first tile
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sc[4 * n] = fast_exp2(fmaf(sc[4 * n], kl, -mn0));
          sc[4 * n + 1] = fast_exp2(fmaf(sc[4 * n + 1], kl, -mn0));
          sc[4 * n + 2] = fast_exp2(fmaf(sc[4 * n + 2], kl, -mn1));
          sc[4 * n + 3] = fast_exp2(fmaf(sc[4 * n + 3], kl, -mn1));
          sum0 += sc[4 * n] + sc[4 * n + 1];
          sum1 += sc[4 * n + 2] + sc[4 * n + 3];
        }
        l0 = l0 * al0 + sum0;
        l1 = l1 * al1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int r = 0; r < DP / 8; ++r) {
          o[4 * r] *= al0;
          o[4 * r + 1] *= al0;
          o[4 * r + 2] *= al1;
          o[4 * r + 3] *= al1;
        }
        // P as wgmma's A fragments: the accumulator layout of two 8-key
        // blocks is the A layout of one 16-key step
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        mbar_wait(full_v(s), phase);
        fence_regs(o);
        wgmma_fence();
        pv(o, pa, smem_addr(v_ring + s * KV_BYTES));
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v(s));
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }

      // the warpgroup's last S has run: its rows of the Q slot are free
      if (wt == 0) mbar_arrive(q_empty(slot));

      // epilogue: O / l in bf16 into this warpgroup's rows of the output
      // tile (Q's swizzle), then one TMA store per 64 columns, once the
      // store of the item before has read the tile
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      if (wt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg, 128);
      uint8_t* o_s = out_s + wg * 64 * 128;
      const int r = (warp & 3) * 16 + g;  // row within the warpgroup's 64; r % 8 == g
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        uint8_t* p = o_s + (c / 8) * TQ * 128 + r * 128 + (((c % 8) ^ g) << 4) + 4 * t;
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[4 * c] * inv0, o[4 * c + 1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
            __floats2bfloat162_rn(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (wt == 0 && q0 + wg * 64 < a.Lq) {
        for (int c = 0; c < NCH; ++c)
          tma_store(&a.o, o_s + c * TQ * 128, c * CHUNK, q0 + wg * 64, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the block's shared memory must outlive the last store's read of it
    if (wt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D tensor map (cols, rows, heads, batch) over `base`, element strides of
// rows, heads and batch, box {box_cols, box_rows, 1, 1}; out-of-bounds
// elements read as zero and are not written. A dimension of extent 1 is never
// stepped, so its stride (any value, 0 included) is replaced by one TMA takes.
inline bool encode_4d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elsize,
                      long long cols, long long rows, long long heads, long long batch,
                      long long s_row, long long s_head, long long s_batch, int box_cols,
                      int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const long long steps[3] = {s_row, s_head, s_batch};
  long long span = cols * elsize;  // bytes up to the end of the farthest element
  for (int i = 0; i < 3; ++i) span += (dims[i + 1] - 1) * steps[i] * elsize;
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? cuuint64_t((span + 15) / 16 * 16) : cuuint64_t(steps[i] * elsize);
  const cuuint32_t box[4] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// Opts `kernel` in to all the dynamic shared memory a block may have on the
// current device and returns, through `per_sm` (when not null), how many of
// its blocks of `threads` threads and `bytes` bytes an SM holds, and through
// `sms` the device's SM count. Each is asked of the runtime once per
// (thread, kernel, device, bytes) and remembered: asked on every launch, they
// cost about as much host time as the launch itself.
inline cudaError_t prepare(const void* kernel, int threads, int bytes, int* per_sm, int* sms) {
  struct Seen {
    const void* kernel;
    int device, bytes, per_sm, sms;
  };
  constexpr int N = 32;
  static thread_local Seen seen[N];
  static thread_local int n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  bool opted_in = false;
  for (int i = 0; i < (n_seen < N ? n_seen : N); ++i) {
    const Seen& s = seen[i];
    if (s.kernel != kernel || s.device != device) continue;
    opted_in = true;
    if (s.bytes == bytes) {
      if (per_sm) *per_sm = s.per_sm;
      if (sms) *sms = s.sms;
      return cudaSuccess;
    }
  }
  if (!opted_in && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_LIMIT)) != cudaSuccess)
    return err;
  Seen s{kernel, device, bytes, 0, 0};
  if ((err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel, threads, bytes)) !=
          cudaSuccess)
    return err;
  seen[n_seen++ % N] = s;
  if (per_sm) *per_sm = s.per_sm;
  if (sms) *sms = s.sms;
  return cudaSuccess;
}

// Error returned when a tensor map cannot be encoded (a layout TMA refuses).
constexpr int ERR_TENSOR_MAP = 1000;

template <int DP, class P>
int launch_tma(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
               int Lk, int D, const Layout& lay, P policy, cudaStream_t stream) {
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  TmaArgs a;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.B = B;
  if (!encode_4d(&a.q, q, bf16, 2, D, Lq, H, B, lay.q.l, lay.q.h, lay.q.b, CHUNK, TQ, sw) ||
      !encode_4d(&a.k, k, bf16, 2, D, Lk, H, B, lay.k.l, lay.k.h, lay.k.b, CHUNK, BK, sw) ||
      !encode_4d(&a.v, v, bf16, 2, D, Lk, H, B, lay.v.l, lay.v.h, lay.v.b, CHUNK, BK, sw) ||
      !encode_4d(&a.o, out, bf16, 2, D, Lq, H, B, lay.o.l, lay.o.h, lay.o.b, CHUNK, 64, sw) ||
      !policy.encode(H))
    return ERR_TENSOR_MAP;
  // ring depth: the most stages (up to MAX_STAGES) that leave room for
  // MIN_BLOCKS blocks an SM, else for the most blocks that can still hold 2
  // stages, else the most one block can hold
  const int k_stage_bytes = (DP / CHUNK) * BK * 128 + round1024(policy.tile_bytes());
  const int stage_bytes = k_stage_bytes + (DP / CHUNK) * BK * 128;  // K and V
  const int fixed =
      1024 + 3 * (DP / CHUNK) * TQ * 128 + P::kBlockBytes + 8 * (4 * MAX_STAGES + 4);
  const auto fit = [&](int budget) {
    const int n = (budget - fixed) / (stage_bytes + INFO_BYTES);
    return n < MAX_STAGES ? n : MAX_STAGES;
  };
  int stages = 0;
  for (int blocks = MIN_BLOCKS; blocks > 1 && stages < 2; --blocks)
    stages = fit(SM_SMEM / blocks - BLOCK_RESERVED);
  if (stages < 2) stages = fit(SMEM_LIMIT);
  if (stages < 2) return (int)cudaErrorInvalidValue;  // a tile's P V overlaps the next S
  const int bytes = fixed + stages * (stage_bytes + INFO_BYTES);
  const auto kernel = attention_tma_kernel<DP, P>;
  int per_sm = 0, sms = 0;
  const cudaError_t err =
      prepare(reinterpret_cast<const void*>(kernel), NT_TMA, bytes, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int n_items = (Lq + TQ - 1) / TQ * H * B;
  const int grid = sms * per_sm < n_items ? sms * per_sm : n_items;  // persistent
  kernel<<<grid, NT_TMA, bytes, stream>>>(a, policy, stages, k_stage_bytes);
  return (int)cudaGetLastError();
}

// Opt in to the kernel's dynamic shared memory (needed above 48 KB) on the
// current device, then launch.
template <int DP, class P>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
               int Lk, int D, const Layout& lay, const P& policy, cudaStream_t stream) {
  const size_t bytes = f32_core_bytes<DP>() + P::kSmemBytes;
  const auto kernel = attention_f32_kernel<DP, P>;
  const cudaError_t err =
      prepare(reinterpret_cast<const void*>(kernel), NT, (int)bytes, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(out), lay,
                                      Lq, Lk, D, policy);
  return (int)cudaGetLastError();
}

// q (B,H,Lq,D), k and v (B,H,Lk,D) and out (B,H,Lq,D) by element strides
// `lay` (unit D stride; strides and starts 16-byte aligned), D a multiple of
// 8 and at most 128; is_bf16 selects bf16 tensors (TMA + wgmma), else f32.
// Returns 0 once launched, else a CUDA error or ERR_TENSOR_MAP.
template <class P>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq, int Lk,
           int D, const Layout& lay, int is_bf16, const P& policy, cudaStream_t stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D <= 64) return launch_tma<64>(q, k, v, out, B, H, Lq, Lk, D, lay, policy, stream);
    return launch_tma<128>(q, k, v, out, B, H, Lq, Lk, D, lay, policy, stream);
  }
  if (D <= 32) return launch_f32<32>(q, k, v, out, B, H, Lq, Lk, D, lay, policy, stream);
  if (D <= 64) return launch_f32<64>(q, k, v, out, B, H, Lq, Lk, D, lay, policy, stream);
  return launch_f32<128>(q, k, v, out, B, H, Lq, Lk, D, lay, policy, stream);
}

}  // namespace attn
