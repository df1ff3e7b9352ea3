// SaL encoder self-attention with the 2D position bias fused in, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: phoneme_vqa_tpu/ops/sal_fused_attention.py: sal_fused_attention
// (the Pallas kernel _kernel), reached through ops/attention.py:
// dot_product_attention with a FusedSalBias: every SaL encoder layer.
//
// Computes, per (b, h), with Lq == Lk == L, no scale and no causal mask:
//   bias[q, k] = bias1d[h, q, k] + cell_bias[h, cell[b, q], cell[b, k]]
//   out = softmax(q k^T + bias; masked keys -> -1e9) v
// The bias is rebuilt inside the tile from its three factors, so the
// (B, H, L, L) f32 bias of the plain version is never written. The two
// table terms are widened to f32 and added first, and that sum is added to
// the f32 logit, in the order of materialize_sal_bias + reference_attention,
// so the bias is bit-equal to the plain one at table precision. A cell id
// outside [0, C) is read as C - 1, the zero sentinel row and column (the
// plain version clamps ids above C - 1; the model gives no negative ids).
// A masked key's logit is REPLACED by -1e9; keys past L in the kernel's own
// tiling get -inf, so a fully masked row averages v over the L real keys,
// as the plain version does. (The Pallas kernel pads keys to 128 with mask 0
// and averages such a row over its padded keys too.)
//
// What bounds it: at the SaL-base serving shape (B=32, H=12, L=336, D=64,
// bf16) q, k, v and out are 4 * 32*12*336*64*2 B = 66.1 MB, bias1d 2.7 MB,
// cell_bias, cell and the mask 0.5 MB: ~69.3 MB, ~20.7 us at 3.35 TB/s,
// against 4*32*12*336^2*64 = 11.1 GFLOP, ~11.2 us at 989 TFLOP/s. Bytes
// bound it; the plain version writes and re-reads a 173 MB f32 bias on top.
//
// Design: the core of attention_core.cuh with the logit policy SalBias. The
// TPU kernel picks cell_bias rows and columns with one-hot matmuls (an MXU
// device); here the per-pair term is a gather from shared memory.
// * bf16 (TMA + wgmma): each consumer warpgroup stages, once per work item,
//   the table rows of its 64 query rows' cells in the table's own type (bf16
//   widens to f32 exactly on read): Rt[r][c] = cell_bias[h, cell[b, q0 + r],
//   c], 64 x 130 values, 16.6 KB in bf16 (half the size of f32 rows).
//   In each K stage the producer warp stages the bias1d[h] (TQ x 64) tile by
//   TMA (128B-swizzled; shared by every b, so it stays in L2) and the key
//   tile's clamped cell ids and fix-ups (keep, or replace by -1e9 / -inf).
//   A logit then reads only shared memory: the bias1d tile, Ck[j] and
//   Rt[r][Ck[j]], in one straight pass; the fix-ups take one FMA each, only
//   on a tile with a masked key or one past L. TMA needs bias1d's rows 16-byte aligned (L % 8 == 0 in bf16,
//   L % 4 in f32, or a padded row stride): the wrapper copies a bias1d that
//   is not.
//   What holds it back (PERF.md): the copies (K, V, the bias1d tile, the
//   table rows of every item) take half the kernel, the logits (a gather
//   per element) a third.
// * f32 (CUDA-core FMAs): the table rows widened to f32 (64 x 129), the key
//   tile's cell ids and flags in shared memory, bias1d read per logit.
// All shared memory is dynamic, opted in above 48 KB with
// cudaFuncSetAttribute.

#include "attention_bwd.cuh"

#include <type_traits>

constexpr int CMAX = 128;     // widest cell table taken (the TPU kernel's CELL_DIM)
constexpr int RS = CMAX + 1;  // f32 path: f32 per row of the staged table rows Rt

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 to_f2(float2 x) { return x; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) { return __bfloat1622float2(x); }

// Two table values, of block rows r and r + 8, in the table's type.
template <typename TB>
using Pair = typename std::conditional<sizeof(TB) == 4, float2, __nv_bfloat162>::type;

__device__ __forceinline__ int clamp_cell(int c, int C) {
  return (unsigned)c < (unsigned)C ? c : C - 1;
}

// The logit policy: the SaL bias from its factors, the key mask. TB is the
// tables' type (f32 or bf16).
template <typename TB>
struct SalBias {
  const TB* bias1d;     // (H, L, L) by strides (h, row)
  const TB* cell_bias;  // (H, C, C) contiguous
  const int* cell;      // (B, L)
  const int* mask;      // (B, L) or null
  long long b1d_sh, b1d_sl;
  int L, C;
  CUtensorMap b1d_map;  // bf16 path: (L, L, H, 1), boxes {128 / sizeof(TB), TQ}

  // ---- f32 path
  static constexpr size_t kSmemBytes = sizeof(float) * attn::BQ * RS + sizeof(int) * 2 * attn::BK;

  struct Block {
    const TB* b1d;     // bias1d[h]
    const float* Rt;   // (BQ, RS) staged table rows
    int* Ck;           // (BK) this key tile's clamped cell ids
    int* Kf;           // (BK) this key tile's KEY_* flags
    const int* cellb;  // cell[b]
    const int* maskb;  // mask[b] or null
    long long b1d_sl;
    int L, C, q0;

    __device__ __forceinline__ void stage_keys(int k0) const {
      const int j = threadIdx.x;
      if (j < attn::BK) {
        const int key = k0 + j;
        Ck[j] = key < L ? clamp_cell(cellb[key], C) : 0;
        Kf[j] = key >= L                        ? attn::KEY_PAST_L
                : (maskb && maskb[key] == 0) ? attn::KEY_MASKED
                                                : attn::KEY_ATTEND;
      }
    }

    __device__ __forceinline__ float logit(float x, int lr, int j, int k0) const {
      const int f = Kf[j];
      if (f == attn::KEY_PAST_L) return -INFINITY;
      if (f == attn::KEY_MASKED) return attn::NEG_INF_LOGIT;
      const int row = q0 + lr;
      if (row < L) {
        const float bias = to_f(b1d[row * b1d_sl + k0 + j]) + Rt[lr * RS + Ck[j]];
        x = x + bias;
      }
      return x;
    }

    // backward: whether the logit is the product's (the key neither masked
    // nor past L), so its gradient reaches q, k and the tables
    __device__ __forceinline__ bool live(int, int j, int) const { return Kf[j] == attn::KEY_ATTEND; }
  };

  // Stages the table rows of the block's query cells.
  __device__ __forceinline__ Block block(char* smem, int b, int h, int q0) const {
    float* Rt = reinterpret_cast<float*>(smem);
    int* Ck = reinterpret_cast<int*>(Rt + attn::BQ * RS);
    const int* cellb = cell + (long long)b * L;
    const TB* cbh = cell_bias + (long long)h * C * C;
    for (int idx = threadIdx.x; idx < attn::BQ * C; idx += attn::NT) {
      const int r = idx / C, c = idx % C;
      const int row = q0 + r;
      Rt[r * RS + c] = row < L ? to_f(cbh[(long long)clamp_cell(cellb[row], C) * C + c]) : 0.f;
    }
    return {bias1d + h * b1d_sh, Rt, Ck, Ck + attn::BK, cellb,
            mask ? mask + (long long)b * L : nullptr, b1d_sl, L, C, q0};
  }

  // ---- backward (attention_bwd.cuh): a block that owns key tile k0 and
  // walks the query tiles. It stages once the table's columns of its keys'
  // cells, Ct[j][c] = cell_bias[h, c, cell[b, k0 + j]] widened to f32, and
  // the keys' flags; each query tile then stages only its rows' clamped
  // cell ids, so a logit reads bias1d and Ct[j][Cq[lr]].
  static constexpr size_t kKeySmemBytes =
      sizeof(float) * attn::BK * RS + sizeof(int) * (attn::BQ + attn::BK);

  struct KeyBlock {
    const TB* b1d;     // bias1d[h]
    const float* Ct;   // (BK, RS) the keys' table columns
    int* Cq;           // (BQ) the query tile's clamped cell ids
    const int* Kf;     // (BK) the keys' KEY_* flags
    const int* cellb;  // cell[b]
    long long b1d_sl;
    int L, C, k0;

    // per query tile, between its two barriers
    __device__ __forceinline__ void stage_rows(int q0) const {
      const int r = threadIdx.x;
      if (r < attn::BQ) Cq[r] = q0 + r < L ? clamp_cell(cellb[q0 + r], C) : 0;
    }

    // Block::logit's value for block row lr of the query tile at q0
    __device__ __forceinline__ float logit(float x, int lr, int j, int q0) const {
      const int f = Kf[j];
      if (f == attn::KEY_PAST_L) return -INFINITY;
      if (f == attn::KEY_MASKED) return attn::NEG_INF_LOGIT;
      const int row = q0 + lr;
      if (row < L) {
        const float bias = to_f(b1d[row * b1d_sl + k0 + j]) + Ct[j * RS + Cq[lr]];
        x = x + bias;
      }
      return x;
    }

    __device__ __forceinline__ bool live(int, int j, int) const { return Kf[j] == attn::KEY_ATTEND; }
  };

  // All threads; read after the next barrier. The column gathers go 16 a
  // thread at a time, every load before its store, so the staging costs a
  // few trips to L2; consecutive threads take consecutive keys of one cell
  // column (stores RS floats apart: distinct banks).
  __device__ __forceinline__ KeyBlock key_block(char* smem, int b, int h, int k0) const {
    float* Ct = reinterpret_cast<float*>(smem);
    int* Cq = reinterpret_cast<int*>(Ct + attn::BK * RS);
    int* Kf = Cq + attn::BQ;
    const int* cellb = cell + (long long)b * L;
    const TB* cbh = cell_bias + (long long)h * C * C;
    constexpr int U = 16;
    for (int base = threadIdx.x; base < attn::BK * C; base += U * attn::NT) {
      float vals[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * attn::NT, key = k0 + idx % attn::BK;
        vals[u] = idx < attn::BK * C && key < L
                      ? to_f(cbh[(idx / attn::BK) * C + clamp_cell(cellb[key], C)])
                      : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * attn::NT;
        if (idx < attn::BK * C) Ct[(idx % attn::BK) * RS + idx / attn::BK] = vals[u];
      }
    }
    const int j = threadIdx.x;
    if (j < attn::BK) {
      const int key = k0 + j;
      Kf[j] = key >= L                                ? attn::KEY_PAST_L
              : (mask && mask[(long long)b * L + key] == 0) ? attn::KEY_MASKED
                                                            : attn::KEY_ATTEND;
    }
    return {bias1d + h * b1d_sh, Ct, Cq, Kf, cellb, b1d_sl, L, C, k0};
  }

  // ---- bf16 path: stage info = the keys' fix-ups (BK float2), then Ck (BK
  // ints) at kCellIds. Block data = the table rows as TQ / 2 rows of pairs:
  // pair row p = 8 * (r / 16) + r % 8 holds, for each cell, the values of
  // block rows r and r + 8 (r % 16 < 8), the two rows a thread's logits
  // sit in, so one load gives both. Pair rows RP pairs apart put the 8 pair
  // rows a warp reads at once in different banks.
  static constexpr int kCellIds = 8 * attn::BK;
  static constexpr int RP = CMAX + 1;
  static constexpr int kBlockBytes = attn::TQ / 2 * RP * sizeof(Pair<TB>);

  bool encode(int H) {
    const auto type = sizeof(TB) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    return attn::encode_4d(&b1d_map, bias1d, type, sizeof(TB), L, L, H, 1, b1d_sl, b1d_sh, 0,
                           128 / sizeof(TB), attn::TQ, CU_TENSOR_MAP_SWIZZLE_128B);
  }

  __host__ __device__ int tile_bytes() const { return attn::TQ * attn::BK * sizeof(TB); }

  // a producer lane's keys are k0 + lane and k0 + lane + 32
  struct Keys {
    int c0, c1, m0, m1;  // their cell ids and mask values (1 without a mask)
  };

  __device__ __forceinline__ Keys load_keys(int b, int k0, int lane) const {
    const int key0 = k0 + lane, key1 = key0 + 32;
    const int* cb = cell + (long long)b * L;
    const int* mb = mask + (long long)b * L;
    return {key0 < L ? cb[key0] : 0, key1 < L ? cb[key1] : 0,
            mask && key0 < L ? mb[key0] : 1, mask && key1 < L ? mb[key1] : 1};
  }

  // returns whether either key is masked or past L
  __device__ __forceinline__ bool store_keys(uint8_t* info, const Keys& keys, int k0,
                                             int lane) const {
    float2* fix = reinterpret_cast<float2*>(info);
    int* ck = reinterpret_cast<int*>(info + kCellIds);
    const bool past0 = k0 + lane >= L, past1 = k0 + lane + 32 >= L;
    const bool masked0 = keys.m0 == 0, masked1 = keys.m1 == 0;
    fix[lane] = attn::key_fixup(past0, masked0);
    fix[lane + 32] = attn::key_fixup(past1, masked1);
    ck[lane] = clamp_cell(keys.c0, C);
    ck[lane + 32] = clamp_cell(keys.c1, C);
    return past0 || past1 || masked0 || masked1;
  }

  __device__ __forceinline__ void prefetch() const { attn::prefetch_map(&b1d_map); }

  __device__ __forceinline__ void produce_tile(uint8_t* dst, uint32_t bar, int, int h, int q0,
                                               int k0) const {
    constexpr int EPB = 128 / sizeof(TB);  // columns per 128-byte box
#pragma unroll
    for (int c = 0; c < attn::BK / EPB; ++c)
      attn::tma_load(dst + c * attn::TQ * 128, &b1d_map, bar, k0 + c * EPB, q0, h, 0);
  }

  // Rt rows r0 .. r0 + 63, by the 128 threads of one consumer warpgroup:
  // each warp 16 rows, its lanes along a row. Every load is issued before
  // the first store, so the staging costs two trips to L2, not 32.
  __device__ __forceinline__ void prepare_rows(uint8_t* blk, int b, int h, int q0, int r0,
                                               int wt) const {
    Pair<TB>* Rp = reinterpret_cast<Pair<TB>*>(blk);
    const TB* cbh = cell_bias + (long long)h * C * C;
    const int lane = wt & 31, r1 = r0 + (wt >> 5) * 16;
    const int my_row = q0 + r1 + (lane & 15);
    const int my_cell = my_row < L ? clamp_cell(cell[(long long)b * L + my_row], C) : -1;
    TB vals[16][CMAX / 32];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int c = __shfl_sync(0xffffffffu, my_cell, r);
#pragma unroll
      for (int i = 0; i < CMAX / 32; ++i) {
        const int col = lane + 32 * i;
        vals[r][i] = c >= 0 && col < C ? cbh[c * C + col] : TB(0.f);
      }
    }
    // rows r1 + r and r1 + r + 8 form pair row r1 / 2 + r
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < CMAX / 32; ++i) {
        Pair<TB> v;
        v.x = vals[r][i];
        v.y = vals[r + 8][i];
        Rp[(r1 / 2 + r) * RP + lane + 32 * i] = v;
      }
  }

  // x + (bias1d + table term), then, on a tile that is not clean, the keys'
  // fix-ups; returns log2(e), the factor to log2 units. Each pass is one
  // straight run over the 32 values, so the loads of all of them can be in
  // flight at once.
  __device__ __forceinline__ float apply_logits(float (&s)[32], const uint8_t* tile,
                                                const uint8_t* info, const uint8_t* blk, int lr0,
                                                int, int, int t, bool clean) const {
    const int* ck = reinterpret_cast<const int*>(info + kCellIds);
    // the pair row of block rows lr0 and lr0 + 8
    const Pair<TB>* Rp = reinterpret_cast<const Pair<TB>*>(blk) + (lr0 / 16 * 8 + lr0 % 8) * RP;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = 8 * n + 2 * t;
      const int2 cells = *reinterpret_cast<const int2*>(ck + j);
      const float2 b0 = attn::swizzled_pair<TB>(tile, attn::TQ, lr0, j);
      const float2 b1 = attn::swizzled_pair<TB>(tile, attn::TQ, lr0 + 8, j);
      const float2 c0 = to_f2(Rp[cells.x]), c1 = to_f2(Rp[cells.y]);  // keys j, j + 1
      s[4 * n] += b0.x + c0.x;
      s[4 * n + 1] += b0.y + c1.x;
      s[4 * n + 2] += b1.x + c0.y;
      s[4 * n + 3] += b1.y + c1.y;
    }
    if (!clean) attn::apply_fixups(s, info, t);
    return attn::LOG2E;
  }
};

// Calls run(SalBias<T>{...}) with the tables' type T (bf16 or f32);
// sb = bias1d's element strides (h, row).
template <class Run>
static int with_sal_policy(const void* bias1d, const void* cell_bias, const void* cell,
                           const void* mask, const long long* sb, int L, int C,
                           int table_is_bf16, Run run) {
  const auto make = [&](auto table) {
    using T = decltype(table);
    SalBias<T> p{};
    p.bias1d = static_cast<const T*>(bias1d);
    p.cell_bias = static_cast<const T*>(cell_bias);
    p.cell = static_cast<const int*>(cell);
    p.mask = static_cast<const int*>(mask);
    p.b1d_sh = sb[0];
    p.b1d_sl = sb[1];
    p.L = L;
    p.C = C;
    return run(p);
  };
  return table_is_bf16 ? make(__nv_bfloat16(0.f)) : make(0.f);
}

// Returns 0 once launched, else a CUDA error or attn::ERR_TENSOR_MAP. Shapes
// and layouts are checked by the Python wrapper: q, k, v, out (B,H,L,D) by
// element strides (b, h, l) with a unit D stride, 16-byte aligned starts and
// strides; D a multiple of 8, at most 128; bias1d (H,L,L) by element strides
// (h, row), rows 16-byte aligned, and cell_bias (H,C,C) contiguous, C <= 128,
// in one table type; cell int32 (B,L) and mask int32 (B,L) or null,
// contiguous. strides: q, k, v, out, each (b, h, l), then bias1d (h, row).
// is_bf16 selects bf16 q/k/v/out, else f32; table_is_bf16 selects bf16
// tables, else f32.
extern "C" int sal_fused_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias1d, const void* cell_bias,
                                       const void* cell, const void* mask, void* out, int B,
                                       int H, int L, int D, int C, const long long* strides,
                                       int is_bf16, int table_is_bf16, void* stream) {
  if (C <= 0 || C > CMAX) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const attn::Layout lay{{s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
                         {s[9], s[10], s[11]}};
  const auto st = static_cast<cudaStream_t>(stream);
  return with_sal_policy(bias1d, cell_bias, cell, mask, s + 12, L, C, table_is_bf16,
                         [&](const auto& p) {
                           return attn::launch(q, k, v, out, B, H, L, L, D, lay, is_bf16, p, st);
                         });
}

// The backward of the same call (attention_bwd.cuh), bf16 q/k/v only: o the
// forward's output, g the upstream gradient, dq, dk, dv bf16 outputs, all
// (B, H, L, D) by element strides as above; stats (B, H, L) float4
// scratch; ds (B, H, L, L) contiguous f32, or null where no table needs a
// gradient. strides: q, k, v, o, g, dq, dk, dv, each (b, h, l), then
// bias1d (h, row). Returns 0 once launched, else a CUDA error.
extern "C" int sal_fused_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* g, const void* bias1d,
                                       const void* cell_bias, const void* cell,
                                       const void* mask, void* dq, void* dk, void* dv,
                                       void* stats, void* ds, int B, int H, int L, int D, int C,
                                       const long long* strides, int table_is_bf16,
                                       void* stream) {
  if (C <= 0 || C > CMAX) return (int)cudaErrorInvalidValue;
  const attn::BwdArgs a = attn::bwd_args(q, k, v, o, g, dq, dk, dv, stats, ds, strides, B, H, L,
                                         L, D, 1.f);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_sal_policy(bias1d, cell_bias, cell, mask, strides + 24, L, C, table_is_bf16,
                         [&](const auto& p) { return attn::launch_bwd(a, p, st); });
}
