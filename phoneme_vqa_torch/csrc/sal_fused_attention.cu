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
// Design: the online-softmax core of attention_core.cuh (64 query rows per
// 128-thread block, K/V streamed in 64-key tiles; bf16 through mma.sync,
// f32 on CUDA-core FMAs, so both model dtypes run through it) with the
// logit policy SalBias below. The TPU kernel picks cell_bias rows and
// columns with one-hot matmuls (an MXU device); here the per-pair term is a
// gather. Each block stages, once, the table rows of its 64 query rows'
// cells, widened to f32: Rt[r][c] = cell_bias[h, cell[b, q0 + r], c]
// (64 x 129 f32, 33 KB whatever the table's type; C <= 128). With each key
// tile it stages the keys' cell ids and mask flags, so the per-pair term is
// Rt[r][cell_k], one shared-memory load. bias1d[h] is read from device
// memory (2.7 MB in bf16, shared by all batch rows, so mostly from L2). The
// shared memory is dynamic, opted in above 48 KB with cudaFuncSetAttribute
// before each launch (bf16 D=64: 52.0 KB; f32 D=128: 153.3 KB).

#include "attention_core.cuh"

constexpr int CMAX = 128;     // widest cell table taken (the TPU kernel's CELL_DIM)
constexpr int RS = CMAX + 1;  // f32 per row of the staged table rows Rt
constexpr int KEY_ATTEND = 0, KEY_MASKED = 1, KEY_PAST_L = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int clamp_cell(int c, int C) {
  return (unsigned)c < (unsigned)C ? c : C - 1;
}

// The logit policy: the SaL bias from its factors, the key mask. TB is the
// tables' type (f32 or bf16).
template <typename TB>
struct SalBias {
  const TB* bias1d;     // (H, L, L)
  const TB* cell_bias;  // (H, C, C)
  const int* cell;      // (B, L)
  const int* mask;      // (B, L) or null
  int L, C;
  static constexpr size_t kSmemBytes = sizeof(float) * attn::BQ * RS + sizeof(int) * 2 * attn::BK;

  struct Block {
    const TB* b1d;     // bias1d[h]
    const float* Rt;   // (BQ, RS) staged table rows
    int* Ck;           // (BK) this key tile's clamped cell ids
    int* Kf;           // (BK) this key tile's KEY_* flags
    const int* cellb;  // cell[b]
    const int* maskb;  // mask[b] or null
    int L, C, q0;

    __device__ __forceinline__ void stage_keys(int k0) const {
      const int j = threadIdx.x;
      if (j < attn::BK) {
        const int key = k0 + j;
        Ck[j] = key < L ? clamp_cell(cellb[key], C) : 0;
        Kf[j] = key >= L ? KEY_PAST_L : (maskb && maskb[key] == 0) ? KEY_MASKED : KEY_ATTEND;
      }
    }

    __device__ __forceinline__ float logit(float x, int lr, int j, int k0) const {
      const int f = Kf[j];
      if (f == KEY_PAST_L) return -INFINITY;
      if (f == KEY_MASKED) return attn::NEG_INF_LOGIT;
      const int row = q0 + lr;
      if (row < L) {
        const float bias = to_f(b1d[(long long)row * L + k0 + j]) + Rt[lr * RS + Ck[j]];
        x = x + bias;
      }
      return x;
    }
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
    return {bias1d + (long long)h * L * L, Rt, Ck, Ck + attn::BK, cellb,
            mask ? mask + (long long)b * L : nullptr, L, C, q0};
  }
};

// Returns cudaGetLastError() after the launch (0 = launched). Shapes are
// checked by the Python wrapper: q, k, v (B,H,L,D) contiguous and 16-byte
// aligned, D a multiple of 8 and at most 128; bias1d (H,L,L) and cell_bias
// (H,C,C), C <= 128, contiguous in one table type; cell int32 (B,L); mask
// int32 (B,L) or null. is_bf16 selects bf16 q/k/v/out, else f32;
// table_is_bf16 selects bf16 tables, else f32.
extern "C" int sal_fused_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias1d, const void* cell_bias,
                                       const void* cell, const void* mask, void* out, int B,
                                       int H, int L, int D, int C, int is_bf16,
                                       int table_is_bf16, void* stream) {
  if (C <= 0 || C > CMAX) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cl = static_cast<const int*>(cell);
  const auto* mk = static_cast<const int*>(mask);
  if (table_is_bf16) {
    using T = __nv_bfloat16;
    const SalBias<T> p{static_cast<const T*>(bias1d), static_cast<const T*>(cell_bias), cl, mk,
                       L, C};
    return attn::launch(q, k, v, out, B, H, L, L, D, is_bf16, p, s);
  }
  const SalBias<float> p{static_cast<const float*>(bias1d), static_cast<const float*>(cell_bias),
                         cl, mk, L, C};
  return attn::launch(q, k, v, out, B, H, L, L, D, is_bf16, p, s);
}
