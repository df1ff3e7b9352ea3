// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: phoneme_vqa_tpu/ops/flash_attention.py: fused_attention (the
// Pallas kernels _attn_kernel / _attn_kernel_nobias), reached through
// ops/attention.py: dot_product_attention for every attention with
// Lq >= 16: the 12 ViT layers and the 12 T5 encoder layers on the LaTr
// serving path, and the T5 decoder's teacher-forced self and cross attention.
//
// Computes, per (b, h):
//   out = softmax(scale * q k^T + bias; masked keys -> -1e9; causal -> -1e9) v
// with f32 logits, an f32 softmax and f32 accumulation of P v, output in
// q's dtype (f32 or bf16). A masked or causal key's logit is REPLACED by
// -1e9, as in reference_attention; keys past Lk in the kernel's own tiling
// get -inf and contribute nothing, so a fully masked row averages v over
// the Lk real keys. The bias (1 or B, H, Lq, Lk) is f32; a bias batch of 1
// is broadcast over b. q, k, v, out and the bias are taken by strides.
//
// What bounds it: at the serving shapes (B=32, H=12, D=64, bf16) the least
// time per call is set by bytes, not operations. T5 encoder, L=327: q, k, v
// and out are 4 * 32*12*327*64*2 B = 64.3 MB plus the 5.1 MB f32 bias,
// ~20.7 us at 3.35 TB/s, against 4*32*12*327^2*64 = 10.5 GFLOP, ~10.6 us at
// 989 TFLOP/s. ViT, L=197: 38.7 MB, ~11.6 us.
//
// Design: the core of attention_core.cuh with the logit policy DenseBias.
// bf16: TMA + wgmma; the producer warp stages, in each K stage, the
// (TQ x 64) f32 bias tile by TMA (two 128B-swizzled boxes of 32 columns; the
// (1, H, Lq, Lk) bias is shared by every b, so it stays in L2) and the key
// tile's fix-ups (a float pair a key: keep or replace by -1e9 / -inf), so
// the logits read both from shared memory: one straight pass over a
// thread's 32 values, and one FMA each for the fix-ups, only on a tile with
// a masked key or one past Lk. The factor to log2 units (log2(e), times
// the scale on a clean tile without a bias) rides in the softmax's FMA.
// TMA needs the bias rows 16-byte aligned (Lk % 4 == 0 or a padded row
// stride): the T5 stacks build their relative bias so (models/t5.py:
// RelativeBias) and the wrapper copies a bias that is not.
// What holds it back (PERF.md): at L=327 the copies alone take two thirds
// of the kernel; a third of them is the f32 bias tile, which every b reads
// again from L2 (226 MB at B=32), as large as its K and V tiles together.
// f32: CUDA-core FMAs, bias and mask read per logit.

#include "attention_bwd.cuh"

// The logit policy: scale, dense bias, key mask, causal mask.
struct DenseBias {
  const float* bias;  // (1|B, H, Lq, Lk) by strides, or null
  const int* mask;    // (B, Lk) or null
  long long bias_sb, bias_sh, bias_sl;  // element strides; bias_sb 0 for a bias batch of 1
  int bias_batch, Lq, Lk, causal;
  float scale;
  CUtensorMap bias_map;  // bf16 path: (Lk, Lq, H, bias_batch), boxes {32, TQ}

  // ---- f32 path
  static constexpr size_t kSmemBytes = 0;

  struct Block {
    const float* biasb;
    const int* maskb;
    long long bias_sl;
    int Lq, Lk, q0, causal;
    float scale;

    __device__ __forceinline__ void stage_keys(int) const {}

    __device__ __forceinline__ float logit(float x, int lr, int j, int k0) const {
      const int row = q0 + lr, col = k0 + j;
      if (col >= Lk) return -INFINITY;
      x *= scale;
      if (biasb && row < Lq) x += biasb[row * bias_sl + col];
      if (maskb && maskb[col] == 0) x = attn::NEG_INF_LOGIT;
      if (causal && col > row) x = attn::NEG_INF_LOGIT;
      return x;
    }

    // backward: whether the logit is the product's (not replaced by -1e9,
    // not past Lk), so its gradient reaches q, k and the bias
    __device__ __forceinline__ bool live(int lr, int j, int k0) const {
      const int row = q0 + lr, col = k0 + j;
      return col < Lk && !(maskb && maskb[col] == 0) && !(causal && col > row);
    }
  };

  __device__ __forceinline__ Block block(char*, int b, int h, int q0) const {
    return {bias ? bias + b * bias_sb + h * bias_sh : nullptr,
            mask ? mask + (long long)b * Lk : nullptr, bias_sl, Lq, Lk, q0, causal, scale};
  }

  // ---- backward (attention_bwd.cuh): a block that owns key tile k0 and
  // walks the query tiles; nothing to stage
  static constexpr size_t kKeySmemBytes = 0;

  struct KeyBlock {
    Block blk;  // at q0 = 0, so its block row is the query row itself
    int k0;

    __device__ __forceinline__ void stage_rows(int) const {}
    __device__ __forceinline__ float logit(float x, int lr, int j, int q0) const {
      return blk.logit(x, q0 + lr, j, k0);
    }
    __device__ __forceinline__ bool live(int lr, int j, int q0) const {
      return blk.live(q0 + lr, j, k0);
    }
  };

  __device__ __forceinline__ KeyBlock key_block(char* smem, int b, int h, int k0) const {
    return {block(smem, b, h, 0), k0};
  }

  // ---- bf16 path
  static constexpr int kBlockBytes = 0;

  bool encode(int H) {
    return !bias || attn::encode_4d(&bias_map, bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, Lk, Lq,
                                    H, bias_batch, bias_sl, bias_sh, bias_sb, 32, attn::TQ,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  }

  __host__ __device__ int tile_bytes() const { return bias ? attn::TQ * attn::BK * 4 : 0; }

  // a producer lane's keys are k0 + lane and k0 + lane + 32
  struct Keys {
    int m0, m1;  // their mask values (1 without a mask or past Lk)
  };

  __device__ __forceinline__ Keys load_keys(int b, int k0, int lane) const {
    const int key0 = k0 + lane, key1 = key0 + 32;
    const int* mb = mask + (long long)b * Lk;
    return {mask && key0 < Lk ? mb[key0] : 1, mask && key1 < Lk ? mb[key1] : 1};
  }

  // returns whether either key is masked or past Lk
  __device__ __forceinline__ bool store_keys(uint8_t* info, const Keys& keys, int k0,
                                             int lane) const {
    float2* fix = reinterpret_cast<float2*>(info);
    const bool past0 = k0 + lane >= Lk, past1 = k0 + lane + 32 >= Lk;
    const bool masked0 = keys.m0 == 0, masked1 = keys.m1 == 0;
    fix[lane] = attn::key_fixup(past0, masked0);
    fix[lane + 32] = attn::key_fixup(past1, masked1);
    return past0 || past1 || masked0 || masked1;
  }

  __device__ __forceinline__ void prefetch() const {
    if (bias) attn::prefetch_map(&bias_map);
  }

  __device__ __forceinline__ void produce_tile(uint8_t* dst, uint32_t bar, int b, int h, int q0,
                                               int k0) const {
    if (!bias) return;
    const int bb = bias_batch > 1 ? b : 0;
    attn::tma_load(dst, &bias_map, bar, k0, q0, h, bb);
    attn::tma_load(dst + attn::TQ * 128, &bias_map, bar, k0 + 32, q0, h, bb);
  }

  __device__ __forceinline__ void prepare_rows(uint8_t*, int, int, int, int, int) const {}

  // scale * x + bias, then the causal mask and, on a tile that is not
  // clean, the keys' fix-ups; returns log2(e), the factor to log2 units.
  // Without a bias, a clean tile under no causal mask is left as it is and
  // the positive scale folds into the factor. Each pass is one straight run
  // over the 32 values, so the loads of all of them can be in flight at once.
  __device__ __forceinline__ float apply_logits(float (&s)[32], const uint8_t* tile,
                                                const uint8_t* info, const uint8_t*, int lr0,
                                                int q0, int k0, int t, bool clean) const {
    if (bias) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = 8 * n + 2 * t;
        const float2 b0 = attn::swizzled_pair<float>(tile, attn::TQ, lr0, j);
        const float2 b1 = attn::swizzled_pair<float>(tile, attn::TQ, lr0 + 8, j);
        s[4 * n] = fmaf(s[4 * n], scale, b0.x);
        s[4 * n + 1] = fmaf(s[4 * n + 1], scale, b0.y);
        s[4 * n + 2] = fmaf(s[4 * n + 2], scale, b1.x);
        s[4 * n + 3] = fmaf(s[4 * n + 3], scale, b1.y);
      }
    } else {
      // the factor must be positive: the softmax takes the max before it
      if (clean && !causal && scale > 0.f) return scale * attn::LOG2E;
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale;
    }
    if (causal) {  // before the fix-ups: a key past Lk must end at -inf
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * t + (e & 1) > q0 + lr0 + 8 * (e >> 1))
            s[4 * n + e] = attn::NEG_INF_LOGIT;
    }
    if (!clean) attn::apply_fixups(s, info, t);
    return attn::LOG2E;
  }
};

// The policy of one call: bias (bias_batch = 1|B, H, Lq, Lk) by element
// strides sb = (b, h, l), or null; mask (B, Lk) or null.
static DenseBias dense_policy(const void* bias, const void* mask, const long long* sb,
                              int bias_batch, int Lq, int Lk, int causal, float scale) {
  DenseBias policy{};
  policy.bias = static_cast<const float*>(bias);
  policy.mask = static_cast<const int*>(mask);
  policy.bias_sb = sb[0];
  policy.bias_sh = sb[1];
  policy.bias_sl = sb[2];
  policy.bias_batch = bias_batch;
  policy.Lq = Lq;
  policy.Lk = Lk;
  policy.causal = causal;
  policy.scale = scale;
  return policy;
}

// Returns 0 once launched, else a CUDA error or attn::ERR_TENSOR_MAP. Shapes
// and layouts are checked by the Python wrapper: q (B,H,Lq,D), k and v
// (B,H,Lk,D), out (B,H,Lq,D), each by element strides (b, h, l) with a unit
// D stride, 16-byte aligned starts and strides; D a multiple of 8, at most
// 128; bias f32 (bias_batch = 1|B, H, Lq, Lk) by element strides (b, h, l),
// rows 16-byte aligned, or null; mask int32 (B, Lk) contiguous or null.
// strides: q, k, v, out, bias, each (b, h, l). is_bf16 selects bf16
// tensors, else f32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int B,
                                   int H, int Lq, int Lk, int D, const long long* strides,
                                   int bias_batch, int causal, float scale, int is_bf16,
                                   void* stream) {
  const long long* s = strides;
  const attn::Layout lay{{s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
                         {s[9], s[10], s[11]}};
  return attn::launch(q, k, v, out, B, H, Lq, Lk, D, lay, is_bf16,
                      dense_policy(bias, mask, s + 12, bias_batch, Lq, Lk, causal, scale),
                      static_cast<cudaStream_t>(stream));
}

// The backward of the same call (attention_bwd.cuh), bf16 only: o the
// forward's output, g the upstream gradient, dq, dk, dv bf16 outputs, all
// (B, H, L, D) by element strides as above; stats (B, H, Lq) float4
// scratch; ds (B, H, Lq, Lk) contiguous f32, or null where no bias needs a
// gradient. strides: q, k, v, o, g, dq, dk, dv, bias, each (b, h, l).
// Returns 0 once launched, else a CUDA error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const void* bias, const void* mask, void* dq,
                                   void* dk, void* dv, void* stats, void* ds, int B, int H,
                                   int Lq, int Lk, int D, const long long* strides,
                                   int bias_batch, int causal, float scale, void* stream) {
  const attn::BwdArgs a = attn::bwd_args(q, k, v, o, g, dq, dk, dv, stats, ds, strides, B, H,
                                         Lq, Lk, D, scale);
  return attn::launch_bwd(a, dense_policy(bias, mask, strides + 24, bias_batch, Lq, Lk, causal,
                                          scale),
                          static_cast<cudaStream_t>(stream));
}
