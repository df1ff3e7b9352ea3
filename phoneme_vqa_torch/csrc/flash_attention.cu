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
// is broadcast over b (bias_bstride == 0).
//
// What bounds it: at the serving shapes (B=32, H=12, D=64, bf16) the least
// time per call is set by bytes, not operations. T5 encoder, L=327: q, k, v
// and out are 4 * 32*12*327*64*2 B = 64.3 MB plus the 5.1 MB f32 bias,
// ~20.7 us at 3.35 TB/s, against 4*32*12*327^2*64 = 10.5 GFLOP, ~10.6 us at
// 989 TFLOP/s. ViT, L=197: 38.7 MB, ~11.6 us.
//
// Design: the online-softmax core of attention_core.cuh (64 query rows per
// 128-thread block, K/V streamed in 64-key tiles; bf16 through mma.sync,
// f32 on CUDA-core FMAs) with the logit policy DenseBias below, which reads
// the bias and the key mask from device memory per logit.

#include "attention_core.cuh"

// The logit policy: scale, dense bias, key mask, causal mask.
struct DenseBias {
  const float* bias;  // (1|B, H, Lq, Lk) or null
  const int* mask;    // (B, Lk) or null
  long long bias_bstride;
  int Lq, Lk, causal;
  float scale;
  static constexpr size_t kSmemBytes = 0;

  struct Block {
    const float* biasb;
    const int* maskb;
    int Lq, Lk, q0, causal;
    float scale;

    __device__ __forceinline__ void stage_keys(int) const {}

    __device__ __forceinline__ float logit(float x, int lr, int j, int k0) const {
      const int row = q0 + lr, col = k0 + j;
      if (col >= Lk) return -INFINITY;
      x *= scale;
      if (biasb && row < Lq) x += biasb[(long long)row * Lk + col];
      if (maskb && maskb[col] == 0) x = attn::NEG_INF_LOGIT;
      if (causal && col > row) x = attn::NEG_INF_LOGIT;
      return x;
    }
  };

  __device__ __forceinline__ Block block(char*, int b, int h, int q0) const {
    return {bias ? bias + (long long)b * bias_bstride + (long long)h * Lq * Lk : nullptr,
            mask ? mask + (long long)b * Lk : nullptr, Lq, Lk, q0, causal, scale};
  }
};

// Returns cudaGetLastError() after the launch (0 = launched). Shapes are
// checked by the Python wrapper: q (B,H,Lq,D), k and v (B,H,Lk,D) contiguous
// and 16-byte aligned; D a multiple of 8 and at most 128; bias f32
// (1|B,H,Lq,Lk) or null; mask int32 (B,Lk) or null. is_bf16 selects bf16
// tensors, else f32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int B,
                                   int H, int Lq, int Lk, int D, long long bias_bstride,
                                   int causal, float scale, int is_bf16, void* stream) {
  const DenseBias policy{static_cast<const float*>(bias), static_cast<const int*>(mask),
                         bias_bstride, Lq, Lk, causal, scale};
  return attn::launch(q, k, v, out, B, H, Lq, Lk, D, is_bf16, policy,
                      static_cast<cudaStream_t>(stream));
}
