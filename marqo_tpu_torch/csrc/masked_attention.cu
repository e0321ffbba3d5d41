// Masked softmax attention for encoder stacks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel marqo_tpu/ops/flash_attention.py
// `_attention_kernel` (launched by `_fused_attention`): per (batch, head),
// scores = q.k^T / sqrt(D) in fp32, masked from a compact (B, S) int32 row,
// softmax in fp32, then probs.v with fp32 accumulation; output in the input
// dtype. Two mask modes:
//   padding: key j is allowed iff mask[j] > 0
//   segment: key j is allowed iff seg[i] == seg[j] and seg[j] > 0
// Disallowed scores are the finite -1e9, as in the TPU kernel, so a fully
// masked row (a pad query in segment mode) comes out as the uniform mean of
// V over all S keys, never NaN.
//
// What bounds it on this card: the TPU kernel gave one program the whole
// S x S score tile, which at S = 512 in fp32 is 1 MB, far over the 227 KB of
// shared memory a block may use. The tile loop of attention_tile.cuh owns a
// 64-row query tile per block and walks 64-key tiles with an online
// softmax, so shared memory is 68 KB at D = 64 whatever S is. Masked tiles
// are not skipped: computing -1e9 scores keeps the uniform-row result of
// the TPU kernel exact with no special case. Arithmetic is plain fp32 FMA
// from shared memory (no tensor cores yet), so at the encoder's shapes the
// kernel is bound by shared-memory bandwidth and FMA issue rate.

#include "attention_tile.cuh"

namespace {

using marqo_attention::launch_attention;

struct PaddingMask {
  static constexpr bool kUsesIds = true;
  static __device__ __forceinline__ bool allowed(int, int key) {
    return key > 0;
  }
};

struct SegmentMask {
  static constexpr bool kUsesIds = true;
  static __device__ __forceinline__ bool allowed(int query, int key) {
    return key > 0 && key == query;
  }
};

template <typename T, int D>
cudaError_t launch_mode(const void* q, const void* k, const void* v,
                        const void* mask, void* out, int batch, int heads,
                        int seq_len, int segment, float scale,
                        cudaStream_t stream) {
  return segment ? launch_attention<T, D, SegmentMask>(
                       q, k, v, mask, out, batch, heads, seq_len, scale, stream)
                 : launch_attention<T, D, PaddingMask>(
                       q, k, v, mask, out, batch, heads, seq_len, scale,
                       stream);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* mask, void* out, int batch, int heads,
                         int seq_len, int head_dim, int segment, float scale,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_mode<T, 8>(q, k, v, mask, out, batch, heads, seq_len,
                               segment, scale, stream);
    case 16:
      return launch_mode<T, 16>(q, k, v, mask, out, batch, heads, seq_len,
                                segment, scale, stream);
    case 32:
      return launch_mode<T, 32>(q, k, v, mask, out, batch, heads, seq_len,
                                segment, scale, stream);
    case 64:
      return launch_mode<T, 64>(q, k, v, mask, out, batch, heads, seq_len,
                                segment, scale, stream);
    case 128:
      return launch_mode<T, 128>(q, k, v, mask, out, batch, heads, seq_len,
                                 segment, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (batch, heads, seq_len, head_dim), contiguous, fp32 or bf16
// (bf16 != 0); mask: (batch, seq_len) int32. Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int marqo_masked_attention(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int batch, int heads,
                                      int seq_len, int head_dim, int segment,
                                      int bf16, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dtype<__nv_bfloat16>(q, k, v, mask, out, batch, heads,
                                         seq_len, head_dim, segment, scale, s)
           : launch_dtype<float>(q, k, v, mask, out, batch, heads, seq_len,
                                 head_dim, segment, scale, s);
  return static_cast<int>(err);
}
