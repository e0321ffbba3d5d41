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
// masked row (a pad query in segment mode, every row of an all-pad batch
// row) comes out as the uniform mean of V over all S keys, never NaN.
//
// What bounds it on this card: at the encoder's shapes ((256, 12, 128, 64),
// bf16) the bytes: at most 0.060 ms to read q, k, v and write the output
// once (0.045 ms for the keys a padded ingest batch's mask needs), against
// 0.013 ms of tensor-core operations. The TPU kernel gave one program the
// whole S x S score tile, which at S = 512 in fp32 is 1 MB, far over the
// 227 KB of shared memory a block may use. Here a block owns 64 or 128
// query rows and walks 64-key tiles with an online softmax. bf16 runs one
// of two tile loops, as ops/flash_attention.py `tile_loop` picks:
//   - wgmma (attention_tile_sm90.cuh): 128 query rows a block on two
//     consumer warpgroups that share each K and V tile a producer warp
//     brings in by TMA, so a (batch, head) at S = 128 is one block reading
//     K and V once, where the mma.sync loop runs two blocks that read them
//     twice; warpgroup MMA from shared memory, no block barrier in the loop;
//   - mma.sync (attention_tile.cuh, the earlier loop): kept where the card
//     showed it faster, where a 64-row wgmma tile is mostly idle: S <= 32
//     at D <= 32, S <= 16 at D <= 64, S <= 64 at D <= 128 (e.g. B1 padding
//     at (256, 12, 16, 64): 0.0242 ms against 0.0269 on wgmma; from 32
//     tokens wgmma is ahead: 0.0311 against 0.0321, and at the encoder's
//     128 tokens 0.0744 against 0.0933; scripts/tune_attention.py on an
//     H100 at 700 W, PERF.md section 6).
// Key tiles the mask rules out for the whole block are skipped (a padded
// batch of short documents is about half padding) with results unchanged
// bit for bit; an all-pad row or a block holding a pad query visits every
// tile, which keeps the uniform-row result exact. q, k and v are read in
// the projections' (B, S, N, D) layout through strides. Head dims are any
// multiple of 8 up to 128 (64 for e5 and NLLB, 32 for MiniLM, 48 for a
// 384-wide 8-head encoder), on eight instances of the head dim padded to a
// multiple of 16 per loop. The fp32 instances keep the exact FMA loop.
//
// Causal modes (`marqo_masked_attention_causal`, decoder embedders): the
// padding and segment policies with keys after the query disallowed, at
// DeepSeek-V2's latent attention widths alone: q/k head dim 192 (128 +
// 64 RoPE dims), v head dim 128. bf16 runs them on the mma.sync loop
// (the wgmma loop's boxes and warpgroup tiles assume one head dim of at
// most 128), fp32 on the FMA loop. At the embedder's packed rows ((rows,
// 16, 256, 192/128) bf16) the tensor-core operations bound the work
// (causal: about half the S x S pairs), the bytes about as much: each
// block skips the key tiles after its last query.

#include "attention_tile_sm90.cuh"

namespace {

using marqo_attention::launch_loop;
using marqo_attention::Operands;
using marqo_attention::Skip;

struct PaddingMask {
  static constexpr bool kUsesIds = true;
  static constexpr Skip kSkip = Skip::kPadding;
  static __device__ __forceinline__ bool allowed(int, int key) {
    return key > 0;
  }
};

struct SegmentMask {
  static constexpr bool kUsesIds = true;
  static constexpr Skip kSkip = Skip::kSegmentPositive;
  static __device__ __forceinline__ bool allowed(int query, int key) {
    return key > 0 && key == query;
  }
};

struct CausalPaddingMask : PaddingMask {
  static constexpr bool kCausal = true;
};

struct CausalSegmentMask : SegmentMask {
  static constexpr bool kCausal = true;
};

// the causal instances' padded head dims: q/k 192, v 128
constexpr int kCausalHeadDim = 192;
constexpr int kCausalVHeadDim = 128;

constexpr int kMaxHeadDim = 128;

template <typename T, int DP>
cudaError_t launch_mode(int loop, const void* q, const void* k,
                        const void* v, const void* mask, void* out,
                        const Operands& strides, int batch, int heads,
                        int seq_len, int head_dim, int segment, float scale,
                        cudaStream_t stream) {
  return segment ? launch_loop<T, DP, SegmentMask>(
                       loop, q, k, v, mask, out, strides, batch, heads,
                       seq_len, head_dim, scale, stream)
                 : launch_loop<T, DP, PaddingMask>(
                       loop, q, k, v, mask, out, strides, batch, heads,
                       seq_len, head_dim, scale, stream);
}

// the instance whose padded head dim DP covers head_dim (DP - 16 < D <= DP),
// as in fused_attention.cu: every multiple of 8 up to 128
template <typename T, int DP = 16>
cudaError_t launch_dtype(int loop, const void* q, const void* k,
                         const void* v, const void* mask, void* out,
                         const Operands& strides, int batch, int heads,
                         int seq_len, int head_dim, int segment, float scale,
                         cudaStream_t stream) {
  if (head_dim <= DP)
    return launch_mode<T, DP>(loop, q, k, v, mask, out, strides, batch,
                              heads, seq_len, head_dim, segment, scale,
                              stream);
  if constexpr (DP < kMaxHeadDim)
    return launch_dtype<T, DP + 16>(loop, q, k, v, mask, out, strides, batch,
                                    heads, seq_len, head_dim, segment, scale,
                                    stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (batch, heads, seq_len, head_dim), fp32 or bf16 (bf16 !=
// 0), head_dim a multiple of 8 up to 128, given by `strides`: 12 element
// strides, the batch, head and token strides of q, k, v and out in that
// order (the last axis has stride 1; strides are multiples of 8 and
// pointers 16-byte aligned). mask: (batch, seq_len) int32, contiguous.
// loop: the tile loop (marqo_attention::Loop: 0 the fp32 FMA loop, 1
// mma.sync, 2 wgmma; bf16 takes 1 or 2, fp32 only 0). Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously
// on `stream`.
extern "C" int marqo_masked_attention(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int batch, int heads,
                                      int seq_len, int head_dim, int segment,
                                      int bf16, float scale,
                                      const long long* strides, int loop,
                                      void* stream) {
  if (head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands st = marqo_attention::make_operands(strides);
  const cudaError_t err =
      bf16 ? launch_dtype<__nv_bfloat16>(loop, q, k, v, mask, out, st, batch,
                                         heads, seq_len, head_dim, segment,
                                         scale, s)
           : launch_dtype<float>(loop, q, k, v, mask, out, st, batch, heads,
                                 seq_len, head_dim, segment, scale, s);
  return static_cast<int>(err);
}

// The causal modes: as marqo_masked_attention, with keys after the query
// disallowed and V's head dim `v_head_dim` apart from q's and k's
// (`head_dim`); out is (batch, heads, seq_len, v_head_dim). Only head_dim
// 192 with v_head_dim 128, on the FMA loop (fp32) or the mma.sync loop
// (bf16); any other pairing is cudaErrorInvalidValue.
extern "C" int marqo_masked_attention_causal(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    int batch, int heads, int seq_len, int head_dim, int v_head_dim,
    int segment, int bf16, float scale, const long long* strides, int loop,
    void* stream) {
  if (head_dim != kCausalHeadDim || v_head_dim != kCausalVHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (loop != (bf16 ? marqo_attention::kLoopMmaSync
                    : marqo_attention::kLoopFma))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands st = marqo_attention::make_operands(strides);
  using marqo_attention::launch_attention;
  constexpr int DP = kCausalHeadDim, DV = kCausalVHeadDim;
  cudaError_t err;
  if (bf16)
    err = segment ? launch_attention<__nv_bfloat16, DP, CausalSegmentMask, DV>(
                        q, k, v, mask, out, st, batch, heads, seq_len,
                        head_dim, scale, s, v_head_dim)
                  : launch_attention<__nv_bfloat16, DP, CausalPaddingMask, DV>(
                        q, k, v, mask, out, st, batch, heads, seq_len,
                        head_dim, scale, s, v_head_dim);
  else
    err = segment ? launch_attention<float, DP, CausalSegmentMask, DV>(
                        q, k, v, mask, out, st, batch, heads, seq_len,
                        head_dim, scale, s, v_head_dim)
                  : launch_attention<float, DP, CausalPaddingMask, DV>(
                        q, k, v, mask, out, st, batch, heads, seq_len,
                        head_dim, scale, s, v_head_dim);
  return static_cast<int>(err);
}
