// Flash attention for the ViT towers and the encoder's "flash" path, for
// Hopper (sm_90a).
//
// Replaces marqo_tpu/ops/fused_attention.py `fused_attention` (`_mha_nomask`
// and `_mha_segments`), which runs JAX's library Pallas TPU flash kernel:
// tiled attention with an online softmax, scale 1/sqrt(D) applied inside,
// fp32 scores, softmax and accumulation, output in the input dtype. Two
// modes:
//   no mask:  every key in range is allowed (the ViT image towers);
//   segment:  key j is allowed iff seg[i] == seg[j], id 0 included (packed
//             rows; a padding mask arrives as ids {0, 1}, so pad rows attend
//             to each other).
// A query always sees at least its own key, so no row is fully masked and
// every output row is defined; disallowed scores get -1e9 and keys past the
// ragged edge of S get -inf.
//
// What bounds it on this card: at the ViT-L/14 shape ((16, 16, 257, 64),
// bf16) the bytes, 0.010 ms, against 0.004 ms of tensor-core operations;
// at EVA02-L-14-336's and OWL-ViT's 577 tokens the two meet (0.023 ms of
// bytes, 0.022 of operations at (16, 16, 577, 64)). The TPU kernel tiles S
// by up to 512 and holds (512, 512) fp32 score blocks in VMEM; a Hopper
// block has 227 KB of shared memory. Here a block owns 64 or 128 query
// rows and walks 64-key tiles with an online softmax, so any S fits (577
// for ViT-L/14@336, 730 for ViT-H-14-378). bf16 runs one of two tile loops,
// as ops/flash_attention.py `tile_loop` picks:
//   - wgmma (attention_tile_sm90.cuh): two consumer warpgroups of 64 rows
//     share each K and V tile that a producer warp brings in by TMA, and
//     read it from shared memory once per 64 rows, where the mma.sync
//     warps read it once per 16; that was what held B2 at 2x SDPA past 490
//     tokens. On an H100 at 700 W (scripts/tune_attention.py, PERF.md
//     section 6): 0.0742 ms at (16, 16, 577, 64) against 0.1640 on
//     mma.sync and 0.0805 for SDPA; 0.0270 at (16, 16, 257, 64) against
//     0.0476 and 0.0345;
//   - mma.sync (attention_tile.cuh, the earlier loop): kept where the card
//     showed it faster, where a 64-row wgmma tile is mostly idle: S <= 32
//     at D <= 32, S <= 16 at D <= 64, S <= 64 at D <= 128. The video
//     tower's temporal attention over 8 frames, (257, 16, 8, 64), is one:
//     0.0274 ms against 0.0287 on wgmma (0.0718 for SDPA). Its last key
//     tile computes only the 8-key fragments inside S.
// In segment mode key tiles holding no id of the block's queries are
// skipped. Head dims are any multiple of 8 up to 128 (64 for the B and L
// towers; 72 for SO400M; 80, 88 and 104 for the open_clip H, g and bigG
// towers), on eight instances of the head dim padded to a multiple of 16
// per loop. q, k and v are read in the projections' (B, S, N, D) layout
// through strides. The fp32 instances keep the exact FMA loop.

#include "attention_tile_sm90.cuh"

namespace {

using marqo_attention::launch_loop;
using marqo_attention::Operands;
using marqo_attention::Skip;

struct NoMask {
  static constexpr bool kUsesIds = false;
  static constexpr Skip kSkip = Skip::kNone;
  static __device__ __forceinline__ bool allowed(int, int) { return true; }
};

struct SegmentMask {
  static constexpr bool kUsesIds = true;
  static constexpr Skip kSkip = Skip::kSegment;
  static __device__ __forceinline__ bool allowed(int query, int key) {
    return key == query;
  }
};

constexpr int kMaxHeadDim = 128;

// the instance whose padded head dim DP covers head_dim (DP - 16 < D <= DP)
template <typename T, typename Mask, int DP = 16>
cudaError_t launch_head_dim(int loop, int head_dim, const void* q,
                            const void* k, const void* v, const void* ids,
                            void* out, const Operands& strides, int batch,
                            int heads, int seq_len, float scale,
                            cudaStream_t stream) {
  if (head_dim <= DP)
    return launch_loop<T, DP, Mask>(loop, q, k, v, ids, out, strides, batch,
                                    heads, seq_len, head_dim, scale, stream);
  if constexpr (DP < kMaxHeadDim)
    return launch_head_dim<T, Mask, DP + 16>(loop, head_dim, q, k, v, ids,
                                             out, strides, batch, heads,
                                             seq_len, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_mode(int loop, const void* q, const void* k,
                        const void* v, const void* segment_ids, void* out,
                        const Operands& strides, int batch, int heads,
                        int seq_len, int head_dim, float scale,
                        cudaStream_t stream) {
  return segment_ids
             ? launch_head_dim<T, SegmentMask>(loop, head_dim, q, k, v,
                                               segment_ids, out, strides,
                                               batch, heads, seq_len, scale,
                                               stream)
             : launch_head_dim<T, NoMask>(loop, head_dim, q, k, v, nullptr,
                                          out, strides, batch, heads,
                                          seq_len, scale, stream);
}

}  // namespace

// q, k, v, out: (batch, heads, seq_len, head_dim), fp32 or bf16 (bf16 !=
// 0), head_dim a multiple of 8 up to 128, given by `strides`: 12 element
// strides, the batch, head and token strides of q, k, v and out in that
// order (the last axis has stride 1; strides are multiples of 8 and
// pointers 16-byte aligned). segment_ids: (batch, seq_len) int32,
// contiguous, or null for no mask. loop: the tile loop (0 the fp32 FMA
// loop, 1 mma.sync, 2 wgmma; bf16 takes 1 or 2, fp32 only 0). Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously
// on `stream`.
extern "C" int marqo_fused_attention(const void* q, const void* k,
                                     const void* v, const void* segment_ids,
                                     void* out, int batch, int heads,
                                     int seq_len, int head_dim, int bf16,
                                     float scale, const long long* strides,
                                     int loop, void* stream) {
  if (head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands st = marqo_attention::make_operands(strides);
  const cudaError_t err =
      bf16 ? launch_mode<__nv_bfloat16>(loop, q, k, v, segment_ids, out, st,
                                        batch, heads, seq_len, head_dim,
                                        scale, s)
           : launch_mode<float>(loop, q, k, v, segment_ids, out, st, batch,
                                heads, seq_len, head_dim, scale, s);
  return static_cast<int>(err);
}
