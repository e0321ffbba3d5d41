// Tiled softmax attention shared by the package's attention kernels, for
// Hopper (sm_90a): masked_attention.cu (B1, compact-mask encoder attention)
// and fused_attention.cu (B2, flash attention with no mask or segment ids).
// Each kernel supplies a mask policy; this file holds the tile loop.
//
// One block owns one (batch, head, 64-row query tile) and walks 64-row K/V
// tiles with an online softmax (running max and sum per row in fp32), so
// shared memory is bounded by the tile size whatever S is and the (S, S)
// scores never reach device memory:
//   scores = q.k^T * scale in fp32 (fp32 FMA from shared memory),
//   keys past the ragged edge of S get -inf (they drop out entirely),
//   in-range keys the policy disallows get the finite -1e9,
//   probs.v accumulates in fp32, and the output is in the input dtype.
// Every tile holds at least one in-range key, so the running max is always
// finite and no row divides by zero. A row whose keys are all disallowed
// comes out as the uniform mean of V over all S keys, never NaN.
//
// Shared memory is (2 (D + 1) + D + 65) * 64 floats plus 64 ints: 68 KB at
// D = 64, 113 KB at D = 128 (dynamic shared memory above 48 KB). The
// arithmetic is plain fp32 FMA (no tensor cores yet), so the loop is bound
// by shared-memory bandwidth and the FMA issue rate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace marqo_attention {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per inner tile
constexpr int kThreads = 256;  // 16 x 16; thread (ty, tx) owns rows ty + 16i
                               // and key/output columns tx + 16j
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

template <int D>
struct Layout {
  // +1 pads break shared-memory bank conflicts on column-wise reads (D is a
  // multiple of 8, so D + 1 is odd)
  static constexpr int kQStride = D + 1;
  static constexpr int kKStride = D + 1;
  static constexpr int kVStride = D;
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kFloats = kBlockQ * kQStride + kBlockK * kKStride +
                                 kBlockK * kVStride + kBlockQ * kPStride;
  static constexpr size_t kBytes =
      kFloats * sizeof(float) + kBlockK * sizeof(int);
};

// A mask policy has
//   static constexpr bool kUsesIds;  // whether the (B, S) int32 row is read
//   static __device__ bool allowed(int query_id, int key_id);
// When kUsesIds is false the ids pointer is never read and may be null.

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(kThreads)
attention_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ ids,
                      T* __restrict__ out, int num_heads, int seq_len,
                      float scale) {
  using L = Layout<D>;
  constexpr int kCols = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * L::kQStride;
  float* vs = ks + kBlockK * L::kKStride;
  float* ps = vs + kBlockK * L::kVStride;
  int* key_ids = reinterpret_cast<int*>(ps + kBlockQ * L::kPStride);

  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t head_offset =
      ((size_t)blockIdx.z * num_heads + blockIdx.y) * (size_t)seq_len * D;
  const T* qh = q + head_offset;
  const T* kh = k + head_offset;
  const T* vh = v + head_offset;
  T* oh = out + head_offset;
  const int* id_row = Mask::kUsesIds ? ids + (size_t)blockIdx.z * seq_len
                                     : nullptr;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D, row = q0 + r;
    qs[r * L::kQStride + c] =
        row < seq_len ? to_float(qh[(size_t)row * D + c]) : 0.f;
  }

  float acc[4][kCols];
  float row_max[4], row_sum[4];
  int row_id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    const int row = q0 + ty + 16 * i;
    row_id[i] = (Mask::kUsesIds && row < seq_len) ? id_row[row] : 0;
  }

  for (int k0 = 0; k0 < seq_len; k0 += kBlockK) {
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e % D, row = k0 + r;
      const bool in = row < seq_len;
      ks[r * L::kKStride + c] = in ? to_float(kh[(size_t)row * D + c]) : 0.f;
      vs[r * L::kVStride + c] = in ? to_float(vh[(size_t)row * D + c]) : 0.f;
    }
    if (Mask::kUsesIds && tid < kBlockK)
      key_ids[tid] = k0 + tid < seq_len ? id_row[k0 + tid] : 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int key = k0 + col;
      const int key_id = Mask::kUsesIds ? key_ids[col] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = key >= seq_len                      ? -INFINITY
                  : Mask::allowed(row_id[i], key_id) ? s[i][j] * scale
                                                     : kMaskedScore;
      }
    }

    // online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float new_max = fmaxf(row_max[i], tile_max);
      const float alpha = expf(row_max[i] - new_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - new_max);
        tile_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      row_sum[i] = row_sum[i] * alpha + tile_sum;
      row_max[i] = new_max;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * L::kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * L::kPStride + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < D ? vs[kk * L::kVStride + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_len) continue;
    const float inv = 1.f / row_sum[i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(&oh[(size_t)row * D + c], acc[i][j] * inv);
    }
  }
}

// Launch one (dtype, head dim, mask) instance on `stream`; returns the
// cudaError_t of the launch (the kernel runs asynchronously).
template <typename T, int D, typename Mask>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* ids, void* out, int batch, int heads,
                             int seq_len, float scale, cudaStream_t stream) {
  auto kernel = attention_tile_kernel<T, D, Mask>;
  const size_t smem = Layout<D>::kBytes;
  // the shared-memory opt-in holds per device: set it on a device's first
  // launch of this instance only, not on every launch
  static std::atomic<unsigned long long> opted_in{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device % 64);
  if (!(opted_in.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(ids),
      static_cast<T*>(out), heads, seq_len, scale);
  return cudaGetLastError();
}

}  // namespace marqo_attention
