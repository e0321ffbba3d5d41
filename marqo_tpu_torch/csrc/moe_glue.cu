// The expert layer's two elementwise passes for Hopper (sm_90a): the SwiGLU
// between a SwiGLU's two GEMMs, and the routed experts' weighted combine.
//
// They replace no TPU kernel: the JAX package has no mixture of experts.
// They were added for DeepSeek-V2 (models/deepseek_v2.py, ops/moe.py),
// whose expert layer spent as long in PyTorch's elementwise glue around
// its grouped GEMMs as in the GEMMs: a SiLU pass and a multiply pass over
// strided halves of the gate/up output, a gather of every down row into
// token order, and a batched (1, k) x (k, H) GEMV, each over every row of
// the static buffers, pad rows included.
//
//   moe_swiglu:  h (M, 2W) bf16 rows [gate | up] -> act (M, W) bf16,
//                act = silu(gate) * up in fp32 registers, rounded once.
//                With `count` (a device int, the routed groups' last end
//                offset) only rows < *count are read and written: a block
//                whose first vector lies past them returns at once. Rows
//                past it stay as they were (undefined, as grouped_mm's
//                rows past its last offset; the down GEMM never reads
//                them). The grid is sized by the static M, so a CUDA graph
//                captures the pass whole and each replay reads the count
//                its forward computed.
//   moe_combine: y (T k, H) bf16 in expert order, back (T, k) int32 rows
//                of y, weights (T, k) fp32, valid (T,) bytes, k <= 8 ->
//                out (T, H) bf16 = sum_j weights[t, j] y[back[t, j]] in
//                fp32, rounded once; a pad token (valid 0) is written as
//                zeros and its rows are never read.
//
// Both are bf16 alone: the one model that runs them computes in bf16
// (inference/loaders.py TorchDeepseekV2Model); the wrappers refuse other
// dtypes, whose CPU twins serve the tests.
//
// What bounds them on this card: bytes. A SwiGLU row moves 3 W values (gate
// and up read, act written) against ~6 W operations, a combine token
// (k + 1) H values against 2 k H: both ~1 operation a byte, far under the
// H100's ~295. So each reads every real row once with 16-byte vector loads
// (8 bf16 values a lane, neighbouring lanes on neighbouring vectors), keeps
// everything between load and store in registers, and writes with 16-byte
// stores; each thread keeps several loads in flight (kVecs SwiGLU vectors,
// or a token's k combine rows) before it uses any. At DeepSeek-V2-Lite's
// ingest shapes (PERF.md section 6): SwiGLU W = 1,408 over ~98k routed rows
// and 2,816 or 10,944 over 16k tokens; combine k = 6, H = 2,048 over 16k
// tokens.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper (ops/moe.py) raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace marqo_moe {

constexpr int kThreads = 256;
constexpr int kVecs = 4;      // SwiGLU vectors a thread
constexpr int kMaxTopK = 8;   // combine rows a token, all in flight at once
constexpr int kValues = 8;    // bf16 values in a 16-byte vector

__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* in) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return v;
}

// The vector index space is (rows x width_vecs), width_vecs = W / 8; block b
// covers vectors [b kThreads kVecs, (b + 1) kThreads kVecs), lane-contiguous
// in each of its kVecs steps.
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_kernel(const uint4* __restrict__ h, uint4* __restrict__ act,
                      long long rows, int width_vecs,
                      const int* __restrict__ count) {
  long long live = rows;
  if (count != nullptr) {
    const long long c = __ldg(count);
    live = c < 0 ? 0 : (c < rows ? c : rows);
  }
  const long long total = live * width_vecs;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  if (first - threadIdx.x >= total) return;
  uint4 gate[kVecs], up[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long v = first + i * kThreads;
    if (v < total) {
      const long long row = v / width_vecs;
      const long long at = v + row * width_vecs;  // row 2 width + column
      gate[i] = __ldcs(h + at);
      up[i] = __ldcs(h + at + width_vecs);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long v = first + i * kThreads;
    if (v < total) {
      float g[kValues], u[kValues];
      unpack(gate[i], g);
      unpack(up[i], u);
#pragma unroll
      for (int e = 0; e < kValues; ++e)
        g[e] = g[e] / (1.0f + expf(-g[e])) * u[e];
      act[v] = pack(g);
    }
  }
}

// One token a block; each thread owns H-vectors c, c + blockDim, ...
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const uint4* __restrict__ y,
                       const int* __restrict__ back,
                       const float* __restrict__ weights,
                       const uint8_t* __restrict__ valid,
                       uint4* __restrict__ out, int top_k, int hidden_vecs) {
  const int t = blockIdx.x;
  uint4* dst = out + static_cast<long long>(t) * hidden_vecs;
  if (!valid[t]) {
    for (int c = threadIdx.x; c < hidden_vecs; c += blockDim.x)
      dst[c] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int* rows = back + static_cast<long long>(t) * top_k;
  const float* w = weights + static_cast<long long>(t) * top_k;
  for (int c = threadIdx.x; c < hidden_vecs; c += blockDim.x) {
    uint4 part[kMaxTopK];
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j)
      if (j < top_k)
        part[j] = __ldcs(y + static_cast<long long>(__ldg(rows + j)) *
                                 hidden_vecs + c);
    float acc[kValues];
#pragma unroll
    for (int e = 0; e < kValues; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j < top_k) {
        const float wj = __ldg(w + j);
        float r[kValues];
        unpack(part[j], r);
#pragma unroll
        for (int e = 0; e < kValues; ++e) acc[e] = fmaf(wj, r[e], acc[e]);
      }
    }
    dst[c] = pack(acc);
  }
}

}  // namespace marqo_moe

// h (rows, 2 width) and act (rows, width) bf16, both contiguous and 16-byte
// aligned, width a multiple of 8; count a device int or null. rows >= 1.
extern "C" int marqo_moe_swiglu(const void* h, void* act, long long rows,
                                int width, const void* count, void* stream) {
  using namespace marqo_moe;
  if (rows < 1 || width < kValues || width % kValues != 0 ||
      rows * (width / kValues) > (1LL << 31) * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width_vecs = width / kValues;
  const long long per_block = static_cast<long long>(kThreads) * kVecs;
  const long long blocks = (rows * width_vecs + per_block - 1) / per_block;
  moe_swiglu_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(h), static_cast<uint4*>(act), rows,
      width_vecs, static_cast<const int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// y (tokens top_k, hidden) bf16, back (tokens, top_k) int32, weights
// (tokens, top_k) fp32, valid (tokens,) bytes, out (tokens, hidden) bf16;
// contiguous, y and out 16-byte aligned, hidden a multiple of 8. tokens >= 1,
// 1 <= top_k <= 8.
extern "C" int marqo_moe_combine(const void* y, const void* back,
                                 const void* weights, const void* valid,
                                 void* out, int tokens, int top_k, int hidden,
                                 void* stream) {
  using namespace marqo_moe;
  if (tokens < 1 || top_k < 1 || top_k > kMaxTopK || hidden < kValues ||
      hidden % kValues != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hidden_vecs = hidden / kValues;
  // a warp at least, and no thread without a vector where H is small
  int threads = (hidden_vecs + 31) / 32 * 32;
  threads = threads < kThreads ? threads : kThreads;
  moe_combine_kernel<<<tokens, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const int*>(back),
      static_cast<const float*>(weights), static_cast<const uint8_t*>(valid),
      static_cast<uint4*>(out), top_k, hidden_vecs);
  return static_cast<int>(cudaGetLastError());
}
