// DeepSeek-V2's elementwise passes around its attention and MLP blocks for
// Hopper (sm_90a): the residual add folded into the RMSNorm that follows it,
// and RoPE folded into the assembly of latent attention's q and k.
//
// They replace no TPU kernel: the JAX package has no decoder LLM. They were
// added for DeepSeek-V2 (models/deepseek_v2.py), whose norms, residual adds
// and RoPE ran as PyTorch's generic elementwise kernels: an fp32 copy of
// every row, then pow, mean, a broadcast multiply, a cast back and the scale,
// each a pass over device memory; a separate bf16 pass for each residual
// add; RoPE as fp32 multiplies over strided even and odd views, a stack, a
// cast and two strided copies into q and k.
//
//   add_rms_norm: x (rows, W) bf16 with a row stride, delta (rows, W) bf16
//                 or null, scale (W,) bf16 -> normed (rows, W) bf16 and,
//                 with delta and where `sum` is not null, sum (rows, W) bf16:
//                   s      = bf16(x + delta)              (x without delta)
//                   normed = bf16(scale * bf16(s * rsqrt(mean(s^2) + eps)))
//                 the statistics in fp32 over the rounded s: the rounding
//                 points of `x + delta` followed by an RMSNorm that
//                 normalises in fp32 and scales in bf16.
//   mla_rope:     q (T, N, nope + rope) bf16, its RoPE part rotated in
//                 place; k (T, N, nope + rope) bf16 written whole: each
//                 head's no-RoPE key from kv_b (T, N, kv_b width)[..., :nope]
//                 and the one RoPE key a token shares, key (T, rope) with a
//                 row stride, rotated once a token and written to every
//                 head. Pairs are interleaved (2i, 2i + 1); cos and sin (T,
//                 rope / 2) fp32; each product, sum and difference rounded
//                 in fp32 on its own (no fused multiply-add), so the result
//                 is the plain composition's bit for bit, rounded once to
//                 bf16.
//
// Both are bf16 alone: the one model that runs them computes in bf16
// (inference/loaders.py TorchDeepseekV2Model); the wrappers
// (ops/decoder_glue.py) refuse other dtypes, whose CPU twins serve the
// tests.
//
// What bounds them on this card: bytes. An RMSNorm row moves 4 W to 8 W
// bytes against ~5 W operations; RoPE ~4 operations a value moved. So each
// reads its bf16 inputs once in 16-byte vectors (8 values a lane,
// neighbouring lanes on neighbouring vectors), keeps fp32 only in registers
// and writes each output once. add_rms_norm gives a row to one warp, each
// lane holding up to kMaxVecs of the row's vectors in registers (so W <=
// 32 x 8 x 8 = 2,048), so the row's sum of squares is a warp-shuffle
// reduction and the row is never read twice. mla_rope rotates a token's
// shared key once into shared memory, then stores it beside every head's
// no-RoPE key. At DeepSeek-V2-Lite's ingest shapes (PERF.md section 6): W =
// 2,048 (the hidden size, 8 vectors a lane) and 512 (the latent, read in
// place from the (T, 576) kv_a output) over 16,384 token slots; mla_rope
// at N = 16, nope 128, rope 64.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace marqo_decoder {

constexpr int kThreads = 256;
constexpr int kValues = 8;     // bf16 values in a 16-byte vector
constexpr int kMaxVecs = 8;    // a row's vectors a lane holds
constexpr int kRowsABlock = kThreads / 32;  // one warp a row
constexpr int kRopeThreads = 128;
constexpr int kMaxRopeVecs = 16;  // rope <= 128

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

// A block holds kRowsABlock rows, a warp each; lane l of a row owns the
// row's vectors l, l + 32, ... (kVecs of them at most).
template <int kVecs>
__global__ void __launch_bounds__(kThreads)
    add_rms_norm_kernel(const uint4* __restrict__ x, long long x_stride,
                        const uint4* __restrict__ delta,
                        const uint4* __restrict__ scale,
                        uint4* __restrict__ sum, uint4* __restrict__ normed,
                        long long rows, int width, float eps) {
  const int width_vecs = width / kValues;
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsABlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: its shuffles stay full
  const long long out_at = row * width_vecs;
  uint4 s[kVecs], d[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = lane + i * 32;
    if (c < width_vecs) {
      s[i] = __ldg(x + row * x_stride + c);
      if (delta != nullptr) d[i] = __ldcs(delta + out_at + c);
    }
  }
  float squares = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = lane + i * 32;
    if (c < width_vecs) {
      float v[kValues];
      unpack(s[i], v);
      if (delta != nullptr) {
        float e[kValues];
        unpack(d[i], e);
#pragma unroll
        for (int j = 0; j < kValues; ++j) v[j] = __fadd_rn(v[j], e[j]);
        s[i] = pack(v);  // rounded as x + delta rounds
        unpack(s[i], v);  // the statistics read the rounded sum
        if (sum != nullptr) sum[out_at + c] = s[i];
      }
#pragma unroll
      for (int j = 0; j < kValues; ++j) squares = fmaf(v[j], v[j], squares);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    squares += __shfl_xor_sync(0xffffffffu, squares, o);
  const float r = rsqrtf(squares / static_cast<float>(width) + eps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = lane + i * 32;
    if (c < width_vecs) {
      float v[kValues], w[kValues];
      unpack(s[i], v);
      unpack(__ldg(scale + c), w);
#pragma unroll
      for (int j = 0; j < kValues; ++j)
        v[j] = __fmul_rn(w[j], __bfloat162float(
                                   __float2bfloat16_rn(__fmul_rn(v[j], r))));
      normed[out_at + c] = pack(v);
    }
  }
}

// 8 interleaved values (4 pairs) rotated by their 4 angles' cos and sin.
__device__ __forceinline__ uint4 rotate(const uint4& in, const float4& c4,
                                        const float4& s4) {
  float v[kValues];
  unpack(in, v);
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  float out[kValues];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float even = v[2 * p], odd = v[2 * p + 1];
    out[2 * p] = __fsub_rn(__fmul_rn(even, c[p]), __fmul_rn(odd, s[p]));
    out[2 * p + 1] = __fadd_rn(__fmul_rn(even, s[p]), __fmul_rn(odd, c[p]));
  }
  return pack(out);
}

// One token a block. Vectors: a head of q and k is nope_vecs + rope_vecs,
// of kv_b kv_b_vecs; the token's cos and sin one float4 a rope vector. The
// shared key is rotated once into shared memory, then stored to each head.
__global__ void __launch_bounds__(kRopeThreads)
    mla_rope_kernel(uint4* __restrict__ q, uint4* __restrict__ k,
                    const uint4* __restrict__ kv_b,
                    const uint4* __restrict__ key, long long key_stride,
                    const float4* __restrict__ cos,
                    const float4* __restrict__ sin, int heads, int nope_vecs,
                    int rope_vecs, int kv_b_vecs) {
  __shared__ uint4 rotated[kMaxRopeVecs];
  const long long t = blockIdx.x;
  const int head_vecs = nope_vecs + rope_vecs;
  uint4* qt = q + t * heads * head_vecs;
  uint4* kt = k + t * heads * head_vecs;
  const uint4* bt = kv_b + t * heads * kv_b_vecs;
  const float4* ct = cos + t * rope_vecs;
  const float4* st = sin + t * rope_vecs;
  for (int c = threadIdx.x; c < rope_vecs; c += blockDim.x)
    rotated[c] =
        rotate(__ldg(key + t * key_stride + c), __ldg(ct + c), __ldg(st + c));
  for (int i = threadIdx.x; i < heads * nope_vecs; i += blockDim.x) {
    const int h = i / nope_vecs, c = i - h * nope_vecs;
    kt[h * head_vecs + c] = __ldcs(bt + h * kv_b_vecs + c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < heads * rope_vecs; i += blockDim.x) {
    const int h = i / rope_vecs, c = i - h * rope_vecs;
    uint4* at = qt + h * head_vecs + nope_vecs + c;
    *at = rotate(*at, __ldg(ct + c), __ldg(st + c));
    kt[h * head_vecs + nope_vecs + c] = rotated[c];
  }
}

template <int kVecs>
void launch_add_rms_norm(long long blocks, cudaStream_t stream,
                         const uint4* x, long long x_stride,
                         const uint4* delta, const uint4* scale, uint4* sum,
                         uint4* normed, long long rows, int width,
                         float eps) {
  add_rms_norm_kernel<kVecs><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(x, x_stride, delta, scale, sum,
                                         normed, rows, width, eps);
}

}  // namespace marqo_decoder

// x rows `x_stride` values apart; delta (or null), sum (or null) and normed
// (rows, width) contiguous; scale (width,); all bf16 and 16-byte aligned,
// width and x_stride multiples of 8, width <= 2,048. rows >= 1.
extern "C" int marqo_add_rms_norm(const void* x, long long x_stride,
                                  const void* delta, const void* scale,
                                  void* sum, void* normed, long long rows,
                                  int width, float eps, void* stream) {
  using namespace marqo_decoder;
  if (rows < 1 || width < kValues || width % kValues != 0 ||
      x_stride < width || x_stride % kValues != 0 ||
      width / kValues > 32 * kMaxVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (width / kValues + 31) / 32;
  const long long blocks = (rows + kRowsABlock - 1) / kRowsABlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xv = static_cast<const uint4*>(x);
  const auto* dv = static_cast<const uint4*>(delta);
  const auto* wv = static_cast<const uint4*>(scale);
  auto* sv = static_cast<uint4*>(sum);
  auto* nv = static_cast<uint4*>(normed);
  const long long stride = x_stride / kValues;
  if (per_lane <= 1)
    launch_add_rms_norm<1>(blocks, s, xv, stride, dv, wv, sv, nv, rows,
                           width, eps);
  else if (per_lane <= 2)
    launch_add_rms_norm<2>(blocks, s, xv, stride, dv, wv, sv, nv, rows,
                           width, eps);
  else if (per_lane <= 4)
    launch_add_rms_norm<4>(blocks, s, xv, stride, dv, wv, sv, nv, rows,
                           width, eps);
  else
    launch_add_rms_norm<8>(blocks, s, xv, stride, dv, wv, sv, nv, rows,
                           width, eps);
  return static_cast<int>(cudaGetLastError());
}

// q and k (tokens, heads, nope + rope), kv_b (tokens, heads, kv_b_width)
// contiguous; key rows `key_stride` values apart; all bf16 and 16-byte
// aligned; cos and sin (tokens, rope / 2) fp32, contiguous and 16-byte
// aligned. nope (>= 0), rope (8 to 128), kv_b_width and key_stride multiples
// of 8, nope <= kv_b_width, rope <= key_stride. tokens >= 1, heads >= 1.
extern "C" int marqo_mla_rope(void* q, void* k, const void* kv_b,
                              const void* key, long long key_stride,
                              const void* cos, const void* sin,
                              long long tokens, int heads, int nope, int rope,
                              int kv_b_width, void* stream) {
  using namespace marqo_decoder;
  if (tokens < 1 || tokens > 0x7fffffffLL || heads < 1 || nope < 0 ||
      rope < kValues || rope > kValues * kMaxRopeVecs ||
      nope % kValues != 0 || rope % kValues != 0 ||
      kv_b_width < nope || kv_b_width % kValues != 0 || key_stride < rope ||
      key_stride % kValues != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  mla_rope_kernel<<<static_cast<unsigned>(tokens), kRopeThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(q), static_cast<uint4*>(k),
      static_cast<const uint4*>(kv_b), static_cast<const uint4*>(key),
      key_stride / kValues, static_cast<const float4*>(cos),
      static_cast<const float4*>(sin), heads, nope / kValues,
      rope / kValues, kv_b_width / kValues);
  return static_cast<int>(cudaGetLastError());
}
