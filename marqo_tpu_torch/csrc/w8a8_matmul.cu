// Fused W8A8 linear layer for Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel marqo_tpu/ops/quant_matmul.py `_w8a8_kernel`
// (launched by `w8a8_matmul`). For x (M, K) in fp32 or bf16, w_q (N, K) int8
// (nn.Linear's (out, in) layout, quantized per output channel), w_scale (N,)
// fp32 and bias (N,) fp32:
//   x_scale[m] = max(absmax_k |x[m, k]| / 127, 1e-8)        (whole row)
//   x_q[m, k]  = clamp(rint(x[m, k] / x_scale[m]), -127, 127) as int8
//   acc[m, n]  = sum_k x_q[m, k] * w_q[n, k]                 (exact, int32)
//   y[m, n]    = (float(acc) * x_scale[m]) * w_scale[n] + bias[n]
// and y is written in x's dtype. Every step rounds as the plain twin does:
// IEEE division (__fdiv_rn), rint (half to even, as jnp.round and
// torch.round), and an epilogue of __fmul_rn / __fadd_rn in JAX's order
// (marqo_tpu/ops/quant.py:54-55), so nvcc contracts nothing into an FMA and
// the output equals the twin's bit for bit. Built without --use_fast_math.
//
// What bounds it on this card, in bf16 (H100 SXM: 1,979 TOP/s int8 dense,
// 3.35 TB/s), x read once, w_q read once, y written once:
//   (M, K, N) = (32768,  768,  768)  bytes,      0.030 ms (101 MB)
//               (32768,  768, 2304)  bytes,      0.061 ms (203 MB; q, k, v)
//               (32768,  768, 3072)  operations, 0.078 ms (155 G int8 ops)
//               (32768, 3072,  768)  operations, 0.078 ms
// and a query's (32, 768, 3072) is a 2.4 MB weight read, launch-bound.
//
// Design. The TPU kernel fused the quantization into the matmul, because a
// whole (256, K) row block fits its VMEM. A row's absmax spans all of K, and
// each of the N / BN column blocks here would reduce it again, so B3 stays
// two kernels on one stream:
//   1. w8a8_quantize_rows: a warp per row (a half warp where that shares
//      the row's 16-value chunks out evenly: K = 256, 768) reads the row
//      once into registers with 16-byte loads (16 values a lane per chunk),
//      reduces the absmax across the lanes, quantizes from registers and
//      writes x_q (M, K) int8 with 16-byte stores and x_scale (M,) to
//      scratch the wrapper allocates: the bytes bound, 75 MB at K = 768 and
//      300 MB at K = 3072.
//      It multiplies by the reciprocal of the scale and divides (IEEE) only
//      where the product lies within 1e-4 of a half-integer, the one place
//      the two could round apart, so it stays exact without a division per
//      value.
//      A row of more than 4096 values (32 lanes x 8 chunks) does not fit a
//      warp's registers: it takes a two-pass instance that reads the row
//      for its absmax, then again (from L2) to quantize it.
//   2. w8a8_gemm: the int8 product on Hopper's warpgroup MMA
//      (wgmma.mma_async m64nNk32 .s32.s8.s8, A and B both K-major from
//      shared memory: x_q is (M, K) and w_q is (N, K), no transposes). A
//      persistent block per SM walks 128 x BN output tiles, N fastest, so a
//      wave of blocks shares rows of x_q in L2 (the weights, 2.4 MB at e5's
//      FFN, stay in L2 throughout). 384 threads: a producer warpgroup (one
//      thread issues the TMA copies, setmaxnreg 40) and two consumer
//      warpgroups (64 x BN each, setmaxnreg 232). TMA copies 128-byte K
//      slices of both operands with the 128-byte swizzle into a ring of
//      stages in dynamic shared memory, one full/empty mbarrier pair per
//      stage; a consumer keeps one wgmma group in flight and releases a
//      stage when the group that read it has retired. TMA zero-fills past M,
//      N and K, so any M >= 1, N >= 1 and K a multiple of 16 work. The
//      epilogue's scales and bias are loaded when a tile starts, so they
//      arrive behind its products; each accumulator becomes y in registers,
//      and 64-row x 128-byte slices of y are staged in shared memory (the
//      128-byte swizzle, two buffers a consumer) and written by TMA stores
//      that drain behind the next tile's products. Where the output's row
//      stride is not a multiple of 16 bytes (N % 8 != 0 in bf16, N % 4 != 0
//      in fp32) TMA cannot store it, and the consumers write the slice
//      element by element instead.
// The host picks BN by the number of tiles: 128 (an m64n128 product per
// consumer and k-step, 64 accumulators a thread, 5 stages) when the
// 128 x 128 tiles fill the card's SMs, else 64 (8 stages), which spreads a
// query's few rows over twice as many blocks. Each instance's ring is as
// deep as its shared memory holds (Layout<BN>::kStages); shallower rings
// and 128 x 256 tiles (3 stages) ran slower at the encoder's shapes.
// wgmma and setmaxnreg need sm_90a, which ops/_build.py's flags give.
//
// The TMA descriptors are encoded on the host for every call (x_q and out
// come from PyTorch's caching allocator) with cuTensorMapEncodeTiled, a
// driver-API function: it is fetched through the runtime's
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace marqo_hopper;

// --- the row quantizer -------------------------------------------------------

constexpr int kQuantWarps = 8;  // rows per block, one warp per row
constexpr int kChunk = 16;      // values a lane quantizes per chunk

// A chunk of 16 values as raw 16-byte words: two for bf16, four for fp32.
template <typename T>
struct ChunkWords {
  static constexpr int kWords = kChunk * sizeof(T) / 16;
};

__device__ __forceinline__ void to_floats(const uint4 (&w)[4], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = __uint_as_float(w[i].x);
    v[4 * i + 1] = __uint_as_float(w[i].y);
    v[4 * i + 2] = __uint_as_float(w[i].z);
    v[4 * i + 3] = __uint_as_float(w[i].w);
  }
}

__device__ __forceinline__ void to_floats(const uint4 (&w)[2], float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 pair;
      *reinterpret_cast<uint32_t*>(&pair) = words[j];
      const float2 f = __bfloat1622float2(pair);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// the largest |value| of a chunk: fp32 as floats; bf16 on the raw halves
// (|v| is v without its sign bit, and non-negative bf16 values order as
// their bits do), so the absmax pass needs no conversions
__device__ __forceinline__ float chunk_absmax(const uint4 (&w)[4]) {
  float v[16];
  to_floats(w, v);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) m = fmaxf(m, fabsf(v[j]));
  return m;
}

__device__ __forceinline__ float chunk_absmax(const uint4 (&w)[2]) {
  uint32_t m = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m = __vmaxu2(m, w[i].x & 0x7fff7fffu);
    m = __vmaxu2(m, w[i].y & 0x7fff7fffu);
    m = __vmaxu2(m, w[i].z & 0x7fff7fffu);
    m = __vmaxu2(m, w[i].w & 0x7fff7fffu);
  }
  return __uint_as_float(max(m >> 16, m & 0xffffu) << 16);
}

// A chunk's 16 values quantized by the row's scale, packed as 16 int8.
template <int kWords>
__device__ __forceinline__ uint4 quantize_chunk(const uint4 (&raw)[kWords],
                                                float scale, float inverse) {
  float v[kChunk];
  to_floats(raw, v);
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    // v * (1 / scale) is within 3e-5 of the IEEE quotient v / scale (|q|
    // <= 127.5, two roundings of 2^-24 each), so its rint is the
    // quotient's unless it lies that near a half-integer: divide there
    const float y = __fmul_rn(v[j], inverse);
    float q = rintf(y);
    if (fabsf(y - q) > 0.4999f) q = rintf(__fdiv_rn(v[j], scale));
    q = fminf(fmaxf(q, -127.f), 127.f);
    packed[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         static_cast<int8_t>(static_cast<int>(q))))
                     << (8 * (j % 4));
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// kLanes (16 or 32) lanes per row; lane l holds chunks l, l + kLanes, ...
// of the row (K / 16 chunks; kChunks is at least their count over kLanes).
// The row is read from device memory once.
template <typename T, int kLanes, int kChunks>
__global__ void __launch_bounds__(kQuantWarps * 32)
    w8a8_quantize_rows(const T* __restrict__ x, int8_t* __restrict__ x_q,
                       float* __restrict__ x_scale, int M, int K) {
  constexpr int kWords = ChunkWords<T>::kWords;
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * (kQuantWarps * 32 / kLanes) +
                  threadIdx.x / kLanes;
  // a row past M still joins its warp's shuffles
  const bool valid = row < M;
  const int chunks = valid ? K / kChunk : 0;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + static_cast<size_t>(valid ? row : 0) * K);
  uint4 raw[kChunks][kWords];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int chunk = c * kLanes + lane;
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      raw[c][w] = chunk < chunks ? __ldcs(src + chunk * kWords + w)
                                 : make_uint4(0u, 0u, 0u, 0u);
  }
  float absmax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    absmax = fmaxf(absmax, chunk_absmax(raw[c]));
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, offset));
  const float scale = fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
  const float inverse = __frcp_rn(scale);
  if (valid && lane == 0) x_scale[row] = scale;

  uint4* dst = reinterpret_cast<uint4*>(
      x_q + static_cast<size_t>(valid ? row : 0) * K);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int chunk = c * kLanes + lane;
    if (chunk >= chunks) break;
    dst[chunk] = quantize_chunk(raw[c], scale, inverse);
  }
}

// Rows longer than a warp holds in registers (more than 8 chunks a lane: K
// over 4096, e.g. an FFN of 5120) take two passes, a warp per row: the
// absmax, then the quantization, which reads the row again. A block's 8
// rows (80 KB in bf16 at K = 5120) are still in L2 for the second read, so
// device memory still sees each row about once.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
    w8a8_quantize_rows_two_pass(const T* __restrict__ x,
                                int8_t* __restrict__ x_q,
                                float* __restrict__ x_scale, int M, int K) {
  constexpr int kWords = ChunkWords<T>::kWords;
  const int lane = threadIdx.x % 32;
  // warp-uniform: a warp past M leaves whole
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= M) return;
  const int chunks = K / kChunk;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + static_cast<size_t>(row) * K);
  float absmax = 0.f;
  for (int chunk = lane; chunk < chunks; chunk += 32) {
    uint4 raw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) raw[w] = __ldg(src + chunk * kWords + w);
    absmax = fmaxf(absmax, chunk_absmax(raw));
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, offset));
  const float scale = fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
  const float inverse = __frcp_rn(scale);
  if (lane == 0) x_scale[row] = scale;

  uint4* dst = reinterpret_cast<uint4*>(x_q + static_cast<size_t>(row) * K);
  for (int chunk = lane; chunk < chunks; chunk += 32) {
    uint4 raw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      raw[w] = __ldcs(src + chunk * kWords + w);
    dst[chunk] = quantize_chunk(raw, scale, inverse);
  }
}

template <typename T, int kLanes, int kChunks>
void launch_quantize(const void* x, void* x_q, void* x_scale, int M, int K,
                     cudaStream_t stream) {
  constexpr int kRows = kQuantWarps * 32 / kLanes;  // rows per block
  w8a8_quantize_rows<T, kLanes, kChunks>
      <<<(M + kRows - 1) / kRows, kQuantWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(x_q),
          static_cast<float*>(x_scale), M, K);
}

// the instance for K / 16 chunks: a half warp per row where that shares
// them out evenly and a whole warp would not (K = 256 and 768), else a
// warp with the fewest chunks a lane that hold them, and past 8 chunks a
// lane (K > 4096) the two-pass kernel
template <typename T>
void quantize(const void* x, void* x_q, void* x_scale, int M, int K,
              cudaStream_t stream) {
  const int chunks = K / kChunk;
  const int per_lane = (chunks + 31) / 32;
  if (chunks == 16) launch_quantize<T, 16, 1>(x, x_q, x_scale, M, K, stream);
  else if (chunks == 48)
    launch_quantize<T, 16, 3>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 1)
    launch_quantize<T, 32, 1>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 2)
    launch_quantize<T, 32, 2>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 3)
    launch_quantize<T, 32, 3>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 4)
    launch_quantize<T, 32, 4>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 6)
    launch_quantize<T, 32, 6>(x, x_q, x_scale, M, K, stream);
  else if (per_lane <= 8)
    launch_quantize<T, 32, 8>(x, x_q, x_scale, M, K, stream);
  else
    w8a8_quantize_rows_two_pass<T>
        <<<(M + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0,
           stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(x_q),
                     static_cast<float*>(x_scale), M, K);
}

// --- the GEMM: TMA, mbarriers, wgmma -----------------------------------------

constexpr int kBM = 128;           // output rows per tile (two consumers)
constexpr int kBK = 128;           // int8 values of K per stage: a swizzle row
constexpr int kThreads = 384;      // producer warpgroup + two consumers
// the epilogue stages a consumer's 64 rows x 128 bytes of output at a time
// (a slice), in two buffers per consumer warpgroup
constexpr int kSliceBytes = 64 * 128;
constexpr int kStagingBytes = 2 * 2 * kSliceBytes;
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use
constexpr int kMaxStages = 8;

template <int BN>
struct Layout {
  static constexpr int kA = kBM * kBK;  // 16 KB
  static constexpr int kB = BN * kBK;
  static constexpr int kStage = kA + kB;
  // each consumer's tile columns: {w_scale, w_scale, bias, bias} a pair
  static constexpr int kColumns = 2 * (BN / 2) * 16;
  static constexpr int kFixed = 1024 + kStagingBytes + kColumns;
  // as many stages as fit (5 at BN = 128, 8 at 64), each with two 8-byte
  // mbarriers; kFixed holds 1 KB of slack to align the ring to the 128-byte
  // swizzle's 1 KB atom
  static constexpr int kStages =
      (kSmemLimit - kFixed) / (kStage + 16) < kMaxStages
          ? (kSmemLimit - kFixed) / (kStage + 16)
          : kMaxStages;
  static constexpr int kBytes = kFixed + kStages * (kStage + 16);
};

// the box of `map` at (inner, outer) = (k, row) into shared memory; the
// copy completes bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// the box at (inner, outer) = (column, row) of `map` from shared memory, in
// the calling thread's bulk group; TMA clips what lies past the edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d[64 x BN] (+)= a[64 x 32] . b[BN x 32]^T, int8 in, int32 out; scale_d 0
// overwrites d. The accumulator fragment: d[4 i + 2 h + j] is row
// 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + j.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ float epilogue(int acc, float xs, float ws,
                                          float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), b);
}

// two adjacent outputs into a staged slice
__device__ __forceinline__ void store2(uint8_t* dst, float a, float b,
                                       float) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint8_t* dst, float a, float b,
                                       __nv_bfloat16) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// w_scale and bias of columns n and n + 1 (0 past N)
__device__ __forceinline__ void column_pair(const float* __restrict__ v, int n,
                                            int N, float& a, float& b) {
  if (n + 1 < N) {
    const float2 pair = __ldg(reinterpret_cast<const float2*>(v + n));
    a = pair.x;
    b = pair.y;
  } else {
    a = n < N ? __ldg(v + n) : 0.f;
    b = 0.f;
  }
}

// byte offset of (row, byte) in a slice of 128-byte rows under the 128-byte
// swizzle (16-byte chunk index XOR row % 8), which TMA's store undoes
__device__ __forceinline__ int swizzled(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_out,
              const float* __restrict__ x_scale,
              const float* __restrict__ w_scale,
              const float* __restrict__ bias, T* __restrict__ out, int M,
              int K, int N, int store_tma) {
  using L = Layout<BN>;
  constexpr int stages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring_a = smem;
  uint8_t* ring_b = ring_a + stages * L::kA;
  uint8_t* staging = ring_b + stages * L::kB;
  float4* columns = reinterpret_cast<float4*>(staging + kStagingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(columns) + L::kColumns);
  uint64_t* empty = full + stages;

  const int n_blocks = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * n_blocks;
  const int k_blocks = (K + kBK - 1) / kBK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_blocks * kBM;
        const int n0 = tile % n_blocks * BN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::kStage);
          tma_load(ring_a + stage * L::kA, &map_x, kb * kBK, m0, &full[stage]);
          tma_load(ring_b + stage * L::kB, &map_w, kb * kBK, n0, &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: rows 64 c .. 64 c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = warpgroup - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r0 = warp * 16 + lane / 4;  // fragment rows r0 and r0 + 8
    const int q = lane % 4;               // fragment columns 2 q, 2 q + 1
    constexpr int kCols = 128 / sizeof(T);  // columns per slice
    constexpr int kSlices = BN / kCols;
    uint8_t* slices = staging + c * 2 * kSliceBytes;
    float4* tile_columns = columns + c * (BN / 2);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_blocks * kBM;
      const int n0 = tile % n_blocks * BN;
      // the epilogue's operands, loaded while the products run
      float4 column = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < BN / 2) {
        column_pair(w_scale, n0 + 2 * t, N, column.x, column.y);
        column_pair(bias, n0 + 2 * t, N, column.z, column.w);
      }
      const int row0 = m0 + c * 64 + r0;
      const float xs0 = row0 < M ? __ldg(x_scale + row0) : 0.f;
      const float xs1 = row0 + 8 < M ? __ldg(x_scale + row0 + 8) : 0.f;

      int previous = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t a =
            desc_k_major(smem_addr(ring_a + stage * L::kA + c * 64 * kBK));
        const uint64_t b = desc_k_major(smem_addr(ring_b + stage * L::kB));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 32; ++k)
          Wgmma<BN>::run(acc, a + 2 * k, b + 2 * k, kb > 0 || k > 0);
        wgmma_commit();
        if (kb > 0) {
          // the previous stage's products have retired: release it
          wgmma_wait<1>();
          if (t == 0) mbar_arrive(&empty[previous]);
        }
        previous = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (t == 0) mbar_arrive(&empty[previous]);
      fence_operands(acc);

      // the last tile's stores have read the slices; its epilogue has read
      // the columns
      if (store_tma && t == 0) bulk_wait_read<0>();
      if (t < BN / 2) tile_columns[t] = column;
      named_barrier(1 + c, 128);
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        uint8_t* slice = slices + (s % 2) * kSliceBytes;
        if (store_tma && s >= 2) {
          // the store of slice s - 2 has read this buffer
          if (t == 0) bulk_wait_read<1>();
          named_barrier(1 + c, 128);
        }
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int i = s * (kCols / 8) + j;
          const float4 col = tile_columns[4 * i + q];
          const int byte = (8 * j + 2 * q) * static_cast<int>(sizeof(T));
          store2(slice + swizzled(r0, byte),
                 epilogue(acc[4 * i], xs0, col.x, col.z),
                 epilogue(acc[4 * i + 1], xs0, col.y, col.w), T());
          store2(slice + swizzled(r0 + 8, byte),
                 epilogue(acc[4 * i + 2], xs1, col.x, col.z),
                 epilogue(acc[4 * i + 3], xs1, col.y, col.w), T());
        }
        if (store_tma) {
          // one thread hands the slice to TMA, which writes it behind the
          // next products
          fence_proxy_async();
          named_barrier(1 + c, 128);
          if (t == 0) {
            tma_store(&map_out, slice, n0 + s * kCols, m0 + c * 64);
            bulk_commit();
          }
        } else {
          // output rows not 16-byte aligned: 16-byte pieces where they fit,
          // else element by element
          named_barrier(1 + c, 128);
          constexpr int kVec = 16 / sizeof(T);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int piece = t + 128 * p;
            const int r = piece / 8;
            const int row = m0 + c * 64 + r;
            const int col = n0 + s * kCols + piece % 8 * kVec;
            if (row < M && col < N) {
              const T* src = reinterpret_cast<const T*>(
                  slice + swizzled(r, piece % 8 * 16));
              T* dst = out + static_cast<size_t>(row) * N + col;
              for (int e = 0; e < kVec && col + e < N; ++e) dst[e] = src[e];
            }
          }
          named_barrier(1 + c, 128);
        }
      }
    }
    if (store_tma && t == 0) bulk_wait_all();
  }
}

// --- host side ---------------------------------------------------------------

// a (rows, cols) row-major matrix of `type` in boxes of box_rows rows and
// 128 bytes, with the 128-byte swizzle; loads past its edges read zeros,
// stores past them are dropped. The row stride must be a multiple of 16
// bytes.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int element_bytes,
                const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 element_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / element_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

constexpr int kMaxDevices = 64;
// the int32 sum of K products of at most 127 * 127 stays below 2^31
constexpr int kMaxK = 131072;

template <typename T, int BN>
cudaError_t launch_gemm(const void* x_q, const void* w_q, const void* x_scale,
                        const void* w_scale, const void* bias, void* out,
                        int M, int K, int N, int device, int sms,
                        cudaStream_t stream) {
  using L = Layout<BN>;
  CUtensorMap map_x, map_w, map_out = {};
  const bool store_tma = N * sizeof(T) % 16 == 0;
  if (!encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x_q, M, K, kBM) ||
      !encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_q, N, K, BN) ||
      (store_tma && !encode_map(&map_out, map_type<T>(), sizeof(T), out, M,
                                N, 64)))
    return cudaErrorInvalidValue;
  // the shared-memory limit is set once per device (racing calls set the
  // same value)
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8a8_gemm<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const int tiles = (M + kBM - 1) / kBM * ((N + BN - 1) / BN);
  w8a8_gemm<T, BN><<<tiles < sms ? tiles : sms, kThreads, L::kBytes,
                     stream>>>(
      map_x, map_w, map_out, static_cast<const float*>(x_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<T*>(out), M, K, N, store_tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w_q, const void* w_scale,
                   const void* bias, void* out, void* x_q, void* x_scale,
                   int M, int K, int N, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  quantize<T>(x, x_q, x_scale, M, K, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 128-wide tiles where they fill the SMs, else 64-wide
  return (M + kBM - 1) / kBM * ((N + 127) / 128) >= sms
             ? launch_gemm<T, 128>(x_q, w_q, x_scale, w_scale, bias, out, M,
                                   K, N, device, sms, stream)
             : launch_gemm<T, 64>(x_q, w_q, x_scale, w_scale, bias, out, M,
                                  K, N, device, sms, stream);
}

}  // namespace

// x: (M, K) fp32 or bf16 (bf16 != 0); w_q: (N, K) int8; w_scale, bias: (N,)
// fp32; out: (M, N) in x's dtype; x_q: (M, K) int8 and x_scale: (M,) fp32
// scratch. All contiguous and 16-byte aligned; M >= 1, N >= 1, K a positive
// multiple of 16 up to kMaxK. Returns the cudaError_t of the launches (0 on
// success); the kernels run asynchronously on `stream`.
extern "C" int marqo_w8a8_matmul(const void* x, const void* w_q,
                                 const void* w_scale, const void* bias,
                                 void* out, void* x_q, void* x_scale, int M,
                                 int K, int N, int bf16, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w_q, w_scale, bias, out, x_q, x_scale,
                                   M, K, N, s)
           : launch<float>(x, w_q, w_scale, bias, out, x_q, x_scale, M, K, N,
                           s);
  return static_cast<int>(err);
}
