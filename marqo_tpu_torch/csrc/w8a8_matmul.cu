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
// torch.round), and an epilogue of __fmul_rn / __fadd_rn in JAX's order, so
// nvcc contracts nothing into an FMA. Built without --use_fast_math.
//
// Design. The TPU kernel fused the quantization into the matmul, because a
// whole (256, K) row block fits its VMEM. A block here cannot hold a row
// block (a 128-row bf16 tile at K = 3072 is 768 KB, over the 227 KB of
// shared memory), and each of the N / 128 column blocks would reduce the
// same rows' absmax again. So B3 is two kernels on one stream:
//   1. quantize_rows: one warp per row reads the row twice (absmax, then
//      quantize; the second read hits L1/L2) and writes x_q (M, K) int8 and
//      x_scale (M,) fp32 to scratch the wrapper allocates. At the e5-base
//      ingest shape this is 50 MB read and 25 MB written, about 25 us.
//   2. w8a8_gemm: 128 x 128 output tiles, 8 warps of 64 x 32 each, K in
//      64-byte steps, double-buffered with cp.async (zero-filled past the
//      edges of M, N and K, so any M >= 1 and N >= 1 and K a multiple of 16
//      work). The product runs on the int8 tensor cores with
//      mma.sync.m16n8k32.s8.s8.s32; shared-memory rows are padded from 64 to
//      80 bytes, which makes the 32-bit fragment loads conflict-free. The
//      fp32 epilogue reads x_scale, w_scale and bias and stores pairs of
//      outputs when N is even.
// What bounds it: at the encoder's shapes (M = 32768, K and N 768 / 3072)
// the product is 39-155 G int8 operations against 100-254 MB of traffic,
// so the bound is the tensor cores (1,979 TOP/s dense) or memory
// (3.35 TB/s), about 30-80 us. mma.sync with a two-stage pipeline reaches a
// fraction of the wgmma peak; wgmma, TMA and a persistent schedule are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantWarps = 8;  // rows per quantize block, one warp per row

constexpr int kBM = 128;            // output rows per GEMM block
constexpr int kBN = 128;            // output columns per GEMM block
constexpr int kBK = 64;             // int8 values of K per pipeline stage
constexpr int kStride = kBK + 16;   // bytes per shared-memory row (padded)
constexpr int kGemmThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;          // each warp: 4 m16 tiles
constexpr int kWarpN = 32;          // each warp: 4 n8 tiles

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* dst, float y) { *dst = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float y) {
  *dst = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// One warp per row: absmax over the whole row, then the row's int8 values.
// K is a multiple of 16, so a row is a whole number of 8-value chunks and
// every chunk is 16-byte aligned (bf16) or two 16-byte halves (fp32).
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantize_rows(const T* __restrict__ x, int8_t* __restrict__ x_q,
                  float* __restrict__ x_scale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* src = x + static_cast<size_t>(row) * K;
  int8_t* dst = x_q + static_cast<size_t>(row) * K;
  const int chunks = K / 8;

  float absmax = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    load8(src + c * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) absmax = fmaxf(absmax, fabsf(v[j]));
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, offset));
  const float scale = fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
  if (lane == 0) x_scale[row] = scale;

  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    load8(src + c * 8, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f),
                            127.f);
      packed[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           static_cast<int8_t>(static_cast<int>(q))))
                       << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(dst + c * 8) = make_uint2(packed[0], packed[1]);
  }
}

// 16-byte asynchronous copy to shared memory; with valid == false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a . b on the int8 tensor cores: a is 16 x 32 (row), b is 32 x 8
// (col), c is 16 x 8 int32 (PTX ISA fragment layouts for m16n8k32 .s8).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    w8a8_gemm(const int8_t* __restrict__ x_q, const int8_t* __restrict__ w_q,
              const float* __restrict__ x_scale,
              const float* __restrict__ w_scale,
              const float* __restrict__ bias, T* __restrict__ out, int M,
              int K, int N) {
  __shared__ __align__(16) int8_t smem_a[2][kBM * kStride];
  __shared__ __align__(16) int8_t smem_b[2][kBN * kStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = lane >> 2;  // fragment row (A, C) / column (B)
  const int quad = lane & 3;    // fragment k offset / 4 (A, B), column / 2 (C)
  const int warp_m = (warp >> 2) * kWarpM;
  const int warp_n = (warp & 3) * kWarpN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // a tile is 128 rows x 64 bytes = 512 16-byte chunks: two per thread, for
  // each of A and B
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kGemmThreads;
      const int row = chunk >> 2;
      const int col = (chunk & 3) * 16;
      const bool k_in = k0 + col < K;
      const bool a_in = k_in && m0 + row < M;
      const bool b_in = k_in && n0 + row < N;
      cp_async16(&smem_a[stage][row * kStride + col],
                 a_in ? x_q + static_cast<size_t>(m0 + row) * K + k0 + col
                      : x_q,
                 a_in);
      cp_async16(&smem_b[stage][row * kStride + col],
                 b_in ? w_q + static_cast<size_t>(n0 + row) * K + k0 + col
                      : w_q,
                 b_in);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int k_tiles = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) {
      load_stage(stage ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_tile = smem_a[stage];
    const int8_t* b_tile = smem_b[stage];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p =
            a_tile + (warp_m + mi * 16 + group) * kStride + kk + quad * 4;
        a[mi][0] = lds32(p);                     // row g,     k 0-15
        a[mi][1] = lds32(p + 8 * kStride);       // row g + 8, k 0-15
        a[mi][2] = lds32(p + 16);                // row g,     k 16-31
        a[mi][3] = lds32(p + 8 * kStride + 16);  // row g + 8, k 16-31
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p =
            b_tile + (warp_n + ni * 8 + group) * kStride + kk + quad * 4;
        b[ni][0] = lds32(p);       // column g, k 0-15
        b[ni][1] = lds32(p + 16);  // column g, k 16-31
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  // epilogue: thread holds rows group and group + 8 of each m16 tile, and
  // columns 2 * quad and 2 * quad + 1 of each n8 tile
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m + mi * 16 + group + half * 8;
      if (row >= M) continue;
      const float xs = x_scale[row];
      T* out_row = out + static_cast<size_t>(row) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n + ni * 8 + quad * 2;
        if (col >= N) continue;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col + j < N ? col + j : col;
          y[j] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]),
                                  xs),
                        w_scale[c]),
              bias[c]);
        }
        if (pairs) {
          store2(out_row + col, y[0], y[1]);
        } else {
          store1(out_row + col, y[0]);
          if (col + 1 < N) store1(out_row + col + 1, y[1]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_q, const void* w_scale,
                   const void* bias, void* out, void* x_q, void* x_scale,
                   int M, int K, int N, cudaStream_t stream) {
  quantize_rows<T><<<(M + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32,
                     0, stream>>>(static_cast<const T*>(x),
                                  static_cast<int8_t*>(x_q),
                                  static_cast<float*>(x_scale), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_gemm<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) fp32 or bf16 (bf16 != 0); w_q: (N, K) int8; w_scale, bias: (N,)
// fp32; out: (M, N) in x's dtype; x_q: (M, K) int8 and x_scale: (M,) fp32
// scratch. All contiguous and 16-byte aligned; M >= 1, N >= 1, K a positive
// multiple of 16. Returns the cudaError_t of the launches (0 on success);
// the kernels run asynchronously on `stream`.
extern "C" int marqo_w8a8_matmul(const void* x, const void* w_q,
                                 const void* w_scale, const void* bias,
                                 void* out, void* x_q, void* x_scale, int M,
                                 int K, int N, int bf16, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w_q, w_scale, bias, out, x_q, x_scale,
                                   M, K, N, s)
           : launch<float>(x, w_q, w_scale, bias, out, x_q, x_scale, M, K, N,
                           s);
  return static_cast<int>(err);
}
