// Tiled softmax attention shared by the package's attention kernels, for
// Hopper (sm_90a): masked_attention.cu (B1, compact-mask encoder attention)
// and fused_attention.cu (B2, flash attention with no mask or segment ids).
// Each kernel supplies a mask policy; this file holds two tile loops, the
// mma.sync loop for bf16 and the exact FMA loop for fp32, and the
// masked-tile rule that attention_tile_sm90.cuh's wgmma loop shares. bf16
// takes the mma.sync loop only at the short token counts where the card
// showed it faster than the wgmma loop (ops/flash_attention.py
// `tile_loop`: e.g. the video tower's 8 frames).
//
// One block owns one (batch, head, 64-row query tile) and walks 64-key K/V
// tiles with an online softmax (running max and sum per row in fp32), so
// shared memory is bounded by the tile size whatever S is and the (S, S)
// scores never reach device memory:
//   scores = q.k^T * scale with fp32 accumulation,
//   keys past the ragged edge of S get -inf (they drop out entirely),
//   in-range keys the policy disallows get the finite -1e9,
//   probs.v accumulates in fp32, and the output is in the input dtype.
// Every tile the loop visits holds at least one in-range key, so the running
// max is always finite and no row divides by zero. A row whose keys are all
// disallowed comes out as the uniform mean of V over all S keys, never NaN.
//
// Layout. q, k, v and out are (B, N, S, D) tensors given by element strides
// for the batch, head and token axes; the last axis has stride 1, the other
// strides are multiples of 8 elements and the pointers are 16-byte aligned.
// So the kernels read the projections' (B, S, N, D) output (and Stella's
// chunks of one fused qkv projection) and write the output in whatever
// layout the wrapper allocated, with no head-layout copy on either side.
//
// Head dims. Instances are templated on the head dim padded to a multiple of
// 16 (DP = 16, 32, ..., 128); the real D (a multiple of 8) comes at run
// time. Columns D..DP-1 are zero-filled in shared memory, which changes no
// score, and only the D real output columns are stored.
//
// bf16 instances: tensor cores (the served dtype). A block is 4 warps of 16
// query rows. Q is copied once to shared memory, then held in registers as
// mma A-fragments (ldmatrix). K and V tiles stream through a double-buffered
// cp.async ring in bf16, 16-byte copies: the next tile loads while the
// current one computes. Shared rows are padded from DP to DP + 8 bf16 (an
// odd multiple of 16 bytes), so the eight rows an ldmatrix reads fall in
// eight different bank groups. S = Q.K^T runs mma.sync m16n8k16 bf16 with
// fp32 accumulators; scale and mask are applied in registers from the key
// ids staged in shared memory with each tile; the online softmax reduces
// across the quad of lanes sharing a row. P is rounded to bf16 in registers
// (where the plain twin rounds its probs to v's dtype) and reused in the
// accumulators' fragment layout as the A operand of O += P.V, with V read
// by ldmatrix.trans. O stays fp32 in registers until the epilogue, which
// stages the bf16 rows through the warp's own rows of the Q tile and writes
// them out in 16-byte stores. Work is sized to S: a warp whose 16 rows all
// lie past S skips the math (it still helps with the block's copies and
// barriers), and the last key tile computes only the 8-key fragments that
// reach into S; a key tile wholly inside S takes a copy of the tile code
// with no run-time guards, which the compiler schedules freely (5-11%
// faster at the encoders' (256, 12, 128, 64) in chip_smoke.py's timing on
// an H100, for twice the code of each bf16 instance). At DP <= 64 the
// launch bounds hold the loop to 128 registers, so four blocks (16 warps)
// share an SM.
//
// fp32 instances: the fp32 FMA loop from shared memory (16 x 16 threads,
// rows ty + 16i, columns tx + 16j). They are the exact check of the tile
// loop against the plain twin (atol 1e-5), not a served dtype, and an fp32
// input must never reach the bf16 tensor cores, which would silently change
// the fp32 contract.
//
// Masked-tile skipping (both loops). The block walks only the key tiles
// some (query, key) pair of the block may attend to; a skipped tile changes
// nothing, bit for bit. A tile is skipped only when every score in it would
// be the finite -1e9 for every row of the block, and every such row has a
// real score in some tile it visits. Then, in fp32: after a real running max
// m, exp(-1e9 - m) underflows to exactly 0 and the rescale alpha = exp(0) is
// exactly 1, so the tile adds 0 and rescales by 1; and a masked tile that
// came first (running max -1e9) is wiped out when the first real score
// arrives, because alpha = exp(-1e9 - m) = 0 there, which is where skipping
// starts from too (running max -inf, sums 0). The policy's rule:
//   kPadding (B1): skip a tile with no key > 0, unless the batch row has
//     no real key at all (an all-pad row visits every tile, for its uniform
//     mean of V over all S);
//   kSegmentPositive (B1): skip a tile none of whose key ids (> 0) lies in
//     [min, max] of the block's query ids; a block holding a pad query (id
//     <= 0) visits every tile, for that row's uniform mean. Ids need not be
//     monotone: the test is per key, against the range;
//   kSegment (B2): skip a tile none of whose key ids lies in [min, max] of
//     the block's query ids (id 0 is a segment; every query sees its own
//     key, so no row is ever fully masked);
//   kNone (B2 no mask): only the ragged edge.
// One warp reads the (B, S) id row once and sets a visit bit per key tile
// in shared memory while the block's first copies are in flight; key tile
// 0 is fetched before the bits are known (a block that skips it loads it
// and computes nothing), so the rule adds no latency ahead of the first
// copy.
//
// Shared memory: bf16, 5 x 64 x (DP + 8) bf16 (Q, two K and two V stages)
// plus 2 x 64 key ids and 64 words of visit bits: 46 KB at DP = 64, 86 KB
// at DP = 128. fp32, (2 (DP + 1) + DP + 65) x 64 floats plus 64 ints and
// the bits: 68 KB at DP = 64. Above 48 KB the launch opts in to dynamic
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace marqo_attention {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per inner tile
constexpr float kMaskedScore = -1e9f;
constexpr unsigned kFullMask = 0xffffffffu;

// fp32: 16 x 16 threads; bf16: 4 warps of 16 query rows
template <typename T>
constexpr int kThreads = std::is_same<T, float>::value ? 256 : 128;
// bf16 at DP <= 64: four blocks per SM (see the note above)
template <typename T, int DP>
constexpr int kMinBlocks = std::is_same<T, float>::value || DP > 64 ? 1 : 4;

// Element strides of one (B, N, S, D) operand.
struct Strides {
  long long batch, head, token;
};

struct Operands {
  Strides q, k, v, out;
};

// Which key tiles a mask policy lets the block skip (see the note above).
enum class Skip { kNone, kPadding, kSegmentPositive, kSegment };

// A mask policy has
//   static constexpr bool kUsesIds;  // whether the (B, S) int32 row is read
//   static constexpr Skip kSkip;
//   static __device__ bool allowed(int query_id, int key_id);
// When kUsesIds is false the ids pointer is never read and may be null.

// The block's visit bits: one per key tile, for the first kFlagWords * 32
// tiles (131,072 keys); tiles past them are always visited.
constexpr int kFlagWords = 64;

// Fill `bits` with the key tiles the block of query rows q0 .. q0 + rows - 1
// must visit. Called by one whole warp; the caller makes the bits visible
// with a barrier.
template <typename Mask>
__device__ void mark_tiles(const int* ids, int q0, int rows, int seq_len,
                           unsigned* bits, int lane) {
  const int n_tiles = (seq_len + kBlockK - 1) / kBlockK;
  const int words = min((n_tiles + 31) / 32, kFlagWords);
  bool all = false;
  int lo = 0, hi = 0;
  if constexpr (Mask::kSkip != Skip::kPadding) {
    // the block's query ids: a pad query (B1) visits every tile
    constexpr bool positive = Mask::kSkip == Skip::kSegmentPositive;
    const int q_end = min(q0 + rows, seq_len);
    bool pad = false;
    int l = INT_MAX, h = INT_MIN;
    for (int i = q0 + lane; i < q_end; i += 32) {
      const int id = ids[i];
      if (positive && id <= 0) {
        pad = true;
      } else {
        l = min(l, id);
        h = max(h, id);
      }
    }
    all = __any_sync(kFullMask, pad);
    lo = __reduce_min_sync(kFullMask, l);
    hi = __reduce_max_sync(kFullMask, h);
  }
  unsigned any_tile = 0;
  for (int w = 0; w < words; ++w) {
    unsigned word = ~0u;
    if (!all) {
      word = 0;
      const int tiles = min(32, n_tiles - 32 * w);
#pragma unroll 4
      for (int i = 0; i < tiles; ++i) {
        const int k0 = (32 * w + i) * kBlockK;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < kBlockK; j += 32) {
          if (k0 + j + lane < seq_len) {
            const int id = ids[k0 + j + lane];
            if constexpr (Mask::kSkip == Skip::kPadding)
              hit |= id > 0;
            else if constexpr (Mask::kSkip == Skip::kSegmentPositive)
              hit |= id > 0 && id >= lo && id <= hi;
            else
              hit |= id >= lo && id <= hi;
          }
        }
        if (__any_sync(kFullMask, hit)) word |= 1u << i;
      }
    }
    any_tile |= word;
    if (lane == 0) bits[w] = word;
  }
  // an all-pad row (padding) visits every tile, for its uniform mean of V
  if (Mask::kSkip == Skip::kPadding && any_tile == 0 && lane == 0)
    for (int w = 0; w < words; ++w) bits[w] = ~0u;
}

template <typename Mask>
__device__ __forceinline__ bool visited(const unsigned* bits, int t) {
  if constexpr (Mask::kSkip == Skip::kNone) return true;
  return t >= kFlagWords * 32 || ((bits[t / 32] >> (t % 32)) & 1u);
}

// The first tile at or after t that the block visits (n_tiles: none).
template <typename Mask>
__device__ __forceinline__ int next_tile(const unsigned* bits, int t,
                                         int n_tiles) {
  while (t < n_tiles && !visited<Mask>(bits, t)) ++t;
  return t;
}

// --- PTX helpers -------------------------------------------------------------

// 16-byte asynchronous copy to shared memory; with valid == false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a . b on the bf16 tensor cores: a is 16 x 16 (row), b is 16 x 8
// (col), c is 16 x 8 fp32 (PTX ISA fragment layouts for m16n8k16).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- bf16: tensor cores ------------------------------------------------------

template <int DP>
struct MmaLayout {
  static constexpr int kRow = DP + 8;           // bf16 per shared row
  static constexpr int kTile = kBlockK * kRow;  // bf16 per 64-row tile
  // Q (then the output), two K stages, two V stages; two stages of key
  // ids; the visit bits
  static constexpr size_t kBytes = 5 * kTile * sizeof(__nv_bfloat16) +
                                   2 * kBlockK * sizeof(int) +
                                   kFlagWords * sizeof(unsigned);
};

// Copy 64 rows (row0...) of one strided operand into a shared tile: rows
// past S and columns past D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long token_stride, int row0,
                                          int seq_len, int head_dim,
                                          int tid) {
  constexpr int kChunks = DP / 8;
#pragma unroll 4
  for (int c = tid; c < kBlockK * kChunks; c += kThreads<__nv_bfloat16>) {
    const int r = c / kChunks, col = (c % kChunks) * 8, row = row0 + r;
    const bool valid = row < seq_len && col < head_dim;
    cp_async16(dst + r * MmaLayout<DP>::kRow + col,
               valid ? src + row * token_stride + col : src, valid);
  }
}

template <int DP, typename Mask>
__device__ __forceinline__ void mma_tile_loop(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ ids,
    __nv_bfloat16* __restrict__ out, const Operands& st, int seq_len,
    int head_dim, float scale, unsigned char* smem) {
  using L = MmaLayout<DP>;
  using bf16 = __nv_bfloat16;
  constexpr int kSteps = DP / 16;  // k-steps of Q.K^T, d-pairs of P.V
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + L::kTile;
  bf16* vs = ks + 2 * L::kTile;
  int* key_ids = reinterpret_cast<int*>(vs + 2 * L::kTile);
  unsigned* bits = reinterpret_cast<unsigned*>(key_ids + 2 * kBlockK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, quad = lane % 4;
  const int q0 = blockIdx.x * kBlockQ;
  const long long b = blockIdx.z, h = blockIdx.y;
  const bf16* qh = q + b * st.q.batch + h * st.q.head;
  const bf16* kh = k + b * st.k.batch + h * st.k.head;
  const bf16* vh = v + b * st.v.batch + h * st.v.head;
  bf16* oh = out + b * st.out.batch + h * st.out.head;
  const int* id_row = Mask::kUsesIds ? ids + b * seq_len : nullptr;
  const int n_tiles = (seq_len + kBlockK - 1) / kBlockK;

  auto load_kv = [&](int stage, int t) {
    const int k0 = t * kBlockK;
    load_tile<DP>(ks + stage * L::kTile, kh, st.k.token, k0, seq_len,
                  head_dim, tid);
    load_tile<DP>(vs + stage * L::kTile, vh, st.v.token, k0, seq_len,
                  head_dim, tid);
    if (Mask::kUsesIds && tid < kBlockK) {
      const bool valid = k0 + tid < seq_len;
      cp_async4(key_ids + stage * kBlockK + tid,
                valid ? id_row + k0 + tid : id_row, valid);
    }
    cp_async_commit();
  };
  // Q, and key tile 0 before the visit bits are known: nearly every block
  // visits it, and one it skips is loaded but not computed
  load_tile<DP>(qs, qh, st.q.token, q0, seq_len, head_dim, tid);
  cp_async_commit();
  load_kv(0, 0);
  if (Mask::kSkip != Skip::kNone && warp == 0)
    mark_tiles<Mask>(id_row, q0, kBlockQ, seq_len, bits, lane);
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();     // ... for every thread, and so have the visit bits

  uint32_t qf[kSteps][4];
#pragma unroll
  for (int step = 0; step < kSteps; ++step)
    ldmatrix_x4(qf[step], qs + (warp * 16 + lane % 16) * L::kRow +
                              step * 16 + (lane / 16) * 8);

  // a warp whose 16 rows all lie past S does no math
  const bool active = q0 + warp * 16 < seq_len;
  int row_id[2];
  float row_max[2], row_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + group + 8 * r;
    row_id[r] = (Mask::kUsesIds && row < seq_len) ? id_row[row] : 0;
    row_max[r] = -INFINITY;
    row_sum[r] = 0.f;
  }
  float o[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[d][j] = 0.f;

  int stage = 0;
  for (int t = 0; t < n_tiles;) {
    const int next = next_tile<Mask>(bits, t + 1, n_tiles);
    if (next < n_tiles) {
      load_kv(stage ^ 1, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // one key tile; kFull: every key of the tile lies inside S
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int k0 = t * kBlockK;
      const bf16* kt = ks + stage * L::kTile;
      const bf16* vt = vs + stage * L::kTile;
      const int* kid = key_ids + stage * kBlockK;
      // the 8-key fragments that reach into S: all of them in a full tile,
      // whose code has no run-time guards
      const int frags = kFull ? kBlockK / 8
                              : min(kBlockK / 8, (seq_len - k0 + 7) / 8);

      float s[kBlockK / 8][4];
#pragma unroll
      for (int f = 0; f < kBlockK / 8; ++f)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[f][j] = 0.f;
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
#pragma unroll
        for (int pair = 0; pair < kBlockK / 16; ++pair) {
          if (kFull || 2 * pair < frags) {
            // keys pair*16 + 0-7 and + 8-15, d step*16 + 0-7 and + 8-15
            uint32_t kf[4];
            ldmatrix_x4(kf, kt + (pair * 16 + (lane / 16) * 8 + lane % 8) *
                                     L::kRow +
                                 step * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(s[2 * pair], qf[step], kf[0], kf[1]);
            if (kFull || 2 * pair + 1 < frags)
              mma_bf16(s[2 * pair + 1], qf[step], kf[2], kf[3]);
          }
        }
      }

      // thread holds rows group (j = 0, 1) and group + 8 (j = 2, 3), keys
      // f * 8 + quad * 2 + (j & 1)
      if (!Mask::kUsesIds && kFull) {
#pragma unroll
        for (int f = 0; f < kBlockK / 8; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[f][j] *= scale;
      } else {
#pragma unroll
        for (int f = 0; f < kBlockK / 8; ++f) {
          const int col = f * 8 + quad * 2;
          const int2 key_id = Mask::kUsesIds
                                  ? *reinterpret_cast<const int2*>(kid + col)
                                  : make_int2(0, 0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[f][j] = !kFull && k0 + col + (j & 1) >= seq_len ? -INFINITY
                      : Mask::allowed(row_id[j >> 1],
                                      j & 1 ? key_id.y : key_id.x)
                          ? s[f][j] * scale
                          : kMaskedScore;
          }
        }
      }

      // online softmax; the four lanes of a quad share a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int f = 0; f < kBlockK / 8; ++f)
          tile_max = fmaxf(tile_max, fmaxf(s[f][2 * r], s[f][2 * r + 1]));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFullMask, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFullMask, tile_max, 2));
        const float new_max = fmaxf(row_max[r], tile_max);
        const float alpha = expf(row_max[r] - new_max);
        float tile_sum = 0.f;
#pragma unroll
        for (int f = 0; f < kBlockK / 8; ++f) {
#pragma unroll
          for (int j = 2 * r; j < 2 * r + 2; ++j) {
            s[f][j] = expf(s[f][j] - new_max);
            tile_sum += s[f][j];
          }
        }
        tile_sum += __shfl_xor_sync(kFullMask, tile_sum, 1);
        tile_sum += __shfl_xor_sync(kFullMask, tile_sum, 2);
        row_sum[r] = row_sum[r] * alpha + tile_sum;
        row_max[r] = new_max;
#pragma unroll
        for (int d = 0; d < DP / 8; ++d) {
          o[d][2 * r] *= alpha;
          o[d][2 * r + 1] *= alpha;
        }
      }

      // O += P.V: P (bf16) in the score accumulators' layout is the A
      // fragment of 16 keys; V's rows are keys, read transposed
#pragma unroll
      for (int pair = 0; pair < kBlockK / 16; ++pair) {
        if (kFull || 2 * pair < frags) {
          const uint32_t pf[4] = {
              pack_bf16(s[2 * pair][0], s[2 * pair][1]),
              pack_bf16(s[2 * pair][2], s[2 * pair][3]),
              pack_bf16(s[2 * pair + 1][0], s[2 * pair + 1][1]),
              pack_bf16(s[2 * pair + 1][2], s[2 * pair + 1][3])};
#pragma unroll
          for (int dp = 0; dp < kSteps; ++dp) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vt + (pair * 16 + lane % 16) * L::kRow +
                                      dp * 16 + (lane / 16) * 8);
            mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
            mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
          }
        }
      }
    };
    if (active && visited<Mask>(bits, t)) {
      if (t * kBlockK + kBlockK <= seq_len)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
    t = next;
    stage ^= 1;
  }

  if (!active) return;
  // the output goes through the warp's own 16 rows of the Q tile (which
  // only this warp read), then out in 16-byte stores
  bf16* staged = qs + warp * 16 * L::kRow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / row_sum[r];
#pragma unroll
    for (int d = 0; d < DP / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(
          staged + (group + 8 * r) * L::kRow + d * 8 + quad * 2) =
          __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < seq_len && col < head_dim)
      *reinterpret_cast<uint4*>(oh + row * st.out.token + col) =
          *reinterpret_cast<const uint4*>(staged + r * L::kRow + col);
  }
}

// --- fp32: the exact FMA loop ------------------------------------------------

template <int DP>
struct FmaLayout {
  // +1 pads break shared-memory bank conflicts on column-wise reads (DP is a
  // multiple of 16, so DP + 1 is odd)
  static constexpr int kQStride = DP + 1;
  static constexpr int kKStride = DP + 1;
  static constexpr int kVStride = DP;
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kFloats = kBlockQ * kQStride + kBlockK * kKStride +
                                 kBlockK * kVStride + kBlockQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) +
                                   kBlockK * sizeof(int) +
                                   kFlagWords * sizeof(unsigned);
};

template <int DP, typename Mask>
__device__ __forceinline__ void fma_tile_loop(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ ids,
    float* __restrict__ out, const Operands& st, int seq_len, int head_dim,
    float scale, unsigned char* smem_raw) {
  using L = FmaLayout<DP>;
  constexpr int kCols = DP / 16;  // output columns per thread
  constexpr int kThreadsF = kThreads<float>;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockQ * L::kQStride;
  float* vs = ks + kBlockK * L::kKStride;
  float* ps = vs + kBlockK * L::kVStride;
  int* key_ids = reinterpret_cast<int*>(ps + kBlockQ * L::kPStride);
  unsigned* bits = reinterpret_cast<unsigned*>(key_ids + kBlockK);

  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long b = blockIdx.z, h = blockIdx.y;
  const float* qh = q + b * st.q.batch + h * st.q.head;
  const float* kh = k + b * st.k.batch + h * st.k.head;
  const float* vh = v + b * st.v.batch + h * st.v.head;
  float* oh = out + b * st.out.batch + h * st.out.head;
  const int* id_row = Mask::kUsesIds ? ids + b * seq_len : nullptr;

  for (int e = tid; e < kBlockQ * DP; e += kThreadsF) {
    const int r = e / DP, c = e % DP, row = q0 + r;
    qs[r * L::kQStride + c] =
        row < seq_len && c < head_dim ? qh[row * st.q.token + c] : 0.f;
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

  if (Mask::kSkip != Skip::kNone && tid < 32)
    mark_tiles<Mask>(id_row, q0, kBlockQ, seq_len, bits, tid);
  __syncthreads();
  const int n_tiles = (seq_len + kBlockK - 1) / kBlockK;
  for (int t = next_tile<Mask>(bits, 0, n_tiles); t < n_tiles;
       t = next_tile<Mask>(bits, t + 1, n_tiles)) {
    const int k0 = t * kBlockK;
    for (int e = tid; e < kBlockK * DP; e += kThreadsF) {
      const int r = e / DP, c = e % DP, row = k0 + r;
      const bool in = row < seq_len && c < head_dim;
      ks[r * L::kKStride + c] = in ? kh[row * st.k.token + c] : 0.f;
      vs[r * L::kVStride + c] = in ? vh[row * st.v.token + c] : 0.f;
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
    for (int d = 0; d < DP; ++d) {
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
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFullMask, tile_max, off));
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
        tile_sum += __shfl_xor_sync(kFullMask, tile_sum, off);
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
        const float vv = vs[kk * L::kVStride + tx + 16 * j];
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
      if (c < head_dim) oh[row * st.out.token + c] = acc[i][j] * inv;
    }
  }
}

// --- the kernel and its launch ------------------------------------------------

template <typename T, int DP, typename Mask>
__global__ void __launch_bounds__(kThreads<T>, kMinBlocks<T, DP>)
attention_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ ids,
                      T* __restrict__ out, Operands strides, int seq_len,
                      int head_dim, float scale) {
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "padded head dim");
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, float>::value)
    fma_tile_loop<DP, Mask>(q, k, v, ids, out, strides, seq_len, head_dim,
                            scale, smem);
  else
    mma_tile_loop<DP, Mask>(q, k, v, ids, out, strides, seq_len, head_dim,
                            scale, smem);
}

// Launch one (dtype, padded head dim, mask) instance on `stream`; returns the
// cudaError_t of the launch (the kernel runs asynchronously).
template <typename T, int DP, typename Mask>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* ids, void* out,
                             const Operands& strides, int batch, int heads,
                             int seq_len, int head_dim, float scale,
                             cudaStream_t stream) {
  auto kernel = attention_tile_kernel<T, DP, Mask>;
  const size_t smem = std::is_same<T, float>::value ? FmaLayout<DP>::kBytes
                                                    : MmaLayout<DP>::kBytes;
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
  kernel<<<grid, kThreads<T>, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(ids),
      static_cast<T*>(out), strides, seq_len, head_dim, scale);
  return cudaGetLastError();
}

// The C entry points' strides: an array of 12 element strides, batch, head
// and token of q, k, v and out in that order.
inline Operands make_operands(const long long* s) {
  return Operands{{s[0], s[1], s[2]},
                  {s[3], s[4], s[5]},
                  {s[6], s[7], s[8]},
                  {s[9], s[10], s[11]}};
}

}  // namespace marqo_attention
