// The bf16 tile loop of the package's attention kernels on Hopper's
// warpgroup MMA (wgmma) and tensor memory accelerator (TMA), for sm_90a:
// masked_attention.cu (B1) and fused_attention.cu (B2) launch it for bf16
// where the wrapper's dispatch rule (ops/flash_attention.py `tile_loop`)
// picks "wgmma"; attention_tile.cuh keeps the mma.sync loop (the other
// bf16 shapes) and the exact fp32 FMA loop.
//
// It computes what attention_tile.cuh computes, under the same contract:
// scale 1/sqrt(D) inside, fp32 scores, online softmax and P.V accumulation,
// P rounded to bf16 before P.V (where the plain twin rounds its probs to
// v's dtype), -1e9 for in-range keys the policy disallows and -inf past the
// ragged edge of S, the uniform mean of V for a row with no allowed key,
// strided (B, N, S, D) views in and a (B, N, S, D) view out, every head dim
// a multiple of 8 up to 128, the four mask policies, and the same
// masked-tile skipping rule (attention_tile.cuh, "Masked-tile skipping"),
// which changes no result bit for bit.
//
// What bounds the work on this card. At the ViT towers' shapes (bf16, D =
// 64) the bytes bound is 0.010 ms at (16, 16, 257, 64) and 0.023 ms at
// (16, 16, 577, 64), the tensor-core bound 0.004 and 0.022 ms (989
// TFLOP/s); so what holds the kernel back is its work on chip. The mma.sync
// loop (attention_tile.cuh) gives each warp 16 query rows and makes every
// warp read the whole 64 x 64 K and V tiles through ldmatrix: 16 KB of
// shared memory per 16 rows and tile, about 128 cycles of an SM's 128 bytes
// a cycle, against some 64 cycles of mma.sync for the same tile, so it runs
// at about half the tensor rate before the softmax and its block barriers.
//
// Design (a block = c consumer warpgroups + one producer warp):
//   - Q tile: 64 c query rows of one (batch, head); c = 2 (128 rows), or
//     c = 1 where S <= 64 or 128-row tiles would leave SMs idle (the host
//     picks, launch_attention_sm90). A wgmma warpgroup reads its B operand
//     (K, then V) from shared memory once for 64 rows: 4x fewer shared
//     bytes a row than the mma.sync loop's warps.
//   - Producer warp: one lane issues the TMA loads of the
//     Q boxes once, then of 64-key K and V tiles into a ring of stages in
//     dynamic shared memory, one full/empty mbarrier pair a stage; the
//     warp stages the tile's 64 key ids (masked modes) beside it and marks
//     the tiles the block visits. Producer and consumers walk the same
//     tile sequence: tile 0 (loaded before the visit bits are known), then
//     every visited tile after it. No block-wide barrier in the loop.
//   - Consumers, per tile: S = Q.K^T by wgmma m64n64k16,
//     Q and K from shared memory (SS); scale, mask from the staged ids and
//     the online softmax in registers, each row's max reduced over the 4
//     lanes that share it in the accumulator layout (the sum stays per lane
//     until the epilogue); P rounded to bf16 in registers is the A operand
//     of O += P.V (the RS form: the accumulator layout of a k16 column pair
//     is the A fragment's), V read from shared memory as an MN-major B.
//     Where one block an SM leaves registers to spare (D > 64, no mask)
//     the P.V group stays in flight under the next tile's Q.K^T and its
//     stage is released when the next wait retires it; elsewhere P.V is
//     retired at once: with P's 16 registers live across the next Q.K^T,
//     ptxas serialized the wgmmas for want of registers at D <= 64 (its
//     C7512 note) and spilled the masked instances
//     (scripts/ptxas_report.sh).
//   - TMA maps (encoded on the host per call, cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint, hopper.cuh, as B3 does; no -lcuda):
//     dims (D, S, N, B) innermost first with the views' strides, boxes of
//     64 columns x 64 rows with the 128-byte swizzle. Rows past S and
//     columns past D load as zeros (the -inf of the ragged edge masks the
//     first), so any D and S take the same boxes; D > 64 takes two 64-column
//     panels (a 128-byte swizzle row is 64 bf16), and Q.K^T walks D in k16
//     steps across them. The epilogue stages O, normalised and rounded to
//     bf16, in the warpgroup's own Q boxes (swizzled as TMA stores them) and
//     writes it by TMA store, which drops rows past S and columns past D.
//   - Registers: no setmaxnreg. At D <= 64 two blocks of 9 warps share an
//     SM, so one sub-partition holds 5 warps and a thread at most 96
//     registers; above, one block an SM. A block holds at launch only the
//     registers ptxas assigned it, so a consumer's setmaxnreg.inc past
//     them waits forever (it did, on the card).
// Not here: FA3's ping-pong of two warpgroups' softmax against each
// other's GEMMs, intra-warpgroup overlap of softmax and GEMM, clusters and
// TMA multicast.
//
// Shared memory: Q, 2 x panels boxes of 8 KB; a ring of stages, each K and
// V at panels x 8 KB; 64 key ids a stage, the visit bits and the barriers:
// 66 KB at D <= 64 (3 stages, two blocks an SM), 162 KB above (4 stages,
// one block an SM).

#pragma once

#include <cuda.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace marqo_attention {

using marqo_hopper::bulk_commit;
using marqo_hopper::bulk_wait_read;
using marqo_hopper::desc_k_major;
using marqo_hopper::encode_tiled;
using marqo_hopper::EncodeTiled;
using marqo_hopper::fence_operands;
using marqo_hopper::fence_proxy_async;
using marqo_hopper::mbar_arrive;
using marqo_hopper::mbar_expect_tx;
using marqo_hopper::mbar_init;
using marqo_hopper::mbar_wait;
using marqo_hopper::named_barrier;
using marqo_hopper::smem_addr;
using marqo_hopper::wgmma_commit;
using marqo_hopper::wgmma_fence;
using marqo_hopper::wgmma_wait;

constexpr int kSm90Box = 64 * 128;  // bytes of a 64-row x 64-column box
constexpr int kSm90MaxConsumers = 2;
constexpr int kSm90Threads = 128 * kSm90MaxConsumers + 32;

template <int DP>
struct Sm90Layout {
  static constexpr int kPanels = (DP + 63) / 64;
  // the widths (columns) of the first and the last 64-column panel of O
  static constexpr int kWidth0 = kPanels == 1 ? DP : 64;
  static constexpr int kWidth1 = kPanels == 1 ? 16 : DP - 64;
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kStages = DP <= 64 ? 3 : 4;
  static constexpr int kQBytes = kSm90MaxConsumers * kPanels * kSm90Box;
  static constexpr int kTileBytes = kPanels * kSm90Box;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // 1 KB of slack aligns the tiles to the 128-byte swizzle's 1 KB atom
  static constexpr size_t kBytes =
      1024 + kQBytes + kStages * kStageBytes +
      kStages * kBlockK * sizeof(int) + kFlagWords * sizeof(unsigned) +
      (2 + 2 * kStages) * sizeof(uint64_t);
};

// --- PTX: mbarriers, TMA, wgmma ---------------------------------------------

// the box of `map` at (column, token, head, batch) into shared memory; the
// copy completes its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int token, int head,
                                         int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(token), "r"(head), "r"(batch)
      : "memory");
}

// a box from shared memory to `map` at (column, token, head, batch), in the
// calling thread's bulk group; TMA drops what lies past the map's edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int token,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(token), "r"(head), "r"(batch)
      : "memory");
}

// wgmma's descriptor of V: an MN-major tile (the output columns are
// contiguous, the keys are the k dimension) of 128-byte rows under the
// 128-byte swizzle, 8-key groups 1024 bytes apart (the stride byte offset),
// so a k16 step is 2048 bytes. Its leading byte offset (the next 64-column
// atom) is never used, since each P.V product covers one panel: it is set
// to the same 1024 bytes. Q and K are K-major (desc_k_major), a k16 step
// 32 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// P's A fragments are live under the wgmma that reads them
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 64, fp32) (+)= Q (64 x 16) . K (64 x 16)^T, both from shared
// memory; scale_d 0 overwrites. The accumulator fragment: d[4 i + 2 h + j]
// is row 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + j.
template <int N>
struct WgmmaSS;

// O (64 x N, fp32) += P (64 x 16, bf16 registers) . V (16 x N) from shared
// memory, V MN-major. The A fragment of a k16 step holds P's columns
// 2 (lane % 4) + {0, 1} and 8 + 2 (lane % 4) + {0, 1} of rows lane / 4 and
// lane / 4 + 8 of the warp's 16: the accumulator layout of the two
// 8-column groups of S that cover those 16 keys.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<48> {
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


// --- the block's shared memory ----------------------------------------------

template <int DP>
struct Sm90Smem {
  uint8_t* q;         // Q boxes, [panel][consumer]; then the staged output
  uint8_t* ring;      // [stage]: K's panels, then V's
  int* key_ids;       // [stage][kBlockK]
  unsigned* bits;     // the visit bits
  uint64_t* q_full;   // Q has landed
  uint64_t* bits_ready;
  uint64_t* full;     // [stage]: K, V and the key ids have landed
  uint64_t* empty;    // [stage]: every consumer warp is done with it

  __device__ explicit Sm90Smem(uint8_t* raw) {
    using L = Sm90Layout<DP>;
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = q + L::kQBytes;
    key_ids = reinterpret_cast<int*>(ring + L::kStages * L::kStageBytes);
    bits = reinterpret_cast<unsigned*>(key_ids + L::kStages * kBlockK);
    q_full = reinterpret_cast<uint64_t*>(bits + kFlagWords);
    bits_ready = q_full + 1;
    full = q_full + 2;
    empty = full + L::kStages;
  }
  __device__ uint8_t* q_box(int panel, int consumer) const {
    return q + (panel * kSm90MaxConsumers + consumer) * kSm90Box;
  }
  __device__ uint8_t* k_tile(int stage) const {
    return ring + stage * Sm90Layout<DP>::kStageBytes;
  }
  __device__ uint8_t* v_tile(int stage) const {
    return k_tile(stage) + Sm90Layout<DP>::kTileBytes;
  }
};

// The block's coordinates: query rows q0 .. q0 + 64 c - 1 of (batch, head);
// `active` consumers hold a row inside S.
struct Sm90Block {
  int q0, head, batch, seq_len, consumers, active, n_tiles;
};

// --- the producer warp ------------------------------------------------------

template <int DP, typename Mask>
__device__ __forceinline__ void sm90_produce(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const int* __restrict__ id_row,
    const Sm90Smem<DP>& sm, const Sm90Block& blk) {
  using L = Sm90Layout<DP>;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(sm.q_full, blk.active * L::kPanels * kSm90Box);
    for (int c = 0; c < blk.active; ++c)
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sm.q_box(p, c), map_q, 64 * p, blk.q0 + 64 * c, blk.head,
                 blk.batch, sm.q_full);
  }
  int stage = 0;
  uint32_t phase = 0;
  // K and V of key tile t, and its ids: lane 0 arms the barrier with the
  // bytes and issues the copies; every lane writes two ids, then arrives
  auto issue = [&](int t) {
    mbar_wait(&sm.empty[stage], phase ^ 1);
    const int k0 = t * kBlockK;
    if (lane == 0) {
      mbar_expect_tx(&sm.full[stage], L::kStageBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(sm.k_tile(stage) + p * kSm90Box, map_k, 64 * p, k0,
                 blk.head, blk.batch, &sm.full[stage]);
        tma_load(sm.v_tile(stage) + p * kSm90Box, map_v, 64 * p, k0,
                 blk.head, blk.batch, &sm.full[stage]);
      }
    }
    if constexpr (Mask::kUsesIds) {
      int* kid = sm.key_ids + stage * kBlockK;
#pragma unroll
      for (int j = lane; j < kBlockK; j += 32)
        kid[j] = k0 + j < blk.seq_len ? __ldg(id_row + k0 + j) : 0;
    }
    mbar_arrive(&sm.full[stage]);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  // tile 0 goes out before the visit bits are known
  issue(0);
  if constexpr (Mask::kSkip != Skip::kNone) {
    mark_tiles<Mask>(id_row, blk.q0, 64 * blk.consumers, blk.seq_len,
                     sm.bits, lane);
    __syncwarp();
    mbar_arrive(sm.bits_ready);
  }
  for (int t = next_tile<Mask>(sm.bits, 1, blk.n_tiles); t < blk.n_tiles;
       t = next_tile<Mask>(sm.bits, t + 1, blk.n_tiles))
    issue(t);
}

// One panel of a warpgroup's output (N columns of its 64 rows), each row
// divided by its sum, in bf16 into the 64 x 128-byte box `box`, swizzled as
// the TMA store reads it: 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int N>
__device__ __forceinline__ void stage_out(uint8_t* box, const float (&o)[N],
                                          const float (&inv)[2], int warp,
                                          int group, int quad) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + group + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          box + r * 128 + ((i ^ (r % 8)) << 4) + quad * 4) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] * inv[h],
                                o[4 * i + 2 * h + 1] * inv[h]);
    }
  }
}

// --- a consumer warpgroup ---------------------------------------------------

template <int DP, typename Mask>
__device__ __forceinline__ void sm90_consume(
    const CUtensorMap* map_out, const int* __restrict__ id_row,
    const Sm90Smem<DP>& sm, const Sm90Block& blk, int wg, float scale_log2) {
  using L = Sm90Layout<DP>;
  constexpr int kSteps = DP / 16;  // k16 steps of Q.K^T
  const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
  const int group = lane / 4, quad = lane % 4;
  const int seq_len = blk.seq_len;

  int row_id[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = blk.q0 + 64 * wg + 16 * warp + group + 8 * h;
    row_id[h] = Mask::kUsesIds && row < seq_len ? __ldg(id_row + row) : 0;
  }
  // running max (in units of scale_log2 * score) and per-lane partial sums
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  float o0[L::kWidth0 / 2], o1[L::kWidth1 / 2];
#pragma unroll
  for (int i = 0; i < L::kWidth0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::kWidth1 / 2; ++i) o1[i] = 0.f;
  float s[kBlockK / 2];
  uint32_t pf[kBlockK / 16][4];
  // P.V stays in flight under the next tile's Q.K^T only where one block an
  // SM leaves the registers to hold P meanwhile (D > 64, no mask)
  constexpr bool kOverlapPV = !Mask::kUsesIds && L::kMinBlocks == 1;
  // the output's accumulators (o1 only where D > 64)
  auto fence_o = [&] {
    fence_operands(o0);
    if constexpr (L::kPanels > 1) fence_operands(o1);
  };

  const uint32_t q_addr = smem_addr(sm.q_box(0, wg));
  mbar_wait(sm.q_full, 0);
  if constexpr (Mask::kSkip != Skip::kNone) mbar_wait(sm.bits_ready, 0);

  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  };

  // the online softmax of one tile's scores, in place: s becomes P
  // (unrounded); kFull: every key of the tile lies inside S
  auto softmax = [&](auto full, int k0, const int* kid) {
    constexpr bool kFull = decltype(full)::value;
    float new_max[2];
    if constexpr (!Mask::kUsesIds && kFull) {
      // no mask: the scale folds into the exponent
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBlockK / 8; ++i)
          m = fmaxf(m, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 1));
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 2));
        new_max[h] = fmaxf(row_max[h], m * scale_log2);
      }
#pragma unroll
      for (int i = 0; i < kBlockK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * i + e] = ex2(fmaf(s[4 * i + e], scale_log2, -new_max[e / 2]));
    } else {
#pragma unroll
      for (int i = 0; i < kBlockK / 8; ++i) {
        const int col = 8 * i + 2 * quad;
        const int2 key_id = Mask::kUsesIds
                                ? *reinterpret_cast<const int2*>(kid + col)
                                : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e & 1;
          s[4 * i + e] = !kFull && k0 + col + j >= seq_len ? -INFINITY
                         : Mask::allowed(row_id[e / 2], j ? key_id.y
                                                          : key_id.x)
                             ? s[4 * i + e] * scale_log2
                             : kMaskedScore;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < kBlockK / 8; ++i)
          m = fmaxf(m, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 1));
        m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 2));
        new_max[h] = fmaxf(row_max[h], m);
      }
#pragma unroll
      for (int i = 0; i < kBlockK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * i + e] = ex2(s[4 * i + e] - new_max[e / 2]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float alpha = ex2(row_max[h] - new_max[h]);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockK / 8; ++i)
        sum += s[4 * i + 2 * h] + s[4 * i + 2 * h + 1];
      row_sum[h] = row_sum[h] * alpha + sum;
      row_max[h] = new_max[h];
#pragma unroll
      for (int i = 0; i < L::kWidth0 / 8; ++i) {
        o0[4 * i + 2 * h] *= alpha;
        o0[4 * i + 2 * h + 1] *= alpha;
      }
      if constexpr (L::kPanels > 1) {
#pragma unroll
        for (int i = 0; i < L::kWidth1 / 8; ++i) {
          o1[4 * i + 2 * h] *= alpha;
          o1[4 * i + 2 * h + 1] *= alpha;
        }
      }
    }
  };

  int stage = 0, pending = -1;
  uint32_t phase = 0;
  auto consume = [&](int t) {
    mbar_wait(&sm.full[stage], phase);
    if (visited<Mask>(sm.bits, t)) {
      const uint32_t k_addr = smem_addr(sm.k_tile(stage));
      const uint32_t v_addr = smem_addr(sm.v_tile(stage));
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
        // head dims 64 p .. 64 p + 63 lie in panel p = step / 4
        const uint32_t q_step = (step / 4) * kSm90MaxConsumers * kSm90Box +
                                (step % 4) * 32;
        const uint32_t k_step = (step / 4) * kSm90Box + (step % 4) * 32;
        WgmmaSS<kBlockK>::run(s, desc_k_major(q_addr + q_step),
                              desc_k_major(k_addr + k_step), step > 0);
      }
      wgmma_commit();
      // retires Q.K^T (and, overlapped, the last tile's P.V)
      wgmma_wait<0>();
      fence_operands(s);
      if constexpr (kOverlapPV) {
        fence_o();
        fence_operands(pf);
        if (pending >= 0) release(pending);
      }

      const int k0 = t * kBlockK;
      const int* kid = sm.key_ids + stage * kBlockK;
      if (k0 + kBlockK <= seq_len)
        softmax(std::true_type{}, k0, kid);
      else
        softmax(std::false_type{}, k0, kid);

      // P in bf16: the A fragment of keys 16 ks .. 16 ks + 15
#pragma unroll
      for (int ks = 0; ks < kBlockK / 16; ++ks) {
        pf[ks][0] = pack_bf16(s[8 * ks], s[8 * ks + 1]);
        pf[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        pf[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        pf[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
      }
      fence_o();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBlockK / 16; ++ks) {
        WgmmaRS<L::kWidth0>::run(o0, pf[ks],
                                 desc_mn_major(v_addr + ks * 2048));
        if constexpr (L::kPanels > 1)
          WgmmaRS<L::kWidth1>::run(
              o1, pf[ks], desc_mn_major(v_addr + kSm90Box + ks * 2048));
      }
      wgmma_commit();
      if constexpr (kOverlapPV) {
        pending = stage;
      } else {
        wgmma_wait<0>();
        fence_o();
        fence_operands(pf);
        release(stage);
      }
    } else {
      // a tile the block skips (tile 0 only) is released unread
      release(stage);
    }
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  consume(0);
  for (int t = next_tile<Mask>(sm.bits, 1, blk.n_tiles); t < blk.n_tiles;
       t = next_tile<Mask>(sm.bits, t + 1, blk.n_tiles))
    consume(t);
  if constexpr (kOverlapPV) {
    wgmma_wait<0>();
    fence_o();
    fence_operands(pf);
  }
  // (the producer has issued every tile: the last stage needs no release)

  // the epilogue: O over the row's sum in bf16 into the warpgroup's own Q
  // boxes, then out by TMA
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = row_sum[h];
    sum += __shfl_xor_sync(kFullMask, sum, 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    inv[h] = 1.f / sum;
  }
  stage_out(sm.q_box(0, wg), o0, inv, warp, group, quad);
  if constexpr (L::kPanels > 1)
    stage_out(sm.q_box(1, wg), o1, inv, warp, group, quad);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (t128 == 0) {
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_store(map_out, sm.q_box(p, wg), 64 * p, blk.q0 + 64 * wg,
                blk.head, blk.batch);
    bulk_commit();
    // the stores have read shared memory before the block exits
    bulk_wait_read<0>();
  }
}

// --- the kernel and its launch ----------------------------------------------

template <int DP, typename Mask>
__global__ void __launch_bounds__(kSm90Threads, Sm90Layout<DP>::kMinBlocks)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_out,
                          const int* __restrict__ ids, int seq_len,
                          float scale_log2) {
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "padded head dim");
  using L = Sm90Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const Sm90Smem<DP> sm(smem_raw);
  Sm90Block blk;
  blk.consumers = (blockDim.x - 32) / 128;
  blk.q0 = blockIdx.x * 64 * blk.consumers;
  blk.head = blockIdx.y;
  blk.batch = blockIdx.z;
  blk.seq_len = seq_len;
  blk.active = min(blk.consumers, (seq_len - blk.q0 + 63) / 64);
  blk.n_tiles = (seq_len + kBlockK - 1) / kBlockK;
  const int* id_row =
      Mask::kUsesIds ? ids + static_cast<long long>(blk.batch) * seq_len
                     : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    mbar_init(sm.bits_ready, 32);
    for (int st = 0; st < L::kStages; ++st) {
      // the producer's 32 lanes, and lane 0's arrival that arms the bytes
      mbar_init(&sm.full[st], 33);
      // lane 0 of every warp of the active consumers
      mbar_init(&sm.empty[st], 4 * blk.active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (a consumer warpgroup whose 64 rows all lie past S has nothing to do)
  const int wg = threadIdx.x / 128;
  if (wg == blk.consumers)
    sm90_produce<DP, Mask>(&map_q, &map_k, &map_v, id_row, sm, blk);
  else if (wg < blk.active)
    sm90_consume<DP, Mask>(&map_out, id_row, sm, blk, wg, scale_log2);
}

// One (B, N, S, D) bf16 operand as a 4-d map (D, S, N, B), innermost first,
// in 64 x 64 boxes with the 128-byte swizzle; loads past S or D read zeros,
// stores past them are dropped. TMA takes strides in multiples of 16 bytes:
// the views' strides are multiples of 8 elements wherever the axis has more
// than one entry, and an axis of one entry (whose stride is never used)
// gets 2 D bytes.
inline bool encode_operand(CUtensorMap* map, const void* base,
                           const Strides& st, int batch, int heads,
                           int seq_len, int head_dim) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto bytes = [&](long long stride, int size) {
    return static_cast<cuuint64_t>(size > 1 ? stride * 2 : head_dim * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(st.token, seq_len),
                                 bytes(st.head, heads),
                                 bytes(st.batch, batch)};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, element_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// Launch one (padded head dim, mask) bf16 instance on `stream`; returns the
// cudaError_t of the launch (the kernel runs asynchronously).
template <int DP, typename Mask>
cudaError_t launch_attention_sm90(const void* q, const void* k, const void* v,
                                  const void* ids, void* out,
                                  const Operands& strides, int batch,
                                  int heads, int seq_len, int head_dim,
                                  float scale, cudaStream_t stream) {
  using L = Sm90Layout<DP>;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, out};
  const Strides* views[4] = {&strides.q, &strides.k, &strides.v, &strides.out};
  for (int i = 0; i < 4; ++i)
    if (!encode_operand(&maps[i], bases[i], *views[i], batch, heads, seq_len,
                        head_dim))
      return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  // per device: the SM count, and the shared-memory opt-in of this
  // instance (racing calls store the same values)
  static int sms[kMaxDevices] = {};
  static bool opted_in[kMaxDevices] = {};
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
  }
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(attention_sm90_kernel<DP, Mask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  // 128-row tiles (two consumers) unless S fits one warpgroup's 64 rows or
  // 128-row tiles would leave SMs without a block
  const long long wide_blocks =
      static_cast<long long>((seq_len + 127) / 128) * heads * batch;
  const int consumers = seq_len <= 64 || wide_blocks < sms[device] ? 1 : 2;
  const dim3 grid((seq_len + 64 * consumers - 1) / (64 * consumers), heads,
                  batch);
  attention_sm90_kernel<DP, Mask><<<grid, 128 * consumers + 32, L::kBytes,
                                    stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const int*>(ids),
      seq_len, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The tile loops a wrapper names (ops/flash_attention.py `tile_loop`).
enum Loop : int { kLoopFma = 0, kLoopMmaSync = 1, kLoopWgmma = 2 };

// Launch the (dtype, padded head dim, mask) instance of the loop `loop`:
// fp32 runs only the FMA loop, bf16 the mma.sync or the wgmma loop; any
// other pairing is cudaErrorInvalidValue.
template <typename T, int DP, typename Mask>
cudaError_t launch_loop(int loop, const void* q, const void* k,
                        const void* v, const void* ids, void* out,
                        const Operands& strides, int batch, int heads,
                        int seq_len, int head_dim, float scale,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (loop != kLoopFma) return cudaErrorInvalidValue;
  } else {
    if (loop == kLoopWgmma)
      return launch_attention_sm90<DP, Mask>(q, k, v, ids, out, strides,
                                             batch, heads, seq_len, head_dim,
                                             scale, stream);
    if (loop != kLoopMmaSync) return cudaErrorInvalidValue;
  }
  return launch_attention<T, DP, Mask>(q, k, v, ids, out, strides, batch,
                                       heads, seq_len, head_dim, scale,
                                       stream);
}

}  // namespace marqo_attention
