// The Hopper GEMM main loop of the port, shared by gemm_train.cu (the
// training products), gemm_bf16.cu (the bf16 inference layer's products),
// gemm_int8.cu (the W8A8 layer's products) and encoder_stack_int8.cu (the
// whole stack's GEMM phases): C tile [128 x BN] = op(A) . op(B), then an
// epilogue that each caller supplies. One routine, gemm_tile, runs a tile;
// gemm_kernel runs it once per block, the stack kernel in a grid-stride
// loop over each phase's tiles, its ring carried from tile to tile. It is
// templated on the operand type (`Op`): bf16 with f32 sums, or s8 with
// s32 sums. In bytes the two are the same tile: a k-step is one 128-byte
// row of each operand (64 bf16 or 128 s8 values, the 128-byte swizzle's
// width), so the TMA boxes, the ring and its mbarriers do not change, and
// a k-step is 4 wgmma deep either way (k16 bf16, k32 s8).
//
// One producer warp keeps TMA loads (cp.async.bulk.tensor, 128-byte
// swizzle) of k-steps in a ring of 3 stages with full and empty
// mbarriers; two consumer warpgroups each run wgmma.mma_async on 64 rows
// of the tile, the sums in registers. Each operand is loaded in its stored
// layout and the descriptors' transpose bits pick K- or MN-major (bf16;
// wgmma takes 8-bit operands only K-major, so s8 needs A [M,K] and B
// stored [N,K]):
//   op(A) is A [M,K] row-major (K-major), or (AT) A stored [K,M];
//   op(B) is B [K,N] row-major (MN-major), or (BT) B stored [N,K].
// Ragged edges (rows, columns, K) come from TMA's zero fill. When both
// warpgroups are done, the tile is staged in shared memory (the ring is
// free by then) and the epilogue runs as one rolled loop over float4 rows
// of it: epi(m, n, v) for each in-bounds m and n = 4i (N % 8 == 0), with v
// the sums of C[m, n..n+3] (s32 sums converted to f32, rounded to nearest:
// exact below 2^24). The rolled loop keeps one copy of the epilogue's code:
// unrolled over the accumulators it ran from the instruction cache's
// misses.
//
// Everything here is in an unnamed namespace: each source that includes it
// compiles its own kernels (the library is built without relocatable
// device code).
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder itself comes from the driver at run time

#include "common.cuh"

namespace {

namespace wg {

constexpr int TB_M = 128, STAGES = 3;
constexpr int K_BYTES = 128;  // a k-step: one 128-byte row of each operand's tile
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 32;  // two warpgroups + the producer warp
constexpr int A_BYTES = TB_M * K_BYTES;
constexpr int HALF_BYTES = 64 * K_BYTES;  // 64 rows (or 64 columns) of one k-step's tile

// A tile of 128 x BN (64 or 128) outputs.
template <int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128, "wgmma tiles are 64 or 128 wide");
  static constexpr int B_BYTES = BN * K_BYTES, STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int LD = BN + 8;  // f32 row pitch of the tile staged for the epilogue
  // the ring, its 2 x STAGES mbarriers, and room to align the ring to 1024
  // bytes (the 128-byte swizzle's period): 97 KB at BN = 128 (two blocks
  // per SM), 73 KB at BN = 64 (three)
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 16 * STAGES + 1024;
  static constexpr int MIN_BLOCKS = BN == 128 ? 2 : 3;
  static_assert(TB_M * LD * 4 <= STAGES * STAGE_BYTES, "the epilogue's tile fits in the ring");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of this parity has completed. A wait of seconds is
// a broken pipeline: trap (a launch error the wrapper reports) rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// box (c0 = column, c1 = row) of a 2-D tensor map -> shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// box (c0 = column, c1 = row, c2 = matrix) of a 3-D tensor map -> shared memory
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle; lbo is the byte stride
// between 64-element chunks along M/N of an MN-major operand (unused by a
// K-major one), sbo the stride between groups of 8 rows (of M/N when
// K-major, of K when MN-major). `addr` must sit in a 1024-aligned tile.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float acc_f32(float v) { return v; }
__device__ __forceinline__ float acc_f32(int v) { return __int2float_rn(v); }

// d[64xBN] += A[64x16] . B[16xBN]; TA / TB: A / B MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64xBN] += A[64x32] . B[32xBN], s8 operands, both K-major, s32 sums
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The operand types of the main loop: the accumulator, the values of a
// k-step (128 bytes), the tensor maps' element type, and one wgmma of a
// 32-byte slice of the k-step (TA / TB: A / B MN-major).
struct Bf16 {
  using Acc = float;
  static constexpr int K_STEP = 64;
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int TA, int TB, int N>
  static __device__ __forceinline__ void mma(float (&d)[N], uint64_t da, uint64_t db) {
    wgmma<TA, TB>(d, da, db);
  }
};

struct S8 {
  using Acc = int;
  static constexpr int K_STEP = 128;
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // the bytes as they are
  template <int TA, int TB, int N>
  static __device__ __forceinline__ void mma(int (&d)[N], uint64_t da, uint64_t db) {
    static_assert(TA == 0 && TB == 0, "wgmma takes 8-bit operands only K-major");
    wgmma_s8(d, da, db);
  }
};

constexpr int TB_K = Bf16::K_STEP;  // the bf16 k-step: gemm_train's split-K unit

// Stage s of the ring holds A (16 KB) then B (BN x 128 bytes):
//   A K-major (A [M,K]): one box of [128 rows][one k-step]; warpgroup w's
//     64 rows start at 8 KB * w;
//   A MN-major (AT, stored [K,M]; bf16): two boxes of [64 k][64 m], one
//     per warpgroup;
//   B K-major (BT, stored [N,K]): one box of [BN n][one k-step];
//   B MN-major (stored [K,N]; bf16): BN / 64 boxes of [64 k][64 n], 8 KB
//     apart (lbo).
// Each row of a box is 128 bytes, swizzled in groups of 8 rows (sbo 1 KB).
// A wgmma's 32-byte slice of K (k16 bf16, k32 s8) starts 32 bytes further
// along a K-major row, 16 rows (2 KB) further down an MN-major box.
//
// A block's ring: its stages from `base` (1024-aligned), the epilogue's
// staging tile (`tile`: the generic address of `base`, over the stages,
// unless the caller points it elsewhere), and its
// mbarriers full[STAGES] then empty[STAGES] at `bars`. `it` counts the
// k-steps the thread's role has loaded (the producer warp) or consumed (the
// consumers) over every tile the block has run: a k-step's stage is
// it % STAGES and its mbarrier parity (it / STAGES) & 1, so a caller that
// runs several tiles carries `it` from one to the next.
struct Ring {
  uint32_t base, bars;
  float* tile;
  int it;
};

// the ring at the first 1024-aligned byte of `smem` (generic), its
// mbarriers at `bars`; thread 0 initialises them, then the whole block syncs
__device__ __forceinline__ Ring ring_init(uint8_t* smem, uint32_t bars) {
  const uint32_t base = (rohm::smem_u32(smem) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                          // the producer's arrive + the bytes
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return Ring{base, bars, reinterpret_cast<float*>(smem + (base - rohm::smem_u32(smem))), 0};
}

// One 128 x BN tile of C at (m0, n0), summed over K in [k_begin, k_end),
// by a block of THREADS: warps 0-7 the consumers, warp 8 the producer.
// `load(a, b, full, k)` (run by lane 0 of the producer) issues the TMA
// loads of the k-step at k into the stage's A and B with `full` as their
// mbarrier. The producer warp returns when its loads are issued; the
// consumers return after the epilogue. Where its staging tile lies over
// the stages, a caller that runs another tile keeps the producer from
// loading into them before the epilogue is done.
template <bool AT, bool BT, int BN, class Op, class Load, class Epilogue>
__device__ __forceinline__ void gemm_tile(Ring& ring, int m0, int n0, int M, int N, int k_begin, int k_end,
                                          const Load& load, const Epilogue& epi) {
  using T = Tile<BN>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = k_end > k_begin ? (k_end - k_begin + Op::K_STEP - 1) / Op::K_STEP : 0;

  if (warp == CONSUMERS / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int it = ring.it + i, s = it % STAGES;
        const uint32_t full = ring.bars + 8 * s, a = ring.base + s * T::STAGE_BYTES;
        if (it >= STAGES) mbar_wait(ring.bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, T::STAGE_BYTES);
        load(a, a + A_BYTES, full, k_begin + i * Op::K_STEP);
      }
    }
    ring.it += steps;
    return;
  }

  // the consumers: warpgroup wg owns rows 64 * wg .. of the tile
  const int wg = warp / 4;
  typename Op::Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < steps; ++i) {
    const int it = ring.it + i, s = it % STAGES;
    mbar_wait(ring.bars + 8 * s, (it / STAGES) & 1);
    const uint32_t stage = ring.base + s * T::STAGE_BYTES, a = stage + wg * HALF_BYTES, b = stage + A_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < K_BYTES / 32; ++kk) {
      const uint64_t da = AT ? smem_desc(a + kk * 2048, HALF_BYTES, 1024) : smem_desc(a + kk * 32, 16, 1024);
      const uint64_t db = BT ? smem_desc(b + kk * 32, 16, 1024) : smem_desc(b + kk * 2048, HALF_BYTES, 1024);
      Op::template mma<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.bars + 8 * (STAGES + s));  // this warp is done with stage s
  }
  ring.it += steps;

  // Accumulator i of thread (warp, lane) is row 16 * (warp % 4) + lane / 4
  // + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the
  // warpgroup's 64 x BN.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  float* tile = ring.tile;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * T::LD + c0 + 8 * j) =
          make_float2(acc_f32(acc[4 * j + 2 * h]), acc_f32(acc[4 * j + 2 * h + 1]));
  asm volatile("bar.sync 1, 256;" ::: "memory");

#pragma unroll 1
  for (int e = tid; e < TB_M * BN / 4; e += CONSUMERS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c;  // N % 8 == 0: n < N means n + 3 < N
    if (m >= M || n >= N) continue;
    epi(m, n, *reinterpret_cast<const float4*>(tile + r * T::LD + c));
  }
}

// One tile per block. blockIdx.z picks the k_chunk-deep slice of K that
// this block sums (split-K; the epilogue sees blockIdx.z).
template <bool AT, bool BT, int BN, class Op, class Epilogue>
__global__ void __launch_bounds__(THREADS, Tile<BN>::MIN_BLOCKS) gemm_kernel(
    __grid_constant__ const CUtensorMap tma_a, __grid_constant__ const CUtensorMap tma_b, int M, int N,
    int K, int k_chunk, Epilogue epi) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t bars = ((rohm::smem_u32(smem_raw) + 1023u) & ~1023u) + STAGES * T::STAGE_BYTES;
  Ring ring = ring_init(smem_raw, bars);
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  auto load = [&](uint32_t a, uint32_t b, uint32_t full, int k) {
    if (AT) {
      tma_load(a, &tma_a, full, m0, k);
      tma_load(a + HALF_BYTES, &tma_a, full, m0 + 64, k);
    } else {
      tma_load(a, &tma_a, full, k, m0);
    }
    if (BT) {
      tma_load(b, &tma_b, full, k, n0);
    } else {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) tma_load(b + c * HALF_BYTES, &tma_b, full, n0 + 64 * c, k);
    }
  };
  gemm_tile<AT, BT, BN, Op>(ring, m0, n0, M, N, k_begin, k_end, load, epi);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so the entry point is fetched from the driver once
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major matrix [rows, cols] of Op's values, read in boxes of
// box_rows x one k-step (128 bytes, the swizzle's width); boxes past its
// edges read zeros. The row pitch must be a multiple of 16 bytes.
template <class Op>
inline bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * (K_BYTES / Op::K_STEP)};
  const cuuint32_t box[2] = {(cuuint32_t)Op::K_STEP, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, Op::MAP_TYPE, 2, const_cast<void*>(ptr), dims, pitch, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `count` row-major matrices [rows, cols] of Op's values stored one after
// another, read in boxes of box_rows x one k-step of one matrix (the
// matrix is the map's third coordinate)
template <class Op>
inline bool encode_stacked(CUtensorMap* map, const void* ptr, int count, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t row_bytes = (cuuint64_t)cols * (K_BYTES / Op::K_STEP);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)count};
  const cuuint64_t pitch[2] = {row_bytes, row_bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)Op::K_STEP, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, Op::MAP_TYPE, 3, const_cast<void*>(ptr), dims, pitch, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of op(A) and op(B) for a BN-wide tile: A [M,K] (AT: [K,M]),
// B [K,N] (BT: [N,K]).
template <bool AT, bool BT, int BN, class Op = Bf16>
bool encode_operands(CUtensorMap* ta, CUtensorMap* tb, const void* A, const void* B, int M, int N, int K) {
  return (AT ? encode<Op>(ta, A, K, M, 64) : encode<Op>(ta, A, M, K, TB_M)) &&
         (BT ? encode<Op>(tb, B, N, K, BN) : encode<Op>(tb, B, K, N, 64));
}

// One launch over the [M, N] output in 128 x BN tiles, `splits` slices of
// k_chunk (a multiple of Op's k-step) along K (blockIdx.z).
template <bool AT, bool BT, int BN, class Op = Bf16, class Epilogue>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N, int K, int splits, int k_chunk,
                   const Epilogue& epi, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {  // above 48 KB, and as much shared memory as the SM has: several blocks share it
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<AT, BT, BN, Op, Epilogue>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<BN>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_kernel<AT, BT, BN, Op, Epilogue>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + TB_M - 1) / TB_M, splits);
  gemm_kernel<AT, BT, BN, Op, Epilogue><<<grid, THREADS, Tile<BN>::SMEM, s>>>(ta, tb, M, N, K, k_chunk, epi);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace
