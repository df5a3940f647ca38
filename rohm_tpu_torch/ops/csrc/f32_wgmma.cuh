// The Hopper main loop of gemm_f32.cu (the f32 inference layer's
// products): C tile [128 x BN] = A . W^T with f32-accurate sums, A [M, K]
// row-major activations and W [N, K] a Linear weight, both K-major as
// stored; then an epilogue that the caller supplies.
//
// 3xTF32 on wgmma. Each operand element x is split into two TF32 values,
// big = x rounded to TF32 to nearest, ties away from zero (rohm::split's
// integer rounding), small = x - big (exact in f32; the tensor cores read
// its top 19 bits), and each k8 slice issues three wgmma m64nBNk8 tf32,
// a_small.W_big, a_big.W_small, a_big.W_big, the small terms first: the
// products, their order and the partial sums of f32_gemm.cuh's loop, whose
// head has the error budget. The weights are split once, outside the
// product (`split_tf32_kernel`, cached per weight by the wrapper): W
// arrives as its two halves, a [2, N, K] buffer, W_big then W_small. A
// stays as it is stored: wgmma takes A from registers, so the consumers
// load its fragments from shared memory (ldmatrix) and split them there.
// The products of one 32-deep k-step sum into a partial accumulator that
// the k-step's first wgmma starts at zero (scale-d 0); each partial is
// added to the running sum rounded to nearest (__fadd_rn), as in
// f32_gemm.cuh.
//
// The pipeline is wgmma_gemm.cuh's, with its helpers (mbarriers, TMA,
// descriptors): one thread of a producer warpgroup keeps TMA loads
// (128-byte swizzle) of k-steps in a ring of STAGES shared-memory stages
// with full and empty mbarriers; two consumer warpgroups each run 64 rows
// of the tile, the sums in registers (64 + 64 a thread at BN 128, where
// setmaxnreg gives them the producer's registers: 232 a thread). A k-step
// is 32 f32, one 128-byte row of each operand, so a stage is A [128
// rows][128 bytes], W_big [BN][128 bytes] and W_small [BN][128 bytes], and
// a k8 slice starts 32 bytes further along a row. Ragged rows, columns and
// K come from TMA's zero fill.
//
// SPLIT_B (a variant, rohm_tpu_torch/scripts/f32_gemm_variants.py): W
// arrives as it is stored and the consumers split each landed stage's W
// tile in shared memory, W_big in place and W_small beside it, then fence
// the async proxy before their wgmma.
//
// PERSIST: a grid of (SMs x blocks per SM) blocks, each walking tiles
// blockIdx.x, + gridDim.x, ...; its producer loads the next tile's k-steps
// while the consumers run the epilogue, staged in a region of its own.
// Otherwise one tile per block, staged over the ring.
//
// When both warpgroups are done, the tile is staged in shared memory and
// the epilogue runs as one rolled loop over float4 rows of it: epi(m, n, v)
// for each in-bounds m and n = 4i (N % 4 == 0), with v the sums of
// C[m, n..n+3].
//
// Everything here is in an unnamed namespace: each source that includes it
// compiles its own kernels (the library is built without relocatable
// device code).
#pragma once

#include "wgmma_gemm.cuh"

namespace {

namespace f32g {

using wg::A_BYTES;
using wg::CONSUMERS;
using wg::K_BYTES;
using wg::TB_M;

// two consumer warpgroups and a producer warpgroup: whole warpgroups, so
// that setmaxnreg can move the producer's registers to the consumers
constexpr int THREADS = CONSUMERS + 128;

// f32 values for wg::encode: a k-step of 32 (128 bytes)
struct Tf32 {
  static constexpr int K_STEP = 32;
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <int BN, int STAGES, bool PERSIST, bool SPLIT_B>
struct Tile {
  static_assert(BN == 64 || BN == 128, "wgmma tiles are 64 or 128 wide");
  static constexpr int B_BYTES = BN * K_BYTES, STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  // the bytes TMA brings per k-step: A and both halves of W (SPLIT_B: W)
  static constexpr int TX_BYTES = A_BYTES + (SPLIT_B ? 1 : 2) * B_BYTES;
  static constexpr int LD = BN + 8;  // f32 row pitch of the tile staged for the epilogue
  static constexpr int STAGING = PERSIST ? TB_M * LD * 4 : 0;  // over the ring unless PERSIST
  static_assert(PERSIST || TB_M * LD * 4 <= STAGES * STAGE_BYTES, "the epilogue's tile fits in the ring");
  // the ring, the staging tile, 2 x STAGES mbarriers, and room to align the
  // ring to 1024 bytes (the 128-byte swizzle's period)
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + STAGING + 16 * STAGES + 1024;
  // blocks per SM that the shared memory allows (228 KB, 1 KB of it each
  // the system's), at most two (BN 64; at BN 128 the 64 + 64 sums of a
  // consumer thread leave room for one block)
  static constexpr int SMEM_BLOCKS = (int)(233472 / (SMEM + 1024));
  static constexpr int MIN_BLOCKS = SMEM_BLOCKS >= 2 && BN == 64 ? 2 : 1;
  static_assert(SMEM_BLOCKS >= 1, "the ring fits in shared memory");
  // registers a thread after setmaxnreg: a block starts with 65536 /
  // (THREADS x MIN_BLOCKS) a thread (168, or 80 at two blocks); the
  // producer warpgroup gives all but PRODUCER_REGS back and the consumers
  // take them (one block: 40 + 2 x 232 = 3 x 168)
  static constexpr int PRODUCER_REGS = MIN_BLOCKS == 1 ? 40 : 24;
  static constexpr int CONSUMER_REGS = MIN_BLOCKS == 1 ? 232 : 104;
};

// d[64 x BN] (+)= A[64 x 8] . B[8 x BN], tf32 in, f32 sums: A in registers
// (per warp the m16n8k8 A fragment of its 16 rows: a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane % 4), B
// K-major in shared memory; scale_d 0 starts d at zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wg::ring_init for a ring of STAGES stages: the ring at the first
// 1024-aligned byte of `smem` (generic), its mbarriers full[STAGES] then
// empty[STAGES] at `bars`; thread 0 initialises them, then the block syncs
template <int STAGES>
__device__ __forceinline__ wg::Ring ring_init(uint8_t* smem, uint32_t bars) {
  const uint32_t base = (rohm::smem_u32(smem) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);                          // the producer's arrive + the bytes
      wg::mbar_init(bars + 8 * (STAGES + s), CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return wg::Ring{base, bars, reinterpret_cast<float*>(smem + (base - rohm::smem_u32(smem))), 0};
}

// SPLIT_B: the consumers split a landed W tile (BN rows of 128 bytes) at
// `b` into W_big in place and W_small at `bs`, 16 bytes at a time (the
// split is elementwise, so the swizzle does not matter), then make the
// writes visible to wgmma (the async proxy) and to each other
template <int BN>
__device__ __forceinline__ void split_stage(uint32_t b, uint32_t bs, int tid) {
#pragma unroll
  for (int c = tid; c < BN * K_BYTES / 16; c += CONSUMERS) {
    float x[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(b + 16 * c));
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) rohm::split(x[e], hi[e], lo[e]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(b + 16 * c), "r"(hi[0]), "r"(hi[1]), "r"(hi[2]),
                 "r"(hi[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(bs + 16 * c), "r"(lo[0]), "r"(lo[1]), "r"(lo[2]),
                 "r"(lo[3])
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The tiles of a [M, N] output, 128 x BN each, numbered with n fastest
// (the blocks that run at once share rows of A in L2). A block runs tiles
// blockIdx.x, + gridDim.x, ... by a block of THREADS: warps 0-7 the
// consumers, warps 8-11 the producer warpgroup, one thread of which issues
// the loads. tma_w maps W's halves [2, N, K] (3-D), or (SPLIT_B) W [N, K].
template <int BN, int STAGES, bool PERSIST, bool SPLIT_B, class Epilogue>
__global__ void __launch_bounds__(THREADS, Tile<BN, STAGES, PERSIST, SPLIT_B>::MIN_BLOCKS)
    gemm_kernel(__grid_constant__ const CUtensorMap tma_a, __grid_constant__ const CUtensorMap tma_w, int M, int N,
                int K, Epilogue epi) {
  using T = Tile<BN, STAGES, PERSIST, SPLIT_B>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t aligned = (rohm::smem_u32(smem_raw) + 1023u) & ~1023u;
  wg::Ring ring = ring_init<STAGES>(smem_raw, aligned + STAGES * T::STAGE_BYTES + T::STAGING);
  if (PERSIST) ring.tile += STAGES * T::STAGE_BYTES / 4;  // the staging region after the ring
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (N + BN - 1) / BN, tiles = (M + TB_M - 1) / TB_M * tiles_n;
  const int steps = (K + Tf32::K_STEP - 1) / Tf32::K_STEP;

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(T::PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * TB_M, n0 = tile % tiles_n * BN;
        for (int i = 0; i < steps; ++i, ++ring.it) {
          const int s = ring.it % STAGES, k = i * Tf32::K_STEP;
          const uint32_t full = ring.bars + 8 * s, a = ring.base + s * T::STAGE_BYTES, b = a + A_BYTES;
          if (ring.it >= STAGES) wg::mbar_wait(ring.bars + 8 * (STAGES + s), ((ring.it / STAGES) & 1) ^ 1);
          wg::mbar_expect_tx(full, T::TX_BYTES);
          wg::tma_load(a, &tma_a, full, k, m0);
          if (SPLIT_B) {
            wg::tma_load(b, &tma_w, full, k, n0);
          } else {
            wg::tma_load3(b, &tma_w, full, k, n0, 0);
            wg::tma_load3(b + T::B_BYTES, &tma_w, full, k, n0, 1);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(T::CONSUMER_REGS));
    // the consumers: warpgroup grp owns rows 64 * grp .. of the tile, its
    // warp w rows 16 * (w % 4) .. of those. ldmatrix row addresses: lane l
    // gives row l % 8 of 8 x 4-float matrix q = l / 8, (rows +0, k +0),
    // (+8, +0), (+0, +4), (+8, +4) = a0..a3 of a k8 slice; the 128-byte
    // swizzle puts 16-byte chunk c of row r at c ^ (r % 8), and r % 8 = l % 8
    const int grp = warp / 4, q = lane / 8, l8 = lane % 8;
    const uint32_t a_row = (64 * grp + 16 * (warp % 4) + l8 + 8 * (q % 2)) * K_BYTES;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * TB_M, n0 = tile % tiles_n * BN;
      float acc[BN / 2], part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
      for (int i = 0; i < steps; ++i, ++ring.it) {
        const int s = ring.it % STAGES;
        wg::mbar_wait(ring.bars + 8 * s, (ring.it / STAGES) & 1);
        const uint32_t a = ring.base + s * T::STAGE_BYTES, bb = a + A_BYTES, bs = bb + T::B_BYTES;
        if (SPLIT_B) split_stage<BN>(bb, bs, tid);
        wg::fence_acc(part);
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t r[4];
          rohm::ldsm_x4(r, a + a_row + (((2 * kk + q / 2) ^ l8) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) rohm::split(__uint_as_float(r[e]), ab[kk][e], as[kk][e]);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          wgmma_tf32(part, as[kk], wg::smem_desc(bb + 32 * kk, 16, 1024), kk);
          wgmma_tf32(part, ab[kk], wg::smem_desc(bs + 32 * kk, 16, 1024), 1);
          wgmma_tf32(part, ab[kk], wg::smem_desc(bb + 32 * kk, 16, 1024), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        wg::fence_acc(part);
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(ring.bars + 8 * (STAGES + s));  // this warp is done with stage s
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }

      // Accumulator i of thread (warp, lane) is row 16 * (warp % 4) + lane /
      // 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of
      // the warpgroup's 64 x BN. The first barrier also waits for the
      // previous tile's epilogue to be done with the staging tile.
      asm volatile("bar.sync 1, 256;" ::: "memory");
      float* stage_tile = ring.tile;
      const int r0 = 64 * grp + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stage_tile + (r0 + 8 * h) * T::LD + c0 + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      asm volatile("bar.sync 1, 256;" ::: "memory");

#pragma unroll 1
      for (int e = tid; e < TB_M * BN / 4; e += CONSUMERS) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int m = m0 + r, n = n0 + c;  // N % 4 == 0: n < N means n + 3 < N
        if (m >= M || n >= N) continue;
        epi(m, n, *reinterpret_cast<const float4*>(stage_tile + r * T::LD + c));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// One launch over the [M, N] output in 128 x BN tiles. W: the weight's
// halves [2, N, K] (SPLIT_B: the weight [N, K]). A, W and every row pitch
// 16-byte aligned (K % 4 == 0). The tensor maps are encoded on the host
// for each launch, as gemm_int8's are.
template <int BN, int STAGES, bool PERSIST, bool SPLIT_B, class Epilogue>
cudaError_t launch(const float* A, const float* W, int M, int N, int K, const Epilogue& epi, cudaStream_t s) {
  using T = Tile<BN, STAGES, PERSIST, SPLIT_B>;
  const auto kernel = gemm_kernel<BN, STAGES, PERSIST, SPLIT_B, Epilogue>;
  static int slots = 0;  // blocks the card runs at once
  if (!slots) {  // above 48 KB, and as much shared memory as the SM has: several blocks share it
    int dev = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    slots = sms * T::MIN_BLOCKS;
  }
  CUtensorMap ta, tw;
  const bool ok = wg::encode<Tf32>(&ta, A, M, K, TB_M) &&
                  (SPLIT_B ? wg::encode<Tf32>(&tw, W, N, K, BN) : wg::encode_stacked<Tf32>(&tw, W, 2, N, K, BN));
  if (!ok) return cudaErrorInvalidValue;
  const int tiles = (M + TB_M - 1) / TB_M * ((N + BN - 1) / BN);
  kernel<<<PERSIST && slots < tiles ? slots : tiles, THREADS, T::SMEM, s>>>(ta, tw, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace f32g

}  // namespace
