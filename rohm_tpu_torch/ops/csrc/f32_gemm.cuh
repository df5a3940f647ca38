// The f32 GEMM main loop of gemm_train.cu (the f32 mode of the training
// products; the f32 inference layer's gemm_f32.cu runs the wgmma loop of
// f32_wgmma.cuh, with the same arithmetic): C tile [TB_M x TB_N] = op(A) .
// op(B) with f32-accurate sums, then an epilogue that the caller supplies.
//
// 3xTF32 on the tensor cores. Each operand element x is split in registers,
// after its fragment is loaded from shared memory, into two TF32 operands:
//   big = x rounded to TF32 to nearest, ties away from zero (the bits of
//         cvt.rna.tf32.f32, by two integer instructions: cvt runs on the
//         conversion unit, and with it the loop ran 1.21x longer on the
//         card), small = x - big (exact in f32; the tensor cores read the
//         top 19 bits of a TF32 operand, which cuts small toward zero);
// and each fragment pair issues mma.sync m16n8k8 tf32 a_small.b_big,
// a_big.b_small, a_big.b_big, the small terms first (as CUTLASS's
// OpMultiplyAddFastF32 orders them).
// Error budget per product a.b: TF32 keeps 10 explicit mantissa bits, so
// |x - big| <= 2^-11 |x|, and small loses at most 2^-10 of itself, so
// |x - big - small| <= 2^-21 |x|; the dropped terms (small.small and the
// two residuals) are <= ~3 2^-21 |a||b|, plus the f32 accumulation.
// The tensor cores' f32 accumulation is not IEEE round-to-nearest (it
// truncates), and a truncation biased one way over K/8 x 3 products grows
// linearly with K: accumulated straight through the mma's, the f32
// layer's products reached 0.82 of gemm_f32's gate on the card. So the
// products of one 32-deep k-step sum into a partial accumulator that
// starts at zero, and each partial is added to the running sum rounded to
// nearest (__fadd_rn). Against the gates of the callers (2e-5 sum|a||b|
// for gemm_train, 1e-5 max|ref| + 1e-6 for gemm_f32, whose wgmma loop
// keeps this budget) the products then reach at most ~0.03 and ~0.14 at
// the layers' shapes; chip_smoke.py logs each product's worst error as a
// fraction of its gate.
//
// Why mma.sync and not wgmma, for the training layouts: wgmma takes tf32
// operands only K-major (B in shared memory, A there or in registers), and
// two of the three training layouts have an MN-major operand (dY.W: B
// stored [K, N]; dY^T.X: A stored [K, M], B stored [K, N]). Fragments in
// registers take either layout. gemm_f32's products (A [M, K], W [N, K])
// are K-major on both sides, so they run on wgmma.
//
// Operands come through a ring of STAGES shared-memory stages filled by
// cp.async 16-byte copies, each operand in its stored layout:
//   op(A) is A [M,K] row-major (K-major: smem [TB_M][TB_K + 4]), or (AT) A
//     stored [K,M] (MN-major: smem [TB_K][TB_M + 8]);
//   op(B) is B [K,N] row-major (MN-major: smem [TB_K][TB_N + 8]), or (BT) B
//     stored [N,K] (K-major: smem [TB_N][TB_K + 4]).
// Fragments of a K-major tile come by ldmatrix (one x4 gives an A fragment
// or the B fragments of two mma tiles: 8 x 4-float matrices, rows 144 bytes
// apart); of an MN-major tile by one 16-byte load per k row and lane, with
// the tile's row (column) labels permuted so that lane (g, t) = (lane / 4,
// lane % 4) finds its four values at 4g .. 4g + 3 (banks 8t + 4g: the pitch
// is 8 mod 32). None of the loads has a bank conflict. Ragged rows, columns
// and K come from the zero-fill form of the copy (16 bytes: every
// contiguous dimension a multiple of 4). The loads of k-step s + STAGES - 1
// are issued before k-step s is multiplied.
//
// 32 x 32 outputs per warp (2 x 4 mma tiles of 16 x 8), 64 x 64 tiles of 4
// warps in 3 stages (55 KB, 124 registers): four blocks per SM. On the
// card the f32 inference layer's products (which this loop ran before
// f32_wgmma.cuh) took 1.10x as long on 128 x 64 tiles (2 per SM), 1.30x on
// 128 x 128 (1 per SM), 1.00x and 1.28x in 4 and 2 stages
// (rohm_tpu_torch/scripts/f32_gemm_variants.py measures each choice;
// transformer_layer_train.GEMM_TILES[False] repeats the tile for the
// split-K plan).
// When the main loop is done the tile is staged in shared memory (the ring
// is free by then) and the epilogue runs as one rolled loop over float4
// rows of it: epi(m, n, v) for each in-bounds m and n = 4i (N % 4 == 0),
// with v the sums of C[m, n..n+3]. The rolled loop keeps one copy of the
// epilogue's code (unrolled epilogues ran from the instruction cache's
// misses in the bf16 loop).
//
// Everything here is in an unnamed namespace: each source that includes it
// compiles its own kernels (the library is built without relocatable
// device code).
#pragma once

#include "common.cuh"

namespace {

namespace f32g {

constexpr int TB_M = 64, TB_N = 64, TB_K = 32, STAGES = 3;

using rohm::mma_tf32;
using rohm::split;

__device__ __forceinline__ float4 lds128(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The shared-memory layout of a TB_M x TB_N tile's ring for the operands'
// layouts; 32 x 32 outputs per warp.
template <bool AT, bool BT>
struct Tile {
  static_assert(TB_M % 32 == 0 && TB_N % 32 == 0, "32 x 32 outputs per warp");
  static constexpr int WARPS_N = TB_N / 32, WARPS = (TB_M / 32) * WARPS_N, THREADS = 32 * WARPS;
  static constexpr int LDA = AT ? TB_M + 8 : TB_K + 4;  // floats per smem row of A
  static constexpr int LDB = BT ? TB_K + 4 : TB_N + 8;
  static constexpr int A_FLOATS = AT ? TB_K * LDA : TB_M * LDA;
  static constexpr int B_FLOATS = BT ? TB_N * LDB : TB_K * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int LDC = TB_N + 4;  // the staged tile
  static constexpr size_t SMEM =
      4 * (size_t)(STAGES * STAGE_FLOATS > TB_M * LDC ? STAGES * STAGE_FLOATS : TB_M * LDC);
  // blocks per SM that the shared memory allows (228 KB, 1 KB of it each
  // the system's), and registers: at most 65536 per SM
  static constexpr int MIN_BLOCKS = (int)(233472 / (SMEM + 1024));
  static_assert(MIN_BLOCKS >= 1, "the ring fits in shared memory");
};

// ROWS rows (of M or N) x TB_K columns (of K) of a K-major operand stored
// [rows, ld]: row r0 + r from src + (r0 + r) * ld + k0
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_k_major(float* dst, const float* src, int ld, int r0, int rows, int k0,
                                             int k_end, int tid) {
  constexpr int CH = TB_K / 4;
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int q = 0; q < ROWS * CH / THREADS; ++q) {
    const int c = tid + q * THREADS, r = c / CH, kc = (c % CH) * 4;
    const bool ok = r0 + r < rows && k0 + kc < k_end;
    rohm::cp_async16(dst + r * (TB_K + 4) + kc, ok ? src + (size_t)(r0 + r) * ld + k0 + kc : src, ok);
  }
}

// TB_K rows (of K) x COLS columns (of M or N) of an MN-major operand stored
// [K, ld]: row k0 + k from src + (k0 + k) * ld + c0
template <int COLS, int THREADS>
__device__ __forceinline__ void load_mn_major(float* dst, const float* src, int ld, int c0, int cols, int k0,
                                              int k_end, int tid) {
  constexpr int CH = COLS / 4;
  static_assert(TB_K * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int q = 0; q < TB_K * CH / THREADS; ++q) {
    const int c = tid + q * THREADS, k = c / CH, xc = (c % CH) * 4;
    const bool ok = k0 + k < k_end && c0 + xc < cols;
    rohm::cp_async16(dst + k * (COLS + 8) + xc, ok ? src + (size_t)(k0 + k) * ld + c0 + xc : src, ok);
  }
}

// Which tile row and column each accumulator holds. Row label (i, h, g) of
// the warp's mma tile i (rows g and g + 8: h) and column label (j, c) of its
// mma tile j: K-major operands in their natural order (ldmatrix reads
// them), MN-major ones with the labels permuted so that one 16-byte load
// of a k row gives a lane its four values (rows / columns 4g .. 4g + 3).
template <bool AT>
__device__ __forceinline__ int row_of(int wm, int i, int h, int g) {
  return AT ? wm + 4 * g + 2 * i + h : wm + 16 * i + 8 * h + g;
}
template <bool BT>
__device__ __forceinline__ int col_of(int wn, int j, int c) {
  return BT ? wn + 8 * j + c : wn + 4 * c + j;
}

// blockIdx.z picks the k_chunk-deep slice of K that this block sums
// (split-K; the epilogue sees blockIdx.z).
template <bool AT, bool BT, class Epilogue>
__global__ void __launch_bounds__(Tile<AT, BT>::THREADS, Tile<AT, BT>::MIN_BLOCKS)
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K, int k_chunk,
                Epilogue epi) {
  using T = Tile<AT, BT>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  const int wm = (warp / T::WARPS_N) * 32, wn = (warp % T::WARPS_N) * 32;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + TB_K - 1) / TB_K : 0;

  auto load = [&](int it) {  // k-step `it` into stage it % STAGES
    float* a = smem + (it % STAGES) * T::STAGE_FLOATS;
    float* b = a + T::A_FLOATS;
    const int k = k_begin + it * TB_K;
    if (AT) load_mn_major<TB_M, T::THREADS>(a, A, M, m0, M, k, k_end, tid);
    else load_k_major<TB_M, T::THREADS>(a, A, K, m0, M, k, k_end, tid);
    if (BT) load_k_major<TB_N, T::THREADS>(b, B, K, n0, N, k, k_end, tid);
    else load_mn_major<TB_N, T::THREADS>(b, B, N, n0, N, k, k_end, tid);
  };

  // ldmatrix row addresses (K-major operands): lane l gives row l % 8 of
  // 8 x 4-float matrix l / 8. A: matrices (rows +0, k +0), (+8, +0),
  // (+0, +4), (+8, +4) = a0..a3 of mma tile i; B: (ntile j, k +0), (j, +4),
  // (j + 1, +0), (j + 1, +4) = b0, b1 of mma tiles j and j + 1.
  const int q = lane / 8, l8 = lane % 8;
  const int a_off = (wm + l8 + 8 * (q % 2)) * T::LDA + 4 * (q / 2);
  const int b_off = (wn + l8 + 8 * (q / 2)) * T::LDB + 4 * (q % 2);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    rohm::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    rohm::cp_async_wait_group<STAGES - 2>();  // k-step `it` has landed (this thread's copies)
    __syncthreads();                          // everyone's copies, and stage it - 1 is free again
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    rohm::cp_async_commit();
    const float* a = smem + (it % STAGES) * T::STAGE_FLOATS;
    const float* b = a + T::A_FLOATS;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < TB_K; kk += 8) {
      // A fragments of the warp's two mma tiles: rows (g, g + 8) by k slots
      // (t, t + 4)
      float ar[2][4];
      if (AT) {  // k rows kk + t and kk + t + 4, m labels 4g .. 4g + 3
        const float4 lo = lds128(a + (kk + t) * T::LDA + wm + 4 * g);
        const float4 hi = lds128(a + (kk + t + 4) * T::LDA + wm + 4 * g);
        ar[0][0] = lo.x, ar[0][1] = lo.y, ar[1][0] = lo.z, ar[1][1] = lo.w;
        ar[0][2] = hi.x, ar[0][3] = hi.y, ar[1][2] = hi.z, ar[1][3] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t r[4];
          rohm::ldsm_x4(r, rohm::smem_u32(a + a_off + 16 * i * T::LDA + kk));
#pragma unroll
          for (int e = 0; e < 4; ++e) ar[i][e] = __uint_as_float(r[e]);
        }
      }
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split(ar[i][e], ab[i][e], as[i][e]);
      // B fragments of the four mma tiles: k slots (t, t + 4) by column g
      float br[4][2];
      if (BT) {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t r[4];
          rohm::ldsm_x4(r, rohm::smem_u32(b + b_off + 8 * j * T::LDB + kk));
          br[j][0] = __uint_as_float(r[0]), br[j][1] = __uint_as_float(r[1]);
          br[j + 1][0] = __uint_as_float(r[2]), br[j + 1][1] = __uint_as_float(r[3]);
        }
      } else {  // k rows kk + t and kk + t + 4, n labels 4g .. 4g + 3
        const float4 lo = lds128(b + (kk + t) * T::LDB + wn + 4 * g);
        const float4 hi = lds128(b + (kk + t + 4) * T::LDB + wn + 4 * g);
        br[0][0] = lo.x, br[1][0] = lo.y, br[2][0] = lo.z, br[3][0] = lo.w;
        br[0][1] = hi.x, br[1][1] = hi.y, br[2][1] = hi.z, br[3][1] = hi.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[2], bs[2];
        split(br[j][0], bb[0], bs[0]);
        split(br[j][1], bb[1], bs[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(part[i][j], as[i], bb[0], bb[1]);
          mma_tf32(part[i][j], ab[i], bs[0], bs[1]);
          mma_tf32(part[i][j], ab[i], bb[0], bb[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  rohm::cp_async_wait_group<0>();
  __syncthreads();  // the ring is free: stage the tile

  // accumulator e of mma tile (i, j): row label (i, e / 2, g), column label
  // (j, 2t + e % 2)
  float* tile = smem;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[row_of<AT>(wm, i, e / 2, g) * T::LDC + col_of<BT>(wn, j, 2 * t + e % 2)] = acc[i][j][e];
  __syncthreads();

#pragma unroll 1
  for (int e = tid; e < TB_M * TB_N / 4; e += T::THREADS) {
    const int r = e / (TB_N / 4), c = (e % (TB_N / 4)) * 4;
    const int m = m0 + r, n = n0 + c;  // N % 4 == 0: n < N means n + 3 < N
    if (m >= M || n >= N) continue;
    epi(m, n, *reinterpret_cast<const float4*>(tile + r * T::LDC + c));
  }
}

// One launch over the [M, N] output in TB_M x TB_N tiles, `splits` slices
// of k_chunk along K (blockIdx.z). A, B and every row pitch 16-byte aligned.
template <bool AT, bool BT, class Epilogue>
cudaError_t launch(const float* A, const float* B, int M, int N, int K, int splits, int k_chunk,
                   const Epilogue& epi, cudaStream_t s) {
  using T = Tile<AT, BT>;
  static bool smem_set = false;
  if (!smem_set) {  // above 48 KB, and as much shared memory as the SM has: several blocks share it
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<AT, BT, Epilogue>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_kernel<AT, BT, Epilogue>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M, splits);
  gemm_kernel<AT, BT, Epilogue><<<grid, T::THREADS, T::SMEM, s>>>(A, B, M, N, K, k_chunk, epi);
  return cudaGetLastError();
}

}  // namespace f32g

}  // namespace
