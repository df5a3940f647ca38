// gemm_train: C[M,N] = op(A) @ op(B), f32 accumulation, with the epilogues
// of the PoseNet training layer; and round_bf16, the cast that stages the
// bf16 mode's activation operands.
//
//   op(A) is A [M,K] row-major, or (a_t) the transpose of A stored [K,M];
//   op(B) is B [K,N] row-major, or (b_t) the transpose of B stored [N,K]
//   (a torch Linear weight [out, in]).
// The three layouts of a training layer: X.W^T (forward, b_t), dY.W (the
// input gradients against torch's [out, in] weights) and dY^T.X (a_t: the
// weight gradients, reduced over all B*S rows, written in torch's layout).
//
// Two operand modes, as the `dtype` knob of the TPU kernels:
//   bf16: A and B are bf16 in device memory. The TPU kernel's c() on every
//         product operand happens before the product: the weights are cast
//         once per layer call, an activation by round_bf16 or by the bf16
//         copy that the epilogue of the product making it writes (the same
//         round-to-nearest-even values). Hopper main loop: one producer
//         warp keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of
//         64-deep k-steps in a ring of 3 stages with full and empty
//         mbarriers; two consumer warpgroups each run wgmma.mma_async
//         m64n128k16 on 64 rows of the 128 x 128 tile, f32 accumulators in
//         registers. Each operand is loaded in its stored layout and the
//         descriptors' transpose bits pick K- or MN-major. Ragged edges
//         (rows, the K of the weight gradients) come from TMA's zero fill.
//   f32:  register-tiled SIMT FFMA (TF32 would miss the f32 mode's gate).
// Epilogue (bf16: on the tile staged in shared memory once the main loop is
// done, one rolled loop of coalesced float4 rows), in the TPU kernel's
// operation order (each optional):
//   v = acc (+ bias[n]); gelu == 1: aux[m,n] = v, v = gelu(v);
//   v = v * (mask[m,n] * inv_keep); gelu == 2: v = v * gelu'(aux[m,n]);
//   v = add[m,n] + v;  then C[m,n] = v (f32) and / or C16[m,n] = bf16(v).
// gelu is the exact-erf gelu with the Abramowitz-Stegun erf of the TPU
// kernel (rohm_tpu/ops/transformer_layer_train.py:45-67), its derivative
// with an exact exp.
//
// Replaces the dense products of rohm_tpu/ops/transformer_layer_train.py::
// _forward_body (inside _fwd_kernel and _bwd_kernel) and the weight- and
// input-gradient products of _bwd_kernel, and (round_bf16) the casts c()
// of their activation operands (:103). The TPU kernel holds a group of 8
// sequences in VMEM and sums the parameter gradients across its sequential
// grid; on the H100 each product is its own launch over all rows, and a
// weight gradient that gives too few output tiles to fill the card is split
// over K into a workspace [splits, M, N] whose slices a second kernel adds
// in a fixed order (deterministic; no atomics).
// Bound: at B*S = 9280 rows the bf16 products with an f32 result move more
// bytes (3.35 TB/s) than their operations take on the tensor cores (989
// TFLOP/s), the weight gradients the reverse; the f32 FMA units (67
// TFLOP/s) bound the f32 mode; round_bf16 is bound by its bytes.
// Shapes: any M, N, K > 0 whose contiguous dimensions (N, and K or M of the
// stored operands) are multiples of 8 (bf16: TMA's 16-byte row pitch) or 4
// (f32: 16-byte loads); the rows (B*S, any count) are free.
#include <cuda.h>  // CUtensorMap; the encoder itself comes from the driver at run time

#include "common.cuh"

namespace {

struct Epi {
  const float* bias;
  const int8_t* mask;
  float inv_keep;
  int gelu;
  float* aux;
  const float* add;
};

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  const float r = __fsub_rn(1.0f, __fmul_rn(p, expf(-__fmul_rn(ax, ax))));
  return x > 0.0f ? r : (x < 0.0f ? -r : 0.0f);
}

__device__ __forceinline__ float gelu_as(float x) {
  const float e = erf_as(__fdiv_rn(x, 1.4142135623730951f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float gelu_grad_as(float x) {
  const float e = erf_as(__fdiv_rn(x, 1.4142135623730951f));
  const float a = __fmul_rn(0.5f, __fadd_rn(1.0f, e));
  const float g = expf(__fmul_rn(__fmul_rn(-0.5f, x), x));
  return __fadd_rn(a, __fmul_rn(__fmul_rn(x, 0.3989422804014327f), g));
}

// What the epilogue of acc[m, n..n+3] reads: read-only for the launch
// (__ldg), 16-byte (4-byte for the mask) aligned since N % 4 == 0
struct EpiIn {
  float4 bias, aux, add;
  char4 keep;
};

__device__ __forceinline__ EpiIn epi_load(int m, int n, int N, const Epi& e) {
  const size_t o = (size_t)m * N + n;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  EpiIn in{z, z, z, make_char4(0, 0, 0, 0)};
  if (e.bias) in.bias = __ldg(reinterpret_cast<const float4*>(e.bias + n));
  if (e.mask) in.keep = __ldg(reinterpret_cast<const char4*>(e.mask + o));
  if (e.gelu == 2) in.aux = __ldg(reinterpret_cast<const float4*>(e.aux + o));
  if (e.add) in.add = __ldg(reinterpret_cast<const float4*>(e.add + o));
  return in;
}

__device__ __forceinline__ float epi_one(float v, float bias, float aux, float add, signed char keep,
                                         float* aux_out, const Epi& e) {
  if (e.bias) v = __fadd_rn(v, bias);
  if (e.gelu == 1) {
    *aux_out = v;
    v = gelu_as(v);
  }
  if (e.mask) v = __fmul_rn(v, keep ? e.inv_keep : 0.0f);
  if (e.gelu == 2) v = __fmul_rn(v, gelu_grad_as(aux));
  if (e.add) v = __fadd_rn(add, v);
  return v;
}

// acc[m, n..n+3] through the epilogue (gelu == 1 also writes aux there)
__device__ __forceinline__ float4 epi_apply(float4 acc, const EpiIn& in, int m, int n, int N, const Epi& e) {
  float h[4];
  const float4 v = make_float4(epi_one(acc.x, in.bias.x, in.aux.x, in.add.x, in.keep.x, h + 0, e),
                               epi_one(acc.y, in.bias.y, in.aux.y, in.add.y, in.keep.y, h + 1, e),
                               epi_one(acc.z, in.bias.z, in.aux.z, in.add.z, in.keep.z, h + 2, e),
                               epi_one(acc.w, in.bias.w, in.aux.w, in.add.w, in.keep.w, h + 3, e));
  if (e.gelu == 1) *reinterpret_cast<float4*>(e.aux + (size_t)m * N + n) = make_float4(h[0], h[1], h[2], h[3]);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, 128 x 128 tiles, 64-deep k-steps, a ring of 3 stages
// ---------------------------------------------------------------------------

constexpr int TB_M = 128, TB_N = 128, TB_K = 64, STAGES = 3;
constexpr int CONSUMERS = 256, TB_THREADS = CONSUMERS + 32;  // two warpgroups + the producer warp
constexpr int A_BYTES = TB_M * TB_K * 2, B_BYTES = TB_N * TB_K * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int HALF_BYTES = 64 * TB_K * 2;  // 64 rows (or 64 columns) of one 64-deep tile
constexpr int TILE_LD = TB_N + 8;  // f32 row pitch of the tile staged for the epilogue (68 KB)
// the ring, its 2 x STAGES mbarriers, and room to align the ring to 1024
// bytes (the 128-byte swizzle's period); 97 KB, so two blocks share an SM
constexpr size_t TB_SMEM = (size_t)STAGES * STAGE_BYTES + 16 * STAGES + 1024;
static_assert(TB_M * TILE_LD * 4 <= STAGES * STAGE_BYTES, "the epilogue's tile fits in the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// wgmma shared-memory descriptor: 128-byte swizzle; lbo is the byte stride
// between 64-element chunks along M/N of an MN-major operand (unused by a
// K-major one), sbo the stride between groups of 8 rows (of M/N when
// K-major, of K when MN-major). `addr` must sit in a 1024-aligned tile.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] += A[64x16] . B[16x128]; TA / TB: A / B MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
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

// Stage s of the ring holds A then B, each 16 KB:
//   A K-major (X [M,K]): one box of [128 rows][64 k]; warpgroup w's 64 rows
//     start at 8 KB * w;
//   A MN-major (a_t, stored [K,M]): two boxes of [64 k][64 m], one per
//     warpgroup;
//   B K-major (b_t, W [N,K]): one box of [128 n][64 k];
//   B MN-major (stored [K,N]): two boxes of [64 k][64 n], 8 KB apart (lbo).
// Each row of a box is 128 bytes, swizzled in groups of 8 rows (sbo 1 KB).
// A k16 slice starts 32 bytes further along a K-major row, 16 rows
// (2 KB) further down an MN-major box.
template <bool AT, bool BT>
__global__ void __launch_bounds__(TB_THREADS, 2) gemm_bf16_kernel(
    __grid_constant__ const CUtensorMap tma_a, __grid_constant__ const CUtensorMap tma_b,
    float* __restrict__ C, __nv_bfloat16* __restrict__ C16, int M, int N, int K, int k_chunk, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;  // full[STAGES], then empty[STAGES]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + TB_K - 1) / TB_K : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                            // the producer's arrive + the bytes
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS / 32);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        const uint32_t full = bars + 8 * s, a = ring + s * STAGE_BYTES, b = a + A_BYTES;
        if (it >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, STAGE_BYTES);
        const int k = k_begin + it * TB_K;
        if (AT) {
          tma_load(a, &tma_a, full, m0, k);
          tma_load(a + HALF_BYTES, &tma_a, full, m0 + 64, k);
        } else {
          tma_load(a, &tma_a, full, k, m0);
        }
        if (BT) {
          tma_load(b, &tma_b, full, k, n0);
        } else {
          tma_load(b, &tma_b, full, n0, k);
          tma_load(b + HALF_BYTES, &tma_b, full, n0 + 64, k);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 * wg .. of the tile
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES;
    mbar_wait(bars + 8 * s, (it / STAGES) & 1);
    const uint32_t a = ring + s * STAGE_BYTES + wg * HALF_BYTES, b = ring + s * STAGE_BYTES + A_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TB_K / 16; ++kk) {
      const uint64_t da = AT ? smem_desc(a + kk * 2048, HALF_BYTES, 1024) : smem_desc(a + kk * 32, 16, 1024);
      const uint64_t db = BT ? smem_desc(b + kk * 32, 16, 1024) : smem_desc(b + kk * 2048, HALF_BYTES, 1024);
      wgmma_128<AT ? 1 : 0, BT ? 0 : 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));  // this warp is done with stage s
  }

  // The epilogue runs on the tile staged in shared memory (the ring is free
  // once both warpgroups are done with it), as one rolled loop of float4
  // rows: coalesced loads and stores, and one copy of its code (the same
  // code unrolled over the accumulators ran from the instruction cache's
  // misses). Accumulator i of thread (warp, lane) is row
  // 16 * (warp % 4) + lane / 4 + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's 64 x 128.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  float* tile = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < TB_N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * TILE_LD + c0 + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, 256;" ::: "memory");

  float* out = C ? C + (size_t)blockIdx.z * M * N : nullptr;  // split-K: this split's slice
  const bool split = gridDim.z > 1;
#pragma unroll 1
  for (int e = tid; e < TB_M * TB_N / 4; e += CONSUMERS) {
    const int r = e / (TB_N / 4), c = (e % (TB_N / 4)) * 4;
    const int m = m0 + r, n = n0 + c;  // N % 8 == 0: n < N means n + 3 < N
    if (m >= M || n >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(tile + r * TILE_LD + c);
    if (!split) v = epi_apply(v, epi_load(m, n, N, epi), m, n, N, epi);
    const size_t o = (size_t)m * N + n;
    if (out) *reinterpret_cast<float4*>(out + o) = v;
    if (C16) *reinterpret_cast<uint2*>(C16 + o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FFMA, 128x64 block tile, 16-deep k-steps, 256 threads of 8x4
// ---------------------------------------------------------------------------

constexpr int F_M = 128, F_N = 64, F_K = 16, F_TM = 8, F_TN = 4;
constexpr int F_THREADS = (F_M / F_TM) * (F_N / F_TN);  // 256
constexpr int F_LDA = F_M + 4, F_LDB = F_N + 4;

template <bool AT, bool BT>
__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(const float* __restrict__ A,
                                                             const float* __restrict__ B,
                                                             float* __restrict__ C, int M, int N,
                                                             int K, int k_chunk, Epi epi) {
  __shared__ __align__(16) float As[F_K][F_LDA];  // k-major
  __shared__ __align__(16) float Bs[F_K][F_LDB];  // k-major

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * F_M, n0 = blockIdx.x * F_N;
  const int ty = tid / (F_N / F_TN), tx = tid % (F_N / F_TN);
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.0f;

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = k_begin; k0 < k_end; k0 += F_K) {
    if (AT) {  // stored [K][M]
      for (int c = tid; c < F_K * F_M / 4; c += F_THREADS) {
        const int r = c / (F_M / 4), col = (c % (F_M / 4)) * 4;
        const int k = k0 + r, m = m0 + col;
        *reinterpret_cast<float4*>(&As[r][col]) =
            (k < k_end && m < M) ? ld4(A + (size_t)k * M + m) : zero4;
      }
    } else {  // stored [M][K]
      for (int c = tid; c < F_M * F_K / 4; c += F_THREADS) {
        const int r = c / (F_K / 4), k4 = (c % (F_K / 4)) * 4;
        const int m = m0 + r, k = k0 + k4;
        const float4 v = (m < M && k < k_end) ? ld4(A + (size_t)m * K + k) : zero4;
        As[k4 + 0][r] = v.x;
        As[k4 + 1][r] = v.y;
        As[k4 + 2][r] = v.z;
        As[k4 + 3][r] = v.w;
      }
    }
    if (BT) {  // stored [N][K]
      for (int c = tid; c < F_N * F_K / 4; c += F_THREADS) {
        const int r = c / (F_K / 4), k4 = (c % (F_K / 4)) * 4;
        const int n = n0 + r, k = k0 + k4;
        const float4 v = (n < N && k < k_end) ? ld4(B + (size_t)n * K + k) : zero4;
        Bs[k4 + 0][r] = v.x;
        Bs[k4 + 1][r] = v.y;
        Bs[k4 + 2][r] = v.z;
        Bs[k4 + 3][r] = v.w;
      }
    } else {  // stored [K][N]
      for (int c = tid; c < F_K * F_N / 4; c += F_THREADS) {
        const int r = c / (F_N / 4), col = (c % (F_N / 4)) * 4;
        const int k = k0 + r, n = n0 + col;
        *reinterpret_cast<float4*>(&Bs[r][col]) =
            (k < k_end && n < N) ? ld4(B + (size_t)k * N + n) : zero4;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * F_TN]);
      const float a[F_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[F_TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = C + (size_t)blockIdx.z * M * N;
  const bool split = gridDim.z > 1;
  const int nb = n0 + tx * F_TN;
  if (nb >= N) return;
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int m = m0 + ty * F_TM + i;
    if (m >= M) continue;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (!split) v = epi_apply(v, epi_load(m, nb, N, epi), m, nb, N, epi);
    *reinterpret_cast<float4*>(out + (size_t)m * N + nb) = v;
  }
}

// out[i] = sum_s ws[s, i] in the order s = 0, 1, ..., then the epilogue-free
// result (split-K is used only for the plain weight-gradient products)
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                     int splits, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = ws[i];
  for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[(size_t)z * count + i]);
  out[i] = s;
}

// y = bf16(x), round to nearest even, 4 elements per thread and step
__global__ void round_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += stride) {
    const float4 v = ld4(x + 4 * i);
    *reinterpret_cast<uint2*>(y + 4 * i) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const size_t i = n / 4 * 4 + threadIdx.x;
    y[i] = __float2bfloat16_rn(x[i]);
  }
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
EncodeTiled encoder() {
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

// a row-major bf16 matrix [rows, cols], read in boxes of box_rows x 64
// columns (128 bytes, the swizzle's width); boxes past its edges read zeros
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, pitch, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool AT, bool BT>
cudaError_t launch_bf16(const void* A, const void* B, float* C, __nv_bfloat16* C16, int M, int N, int K,
                        int splits, int k_chunk, const Epi& epi, cudaStream_t s) {
  CUtensorMap ta, tb;
  const bool ok = (AT ? encode(&ta, A, K, M, 64) : encode(&ta, A, M, K, TB_M)) &&
                  (BT ? encode(&tb, B, N, K, TB_N) : encode(&tb, B, K, N, 64));
  if (!ok) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {  // 97 KB each, and as much shared memory as the SM has: two blocks share it
    cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<AT, BT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TB_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_bf16_kernel<AT, BT>, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M, splits);
  gemm_bf16_kernel<AT, BT><<<grid, TB_THREADS, TB_SMEM, s>>>(ta, tb, C, C16, M, N, K, k_chunk, epi);
  return cudaGetLastError();
}

template <bool AT, bool BT>
cudaError_t launch(bool bf16, const void* A, const void* B, float* C, __nv_bfloat16* C16, int M, int N,
                   int K, int splits, int k_chunk, const Epi& epi, cudaStream_t s) {
  if (bf16) return launch_bf16<AT, BT>(A, B, C, C16, M, N, K, splits, k_chunk, epi, s);
  const dim3 grid((N + F_N - 1) / F_N, (M + F_M - 1) / F_M, splits);
  gemm_f32_kernel<AT, BT><<<grid, F_THREADS, 0, s>>>(static_cast<const float*>(A),
                                                     static_cast<const float*>(B), C, M, N, K, k_chunk, epi);
  return cudaGetLastError();
}

}  // namespace

// A and B: bf16 (bf16 = 1) or f32. C: the f32 result; C16: its bf16 copy
// (bf16 mode only; either may be null, not both). splits > 1 (no epilogue,
// no C16): `workspace` holds [splits, M, N] f32 and each split covers
// k_chunk (a multiple of the k-step) of K.
extern "C" int rt_gemm_train(const void* A, const void* B, void* C, void* C16, int M, int N, int K,
                             int a_t, int b_t, int bf16, const void* bias, const void* mask,
                             float inv_keep, int gelu, void* aux, const void* add, int splits,
                             int k_chunk, void* workspace, void* stream) {
  // the contiguous dimension of every operand: 16-byte rows (bf16, TMA) or
  // 16-byte loads (f32)
  const int align = bf16 ? 8 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || N % align || (a_t ? M % align : K % align) || (b_t && K % align) ||
      gelu < 0 || gelu > 2)
    return (int)cudaErrorInvalidValue;
  const int step = bf16 ? TB_K : F_K;
  if (splits < 1 || k_chunk <= 0 || k_chunk % step || (long long)splits * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  if ((!C && !C16) || (C16 && !bf16)) return (int)cudaErrorInvalidValue;
  const Epi epi{static_cast<const float*>(bias), static_cast<const int8_t*>(mask), inv_keep, gelu,
                static_cast<float*>(aux), static_cast<const float*>(add)};
  const bool has_epi = bias || mask || gelu || add;
  if (splits > 1 && (has_epi || C16 || !C || !workspace)) return (int)cudaErrorInvalidValue;
  if (gelu && !aux) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(C);
  auto* dst16 = static_cast<__nv_bfloat16*>(C16);
  cudaError_t err;
  if (a_t && b_t) err = launch<true, true>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else if (a_t) err = launch<true, false>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else if (b_t) err = launch<false, true>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else err = launch<false, false>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(C), splits, count);
  return (int)cudaGetLastError();
}

// y [n] bf16 = x [n] f32 rounded to nearest even; x 16-byte aligned
extern "C" int rt_round_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (n / 4 + 255) / 256 + 1, blocks = want < 132 * 16 ? want : 132 * 16;
  round_bf16_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(y), (size_t)n);
  return (int)cudaGetLastError();
}
