// gemm_f32: C = A @ W^T + bias in full f32, with a fused epilogue.
//   A [M, K] f32 row-major; W [N, K] f32 row-major (a torch Linear weight,
//   [out, in], read as it is: the f32 layer takes the raw weights).
//   mode 0: + bias
//   mode 1: + bias, then * scale for the columns n < scale_cols (the Q part
//           of the fused QKV product: the TPU kernel multiplies q by
//           1/sqrt(dh) AFTER its bias, so the scale is not folded into Wq)
//   mode 2: + bias, then exact-erf gelu 0.5*v*(1 + erf(v/sqrt(2)))
//
// Replaces the dense products of rohm_tpu/ops/transformer_layer.py::
// _layer_kernel (the separate Q/K/V products run as one [D, 3D] product:
// each output column is the same dot product). The TPU kernel's own gate
// against flax is 2e-5 absolute, and TF32 keeps ~3 decimal digits, so the
// products accumulate in f32 with FFMA on the SIMT cores, not on the tensor
// cores. Bound: f32 FMA throughput (67 TFLOP/s peak on an H100 SXM).
// Design: register tiling, 128x64 output tile per 256-thread block, each
// thread 8x4 outputs, 16-deep k-steps staged in shared memory transposed
// (k-major) so the inner loop reads 8 A and 4 W values as float4 for 32
// FMAs. No load pipelining yet.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int LDA = BM + 4, LDW = BN + 4;       // padded: 2-way store conflicts at most

__device__ __forceinline__ float gelu_erf(float x) {
  const float e = erff(__fmul_rn(x, 0.7071067811865476f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
    float* __restrict__ C, int M, int N, int K, float scale, int scale_cols) {
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Ws[BK][LDW];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), k4 = (c % (BK / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + r < M) v = *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k0 + k4);
      As[k4 + 0][r] = v.x;
      As[k4 + 1][r] = v.y;
      As[k4 + 2][r] = v.z;
      As[k4 + 3][r] = v.w;
    }
    for (int c = tid; c < BN * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), k4 = (c % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(W + (size_t)(n0 + r) * K + k0 + k4);
      Ws[k4 + 0][r] = v.x;
      Ws[k4 + 1][r] = v.y;
      Ws[k4 + 2][r] = v.z;
      Ws[k4 + 3][r] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[k][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int nb = n0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    float o[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = __fadd_rn(acc[i][j], bias[nb + j]);
      if (MODE == 1 && nb + j < scale_cols) v = __fmul_rn(v, scale);
      if (MODE == 2) v = gelu_erf(v);
      o[j] = v;
    }
    *reinterpret_cast<float4*>(C + (size_t)m * N + nb) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// N must be a multiple of 64 and K of 16; pointers 16-byte aligned.
extern "C" int rt_gemm_f32(const void* A, const void* W, const void* bias, void* C, int M, int N,
                           int K, int mode, float scale, int scale_cols, void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0 || K <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W);
  const auto* b = static_cast<const float*>(bias);
  auto* c = static_cast<float*>(C);
  if (mode == 0) gemm_f32_kernel<0><<<grid, THREADS, 0, s>>>(a, w, b, c, M, N, K, scale, scale_cols);
  else if (mode == 1) gemm_f32_kernel<1><<<grid, THREADS, 0, s>>>(a, w, b, c, M, N, K, scale, scale_cols);
  else gemm_f32_kernel<2><<<grid, THREADS, 0, s>>>(a, w, b, c, M, N, K, scale, scale_cols);
  return (int)cudaGetLastError();
}
