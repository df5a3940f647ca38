// gemm_bf16: C[M,N] = A[M,K] bf16 @ W[K,N] bf16, f32 accumulation, with the
// three epilogues of the bf16 encoder layer.
//
// Replaces the four dense products inside
// rohm_tpu/ops/transformer_layer_bf16.py::_layer_kernel_bf16 (the TPU kernel
// runs them on VMEM-resident tiles of one whole layer). On the H100 a layer
// does not fit in 227 KB of shared memory, so each product is its own
// launch and its epilogue is fused into it:
//   mode 0: round to bf16, then add a bf16 bias, store bf16   (QKV)
//   mode 1: add an f32 bias, store f32                        (out-proj, FF2)
//   mode 2: add an f32 bias, tanh-gelu, store bf16            (FF1)
// Bound: at the production shapes (M = 32*144 rows, K <= 1024) these GEMMs
// do ~100-300 flops per byte of device memory, so the tensor cores should
// bound them. This first version is WMMA 16x16x16 from a 64x64 block tile
// through shared memory with no load pipelining, so each k-step waits on
// its global loads: it reaches ~74 TFLOP/s, 7.5% of the bf16 peak (NVIDIA
// H100 80GB HBM3, 700 W power limit). wgmma and TMA are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;  // padded strides

template <int MODE>
__global__ void __launch_bounds__(128) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    const void* __restrict__ bias, void* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += blockDim.x) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + col);
      *reinterpret_cast<uint4*>(As + r * LDA + col) = v;
    }
    for (int c = tid; c < BK * BN / 8; c += blockDim.x) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDB + col) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + col);
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + j * 16, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += blockDim.x) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    const float v = Cs[r * LDC + c];
    const size_t o = (size_t)m * N + n;
    if (MODE == 0) {
      const float rounded = __bfloat162float(__float2bfloat16_rn(v));
      const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
      static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(__fadd_rn(rounded, b));
    } else if (MODE == 1) {
      static_cast<float*>(C)[o] = __fadd_rn(v, static_cast<const float*>(bias)[n]);
    } else {
      const float h = __fadd_rn(v, static_cast<const float*>(bias)[n]);
      static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(rohm::gelu_tanh(h));
    }
  }
}

}  // namespace

// N must be a multiple of 64 and K of 32; pointers 16-byte aligned.
extern "C" int rt_gemm_bf16(const void* A, const void* W, const void* bias, void* C, int M,
                            int N, int K, int mode, void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  if (mode == 0) gemm_bf16_kernel<0><<<grid, 128, 0, s>>>(a, w, bias, C, M, N, K);
  else if (mode == 1) gemm_bf16_kernel<1><<<grid, 128, 0, s>>>(a, w, bias, C, M, N, K);
  else gemm_bf16_kernel<2><<<grid, 128, 0, s>>>(a, w, bias, C, M, N, K);
  return (int)cudaGetLastError();
}
