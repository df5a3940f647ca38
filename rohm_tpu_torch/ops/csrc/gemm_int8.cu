// gemm_int8: W8A8 product with per-row activation and per-column weight
// scales. C = (float(A_i8 @ W_i8) * row_scale[m]) * col_scale[n] + bias[n],
// int32 accumulation, each step rounded as in the plain version.
//   mode 0: store bf16                 (QKV: cast to bf16 after the bias)
//   mode 1: store f32                  (out-proj, FF2)
//   mode 2: tanh-gelu, store f32       (FF1; the next GEMM quantizes it from f32)
//
// Replaces the four `_dot_i8` products (with their bias adds) inside
// rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8. Bound:
// tensor-core int8 throughput at the production shapes in principle; this
// first version uses WMMA 16x16x16 s8 tiles with no load pipelining, waits
// on its global loads and reaches ~71 TOP/s, 3.6% of the int8 peak (NVIDIA
// H100 80GB HBM3, 700 W power limit). WMMA wants 256-bit
// aligned fragment pointers, which 16-byte k-steps of int8 rows cannot give
// in a plain row-major tile, so the tiles are kept in shared memory as
// 16-byte-wide panels: A as [k-half][row][16], W as [n-panel][k][16].
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDC = BN + 4;

template <int MODE>
__global__ void __launch_bounds__(128) gemm_int8_kernel(
    const int8_t* __restrict__ A, const float* __restrict__ row_scale,
    const int8_t* __restrict__ W, const float* __restrict__ col_scale,
    const float* __restrict__ bias, void* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) int8_t As[BK / 16][BM][16];
  __shared__ __align__(128) int8_t Bs[BN / 16][BK][16];
  __shared__ __align__(128) int Cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * (BK / 16); c += blockDim.x) {
      const int r = c / (BK / 16), h = c % (BK / 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + h * 16);
      *reinterpret_cast<uint4*>(&As[h][r][0]) = v;
    }
    for (int c = tid; c < BK * (BN / 16); c += blockDim.x) {
      const int kr = c / (BN / 16), p = c % (BN / 16);
      *reinterpret_cast<uint4*>(&Bs[p][kr][0]) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kr) * N + n0 + p * 16);
    }
    __syncthreads();
    for (int kh = 0; kh < BK / 16; ++kh) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(&As[kh][wm + i * 16][0]), 16);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const signed char*>(&Bs[(wn + j * 16) / 16][kh * 16][0]), 16);
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
    float v = __fmul_rn(__fmul_rn((float)Cs[r * LDC + c], row_scale[m]), col_scale[n]);
    v = __fadd_rn(v, bias[n]);
    const size_t o = (size_t)m * N + n;
    if (MODE == 0) static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(v);
    else if (MODE == 1) static_cast<float*>(C)[o] = v;
    else static_cast<float*>(C)[o] = rohm::gelu_tanh(v);
  }
}

}  // namespace

// N must be a multiple of 64 and K of 32; pointers 16-byte aligned.
extern "C" int rt_gemm_int8(const void* A, const void* row_scale, const void* W,
                            const void* col_scale, const void* bias, void* C, int M, int N,
                            int K, int mode, void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* w = static_cast<const int8_t*>(W);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* cs = static_cast<const float*>(col_scale);
  const auto* b = static_cast<const float*>(bias);
  if (mode == 0) gemm_int8_kernel<0><<<grid, 128, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  else if (mode == 1) gemm_int8_kernel<1><<<grid, 128, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  else gemm_int8_kernel<2><<<grid, 128, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  return (int)cudaGetLastError();
}
