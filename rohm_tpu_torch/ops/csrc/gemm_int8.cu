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
// H100 80GB HBM3, 700 W power limit). One block computes one 64 x 64 tile
// with `rohm::gemm_int8_tile` (layer_routines.cuh), which the whole-stack
// kernel runs too.
#include "layer_routines.cuh"

namespace {

using rohm::gemm_i8::BM;
using rohm::gemm_i8::BN;
using rohm::gemm_i8::BK;

template <int MODE>
__global__ void __launch_bounds__(rohm::GROUP) gemm_int8_kernel(
    const int8_t* __restrict__ A, const float* __restrict__ row_scale,
    const int8_t* __restrict__ W, const float* __restrict__ col_scale,
    const float* __restrict__ bias, void* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[rohm::gemm_i8::SMEM];
  rohm::gemm_int8_tile<MODE>(A, row_scale, W, col_scale, bias, C, M, N, K, blockIdx.y * BM,
                             blockIdx.x * BN, threadIdx.x, 0, smem);
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
  if (mode == 0) gemm_int8_kernel<0><<<grid, rohm::GROUP, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  else if (mode == 1) gemm_int8_kernel<1><<<grid, rohm::GROUP, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  else gemm_int8_kernel<2><<<grid, rohm::GROUP, 0, s>>>(a, rs, w, cs, b, C, M, N, K);
  return (int)cudaGetLastError();
}
