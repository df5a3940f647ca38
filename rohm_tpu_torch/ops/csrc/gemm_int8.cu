// gemm_int8: W8A8 product with per-row activation and per-column weight
// scales. C = (float(A_i8 @ W_i8) * row_scale[m]) * col_scale[n] + bias[n],
// int32 accumulation, each step rounded as in the plain version.
//   mode 0: store bf16                 (QKV: cast to bf16 after the bias)
//   mode 1: store f32                  (out-proj, FF2)
//   mode 2: tanh-gelu, store f32       (FF1; the next GEMM quantizes it from f32)
//
// Replaces the four `_dot_i8` products (with their bias adds) inside
// rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8.
// Design: the Hopper main loop of wgmma_gemm.cuh on s8 operands (TMA ring
// of 3 stages, a producer warp, two consumer warpgroups; a k-step is one
// 128-byte row, 128 values deep, 4 wgmma m64nBNk32 s8 into s32 sums). wgmma
// takes 8-bit operands only K-major, so W is stored [N, K]: the caller's
// [K, N] weight is the .t() view of it (prepare_layer_int8 makes it so).
// The epilogue runs on the tile staged in shared memory, one rolled loop of
// four columns per step, each output finished by rohm::Int8Epilogue
// (layer_routines.cuh), which the whole-stack kernel's GEMM phases run on
// the same main loop: the int32 sums are exact, so the two agree bit for
// bit. Tiles: 128 x 128 above N = WIDE_ABOVE (qkv: at M = 4608, 432 tiles,
// two 97 KB blocks per SM), 128 x NARROW_BN up to it (the out-projection
// and FF2, 288 tiles, and FF1, 576; three 73 KB blocks per SM). K is 512 or
// 1024: 4 or 8 k-steps, so a tile's loads barely overlap its own epilogue
// and the narrow tiles' extra blocks win: on an H100 80GB HBM3 at 700 W
// (ab_train_kernels.py), 128-wide tiles took 0.0130, 0.0243 and 0.0150 ms
// for the out-projection, FF1 and FF2 against 0.0107, 0.0197 and 0.0125.
// Bound: at the production shapes the four products move 65.9 MB (each
// input read once, each output written once; the f32 and bf16 outputs are
// 55 MB of it), 19.7 us at 3.35 TB/s, and do 19.3 GOP, 9.8 us at the int8
// peak (1979 TOP/s): bytes.
#include "layer_routines.cuh"
#include "wgmma_gemm.cuh"

namespace {

// the tile width: 128 for N above WIDE_ABOVE, NARROW_BN up to it
constexpr int NARROW_BN = 64, WIDE_ABOVE = 1024;

template <int MODE, int BN>
cudaError_t launch_tiles(const void* A, const void* row_scale, const void* W, const void* col_scale, const void* bias,
                   void* C, int M, int N, int K, cudaStream_t s) {
  CUtensorMap ta, tw;
  if (!wg::encode_operands<false, true, BN, wg::S8>(&ta, &tw, A, W, M, N, K)) return cudaErrorInvalidValue;
  const rohm::Int8Epilogue<MODE, true> epi{static_cast<const float*>(row_scale),
                                           static_cast<const float*>(col_scale), static_cast<const float*>(bias), C,
                                           N};
  return wg::launch<false, true, BN, wg::S8>(ta, tw, M, N, K, 1, K, epi, s);
}

template <int MODE>
cudaError_t launch(const void* A, const void* row_scale, const void* W, const void* col_scale, const void* bias,
                   void* C, int M, int N, int K, cudaStream_t s) {
  if (N <= WIDE_ABOVE) return launch_tiles<MODE, NARROW_BN>(A, row_scale, W, col_scale, bias, C, M, N, K, s);
  return launch_tiles<MODE, 128>(A, row_scale, W, col_scale, bias, C, M, N, K, s);
}

}  // namespace

// A [M, K] int8 row-major; W int8 stored [N, K] (row n: the K codes of
// output column n); row_scale [M], col_scale [N], bias [N] f32; C [M, N].
// Any M; K a multiple of 16 (TMA's 16-byte row pitch); N a multiple of 4
// (the epilogue's four columns); pointers 16-byte aligned.
extern "C" int rt_gemm_int8(const void* A, const void* row_scale, const void* W,
                            const void* col_scale, const void* bias, void* C, int M, int N,
                            int K, int mode, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 16 != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return (int)launch<0>(A, row_scale, W, col_scale, bias, C, M, N, K, s);
  if (mode == 1) return (int)launch<1>(A, row_scale, W, col_scale, bias, C, M, N, K, s);
  return (int)launch<2>(A, row_scale, W, col_scale, bias, C, M, N, K, s);
}
