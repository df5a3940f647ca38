// gemm_f32: C = A @ W^T + bias in f32, with a fused epilogue.
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
// against flax is 2e-5 absolute, and plain TF32 keeps ~3 decimal digits,
// so the products run as 3xTF32 on the tensor cores: the f32 main loop of
// f32_gemm.cuh (cp.async ring, mma.sync m16n8k8 tf32, each operand split
// into two TF32 values in registers; its header has the error budget),
// both operands K-major as stored. The epilogue runs on the tile staged in
// shared memory, one rolled loop of four columns per step.
// Tiles: 64 x 64 (at M = 4608: 576 tiles for the out-projection and FF2,
// 1152 for FF1, 1728 for qkv; four blocks per SM, 528 at once).
// Bound: an f32-accurate product is three TF32 passes, 495 / 3 = 165
// TFLOP/s at most on an H100 SXM; at the layer's shapes (M = 32*144,
// K <= 1024) the four products are bound by their operations.
#include "f32_gemm.cuh"

namespace {

__device__ __forceinline__ float gelu_erf(float x) {
  const float e = erff(__fmul_rn(x, 0.7071067811865476f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

// C[m, n..n+3] from the sums v, in the plain version's operation order
template <int MODE>
struct LayerEpilogue {
  const float* bias;
  float* C;
  int N;
  float scale;
  int scale_cols;

  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + n));
    float r[4] = {v.x, v.y, v.z, v.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = __fadd_rn(r[i], b[i]);
      if (MODE == 1 && n + i < scale_cols) r[i] = __fmul_rn(r[i], scale);
      if (MODE == 2) r[i] = gelu_erf(r[i]);
    }
    *reinterpret_cast<float4*>(C + (size_t)m * N + n) = make_float4(r[0], r[1], r[2], r[3]);
  }
};

template <int MODE>
cudaError_t launch(const float* A, const float* W, const float* bias, float* C, int M, int N, int K,
                   float scale, int scale_cols, cudaStream_t s) {
  const LayerEpilogue<MODE> epi{bias, C, N, scale, scale_cols};
  return f32g::launch<false, true>(A, W, M, N, K, 1, K, epi, s);
}

}  // namespace

// N and K multiples of 4 (16-byte copies); any M; pointers 16-byte aligned.
extern "C" int rt_gemm_f32(const void* A, const void* W, const void* bias, void* C, int M, int N,
                           int K, int mode, float scale, int scale_cols, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 4 != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W);
  const auto* b = static_cast<const float*>(bias);
  auto* c = static_cast<float*>(C);
  if (mode == 0) return (int)launch<0>(a, w, b, c, M, N, K, scale, scale_cols, s);
  if (mode == 1) return (int)launch<1>(a, w, b, c, M, N, K, scale, scale_cols, s);
  return (int)launch<2>(a, w, b, c, M, N, K, scale, scale_cols, s);
}
