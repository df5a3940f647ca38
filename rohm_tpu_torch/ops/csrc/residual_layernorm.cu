// residual_layernorm: out = LN(a + b), writing f32, bf16 or both, with
// one of the two variances the TPU kernels use:
//   one-pass var = E[y^2] - mu^2  (`post_ln`, rohm_tpu/ops/kernel_common.py,
//                                  in _layer_kernel_bf16 and _layer_kernel_int8)
//   two-pass var = E[(y - mu)^2]  (rohm_tpu/ops/transformer_layer.py::
//                                  _layer_kernel, the f32 layer)
// The two differ by cancellation in E[y^2] - mu^2, so each layer gets the
// one its TPU kernel computes.
//
// The layer input `a` is bf16 for the first residual and f32 for the
// second; the first LN's f32 output is kept in device memory for the second
// residual while the next GEMM reads its bf16 image.
// Bound: memory traffic (one 512-wide row per block, ~6 bytes read and 2-6
// written per element); a later PR fuses it into the GEMM epilogue.
#include "common.cuh"

namespace {

template <typename TA, bool TWO_PASS>
__global__ void residual_layernorm_kernel(const TA* __restrict__ a, const float* __restrict__ b,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out_f32,
                                          __nv_bfloat16* __restrict__ out_bf16, int D, float eps) {
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * D;
  float s = 0.0f, ss = 0.0f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float y = rohm::to_f32(a[row + c]) + b[row + c];
    s += y;
    ss += y * y;
  }
  const float mu = rohm::block_sum(s, scratch) / D;
  float var;
  if (TWO_PASS) {
    float sd = 0.0f;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float y = rohm::to_f32(a[row + c]) + b[row + c] - mu;
      sd += y * y;
    }
    var = rohm::block_sum(sd, scratch) / D;
  } else {
    var = rohm::block_sum(ss, scratch) / D - mu * mu;
  }
  const float inv = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float y = rohm::to_f32(a[row + c]) + b[row + c];
    const float o = (y - mu) * inv * scale[c] + bias[c];
    if (out_f32) out_f32[row + c] = o;
    if (out_bf16) out_bf16[row + c] = __float2bfloat16_rn(o);
  }
}

}  // namespace

extern "C" int rt_residual_layernorm(const void* a, int a_is_bf16, const void* b,
                                     const void* scale, const void* bias, void* out_f32,
                                     void* out_bf16, int R, int D, float eps, int two_pass,
                                     void* stream) {
  if (R <= 0 || D <= 0 || (!out_f32 && !out_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bb = static_cast<const float*>(b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out_f32);
  auto* ob = static_cast<__nv_bfloat16*>(out_bf16);
  const auto* a16 = static_cast<const __nv_bfloat16*>(a);
  const auto* a32 = static_cast<const float*>(a);
  if (a_is_bf16 && two_pass)
    residual_layernorm_kernel<__nv_bfloat16, true><<<R, 128, 0, s>>>(a16, bb, sc, bi, of, ob, D, eps);
  else if (a_is_bf16)
    residual_layernorm_kernel<__nv_bfloat16, false><<<R, 128, 0, s>>>(a16, bb, sc, bi, of, ob, D, eps);
  else if (two_pass)
    residual_layernorm_kernel<float, true><<<R, 128, 0, s>>>(a32, bb, sc, bi, of, ob, D, eps);
  else
    residual_layernorm_kernel<float, false><<<R, 128, 0, s>>>(a32, bb, sc, bi, of, ob, D, eps);
  return (int)cudaGetLastError();
}
