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
// residual while the next GEMM reads its bf16 image. Optionally (q given)
// the kernel also writes the int8 codes and f32 scale of the row it wrote
// (of the f32 output where it writes one, else of the bf16 one): the
// `_quant_rows` of y and of the next layer's input in _layer_kernel_int8,
// which the int8 chain then needs no quant_rows_int8 launch for.
// Bound: memory traffic (one 512-wide row per 128-thread block, ~6 bytes
// read and 2-6 written per element, 1 more with the codes). The row is
// `rohm::residual_layernorm_row` and its quantization `rohm::quant_row`
// (layer_routines.cuh), run one after the other as the whole-stack
// kernel's LayerNorm phases run them: K5 stays bit for bit the chain.
#include "layer_routines.cuh"

namespace {

template <typename TA, bool TWO_PASS>
__global__ void __launch_bounds__(rohm::GROUP) residual_layernorm_kernel(
    const TA* __restrict__ a, const float* __restrict__ b, const float* __restrict__ scale,
    const float* __restrict__ bias, float* out_f32, __nv_bfloat16* out_bf16, int8_t* __restrict__ q,
    float* __restrict__ q_scale, int D, float eps) {
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * D;
  float* of = out_f32 ? out_f32 + row : nullptr;
  __nv_bfloat16* ob = out_bf16 ? out_bf16 + row : nullptr;
  rohm::residual_layernorm_row<TA, TWO_PASS>(a + row, b + row, scale, bias, of, ob, D, eps, threadIdx.x,
                                             rohm::GROUP, 0, scratch);
  // each thread reads back the columns it wrote; quant_row's first group
  // barrier keeps its scratch apart from the LayerNorm's last sum
  if (!q) return;
  if (of)
    rohm::quant_row(of, q + row, q_scale + blockIdx.x, D, 0.0f, threadIdx.x, rohm::GROUP, 0, scratch);
  else
    rohm::quant_row(ob, q + row, q_scale + blockIdx.x, D, 0.0f, threadIdx.x, rohm::GROUP, 0, scratch);
}

}  // namespace

// q [R, D] int8 and q_scale [R] f32: both null, or both given for the codes
extern "C" int rt_residual_layernorm(const void* a, int a_is_bf16, const void* b,
                                     const void* scale, const void* bias, void* out_f32,
                                     void* out_bf16, void* q, void* q_scale, int R, int D, float eps,
                                     int two_pass, void* stream) {
  if (R <= 0 || D <= 0 || (!out_f32 && !out_bf16) || (!q) != (!q_scale)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bb = static_cast<const float*>(b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out_f32);
  auto* ob = static_cast<__nv_bfloat16*>(out_bf16);
  auto* qq = static_cast<int8_t*>(q);
  auto* qs = static_cast<float*>(q_scale);
  const auto* a16 = static_cast<const __nv_bfloat16*>(a);
  const auto* a32 = static_cast<const float*>(a);
  constexpr int T = rohm::GROUP;
  if (a_is_bf16 && two_pass)
    residual_layernorm_kernel<__nv_bfloat16, true><<<R, T, 0, s>>>(a16, bb, sc, bi, of, ob, qq, qs, D, eps);
  else if (a_is_bf16)
    residual_layernorm_kernel<__nv_bfloat16, false><<<R, T, 0, s>>>(a16, bb, sc, bi, of, ob, qq, qs, D, eps);
  else if (two_pass)
    residual_layernorm_kernel<float, true><<<R, T, 0, s>>>(a32, bb, sc, bi, of, ob, qq, qs, D, eps);
  else
    residual_layernorm_kernel<float, false><<<R, T, 0, s>>>(a32, bb, sc, bi, of, ob, qq, qs, D, eps);
  return (int)cudaGetLastError();
}
