// quant_rows_int8: symmetric per-row int8 quantization of activations.
//   amax = max(max|x|, 1e-12); q = clip(rint(x * (127 / amax)), -127, 127);
//   scale = amax * (1/127)
// or, with a fixed scale (fixed_inv > 0, the `fixed_quant` ablation of
// scripts/bench_int8_layer.py::make_kernel, fixed_inv = 8):
//   q = clip(rint(x * fixed_inv), -127, 127); scale = 1 / fixed_inv
// Rounding is half to even (rintf, as jnp.round and torch.round), never
// roundf. The division and products are the explicitly rounded intrinsics,
// so the codes match the plain version bit for bit. Rows are `ld` elements
// apart, so a column slice of a wider buffer (the q third of a QKV buffer)
// is read in place; the codes are written dense [R, C].
//
// Replaces `_quant_rows` inside
// rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8, which
// quantizes each of the four GEMM inputs in VMEM. Bound: memory traffic
// (one row per block: read 2-4 bytes, write 1 byte per element); a later PR
// fuses it into the epilogue of the kernel that produces its input. The
// row itself is `rohm::quant_row` (layer_routines.cuh), which the
// whole-stack kernel runs too.
#include "layer_routines.cuh"

namespace {

template <typename TX>
__global__ void __launch_bounds__(rohm::GROUP) quant_rows_int8_kernel(
    const TX* __restrict__ x, int ld, int8_t* __restrict__ q, float* __restrict__ scale, int C,
    float fixed_inv) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  rohm::quant_row(x + row * ld, q + row * C, scale + row, C, fixed_inv, threadIdx.x, rohm::GROUP, 0,
                  scratch);
}

}  // namespace

extern "C" int rt_quant_rows_int8(const void* x, int x_is_bf16, void* q, void* scale, int R,
                                  int C, int ld, float fixed_inv, void* stream) {
  if (R <= 0 || C <= 0 || ld < C || fixed_inv < 0.0f) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scale);
  if (x_is_bf16)
    quant_rows_int8_kernel<<<R, rohm::GROUP, 0, s>>>(static_cast<const __nv_bfloat16*>(x), ld, qq, sc, C,
                                                     fixed_inv);
  else
    quant_rows_int8_kernel<<<R, rohm::GROUP, 0, s>>>(static_cast<const float*>(x), ld, qq, sc, C,
                                                     fixed_inv);
  return (int)cudaGetLastError();
}
