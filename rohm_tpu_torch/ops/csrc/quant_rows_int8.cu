// quant_rows_int8: symmetric per-row int8 quantization of activations.
//   amax = max(max|x|, 1e-12); q = clip(rint(x * (127 / amax)), -127, 127);
//   scale = amax * (1/127)
// Rounding is half to even (rintf, as jnp.round and torch.round), never
// roundf. The division and products are the explicitly rounded intrinsics,
// so the codes match the plain version bit for bit.
//
// Replaces `_quant_rows` inside
// rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8, which
// quantizes each of the four GEMM inputs in VMEM. Bound: memory traffic
// (one row per block: read 2-4 bytes, write 1 byte per element); a later PR
// fuses it into the epilogue of the kernel that produces its input.
#include "common.cuh"

namespace {

template <typename TX>
__global__ void quant_rows_int8_kernel(const TX* __restrict__ x, int8_t* __restrict__ q,
                                       float* __restrict__ scale, int C) {
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * C;
  float amax = 0.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) amax = fmaxf(amax, fabsf(rohm::to_f32(x[row + c])));
  amax = fmaxf(rohm::block_max(amax, scratch), 1e-12f);
  const float inv = __fdiv_rn(127.0f, amax);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = rintf(__fmul_rn(rohm::to_f32(x[row + c]), inv));
    q[row + c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = __fmul_rn(amax, (float)(1.0 / 127.0));
}

}  // namespace

extern "C" int rt_quant_rows_int8(const void* x, int x_is_bf16, void* q, void* scale, int R,
                                  int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scale);
  if (x_is_bf16)
    quant_rows_int8_kernel<<<R, 128, 0, s>>>(static_cast<const __nv_bfloat16*>(x), qq, sc, C);
  else
    quant_rows_int8_kernel<<<R, 128, 0, s>>>(static_cast<const float*>(x), qq, sc, C);
  return (int)cudaGetLastError();
}
