// Shared device helpers for the PoseNet encoder-layer kernels.
//
// Epilogue arithmetic uses the explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn) so nvcc cannot contract a multiply and an add into one FMA:
// each step then rounds exactly like the plain PyTorch version, which runs
// the same operations one at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rohm {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// tanh-approx gelu, 0.5*x*(1 + tanh(c*(x + 0.044715*x^3))), in the plain
// version's operation order.
__device__ __forceinline__ float gelu_tanh(float x) {
  float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(x, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = (blockDim.x + 31) / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : 0.0f;
  return warp_sum(v);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = (blockDim.x + 31) / 32;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : -INFINITY;
  return warp_max(v);
}

}  // namespace rohm
