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

// ---------------------------------------------------------------------------
// tensor-core and copy helpers (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d[16x8] += a[16x16] . b[16x8], bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// a / b rounded to nearest, with rb = __frcp_rn(b): one correction step of
// the product with the reciprocal (Markstein), three instructions where the
// IEEE division (__fdiv_rn) takes a call; a >= 0, b >= 1, as in a softmax
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q0 = __fmul_rn(a, rb);
  return fmaf(fmaf(-q0, b, a), rb, q0);
}

// max / sum over the four lanes of a quad (one row of an mma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes from device memory to shared memory without a trip through
// registers (cp.async: every copy of a thread in flight at once), or 16
// zero bytes where !valid; cp_async_wait() before the barrier that
// publishes them
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// close this thread's group of copies; wait until at most N groups are in flight
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// n contiguous bytes from src: the 16-byte aligned interior in 16-byte
// copies (cp.async), the ragged ends byte by byte. dst (n + 16 bytes) keeps src's
// address offset mod 16, so both sides stay aligned: src[i] lands at
// dst[off + i], off returned.
__device__ __forceinline__ int copy_bytes(int8_t* dst, const int8_t* src, size_t n, int tid, int nthreads) {
  const uintptr_t m0 = reinterpret_cast<uintptr_t>(src), m1 = m0 + n;
  const uintptr_t a0 = (m0 + 15) & ~uintptr_t(15), a1 = m1 & ~uintptr_t(15);
  const int off = static_cast<int>(m0 & 15);
  if (a0 < a1) {
    for (int i = tid; i < static_cast<int>((a1 - a0) / 16); i += nthreads)
      cp_async16(dst + off + (a0 - m0) + 16 * i, reinterpret_cast<const void*>(a0 + 16 * i), true);
    if (tid < a0 - m0) dst[off + tid] = src[tid];
    if (tid < m1 - a1) dst[off + (a1 - m0) + tid] = src[(a1 - m0) + tid];
  } else {
    for (int i = tid; i < static_cast<int>(n); i += nthreads) dst[off + i] = src[i];
  }
  return off;
}

// ---------------------------------------------------------------------------
// 3xTF32 (f32_gemm.cuh and attention_tf32.cuh; the error budget is in
// f32_gemm.cuh's head)
// ---------------------------------------------------------------------------

// x = big + small: big is x rounded to TF32 (10 explicit mantissa bits) to
// nearest, ties away from zero, the same bits as cvt.rna.tf32.f32 for every
// finite x; small = x - big, exact in f32, goes to the tensor cores as it is.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// d[16x8] += a[16x8] . b[8x8], tf32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace rohm
