// quant_rows_int8: symmetric per-row int8 quantization of activations.
//   amax = max(max|x|, 1e-12); q = clip(rint(x * (127 / amax)), -127, 127);
//   scale = amax * (1/127)
// or, with a fixed scale (fixed_inv > 0, the `fixed_quant` ablation of
// scripts/bench_int8_layer.py::make_kernel, fixed_inv = 8):
//   q = clip(rint(x * fixed_inv), -127, 127); scale = 1 / fixed_inv
// Rounding is half to even (rintf, as jnp.round and torch.round), never
// roundf. The division and products are the explicitly rounded intrinsics,
// and the max does not depend on its order, so the codes and scales match
// the plain version (and rohm::quant_row, which the LayerNorm kernels and
// the whole-stack kernel run) bit for bit. Rows are `ld` elements apart, so
// a column slice of a wider buffer (the q third of a QKV buffer) is read in
// place; the codes are written dense [R, C].
//
// Replaces `_quant_rows` inside
// rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8, which
// quantizes each of the four GEMM inputs in VMEM. The int8 chain keeps three
// of them standalone (the stack's input, the attention output, h1: no block
// of the kernel making them holds a whole row); residual_layernorm writes
// the LayerNorm outputs' codes itself.
//
// Bound: memory traffic (read 2-4 bytes, write 1 byte per element). One
// warp per row, eight rows per block, no block barrier: each lane loads its
// share of the row in 16-byte vectors (8 bf16 or 4 f32; lane l takes
// vectors l, l + 32, ...), all in flight at once, into registers; max|x| by
// warp shuffles; the codes come from those registers and leave in 8- or
// 4-byte stores (256 or 128 contiguous bytes per warp and vector); lane 0
// stores the scale. A row wider than 32 x NV_MAX vectors (2048 bf16, 1024
// f32) is read in spans of that width, twice. The wrapper refuses rows whose
// start or width is not a whole number of vectors.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;   // rows per block
constexpr int NV_MAX = 8;  // 16-byte vectors a lane holds at once

__device__ __forceinline__ float elem(const uint4& v, int e, __nv_bfloat16) {
  const uint32_t w = e < 4 ? (e < 2 ? v.x : v.y) : (e < 6 ? v.z : v.w);
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ float elem(const uint4& v, int e, float) {
  return __uint_as_float(e < 2 ? (e == 0 ? v.x : v.y) : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t code(float x, float inv) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v)));
}

template <typename TX, int NV>
__global__ void __launch_bounds__(32 * WARPS) quant_rows_int8_kernel(
    const TX* __restrict__ x, int ld, int8_t* __restrict__ q, float* __restrict__ scale, int R, int C,
    float fixed_inv) {
  constexpr int E = 16 / sizeof(TX);  // elements of a 16-byte vector
  constexpr int SPAN = 32 * NV * E;  // elements of a row the warp holds at once
  const int lane = threadIdx.x % 32, row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const TX* xr = x + (size_t)row * ld;
  int8_t* qr = q + (size_t)row * C;
  uint4 v[NV];
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (32 * i + lane) * E;
      if (c < C) v[i] = __ldg(reinterpret_cast<const uint4*>(xr + c));
    }
  };

  float inv, sc;
  if (fixed_inv > 0.0f) {
    inv = fixed_inv;
    sc = __fdiv_rn(1.0f, fixed_inv);
  } else {
    float amax = 0.0f;
    for (int c0 = 0; c0 < C; c0 += SPAN) {
      load(c0);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (c0 + (32 * i + lane) * E < C)
#pragma unroll
          for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(elem(v[i], e, TX())));
    }
    amax = fmaxf(rohm::warp_max(amax), 1e-12f);
    inv = __fdiv_rn(127.0f, amax);
    sc = __fmul_rn(amax, (float)(1.0 / 127.0));
  }
  for (int c0 = 0; c0 < C; c0 += SPAN) {
    if (fixed_inv > 0.0f || C > SPAN) load(c0);  // else the row is still in registers
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (32 * i + lane) * E;
      if (c >= C) continue;
      uint32_t w[E / 4];
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        w[k] = code(elem(v[i], 4 * k, TX()), inv) | code(elem(v[i], 4 * k + 1, TX()), inv) << 8 |
               code(elem(v[i], 4 * k + 2, TX()), inv) << 16 | code(elem(v[i], 4 * k + 3, TX()), inv) << 24;
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(qr + c) = w[0];
    }
  }
  if (lane == 0) scale[row] = sc;
}

// the fewest vectors per lane that hold a row of C elements, up to NV_MAX
template <typename TX>
cudaError_t launch(const TX* x, int ld, int8_t* q, float* sc, int R, int C, float fixed_inv, cudaStream_t s) {
  const int vecs = (C / (16 / (int)sizeof(TX)) + 31) / 32;
  const dim3 grid((R + WARPS - 1) / WARPS), block(32 * WARPS);
  if (vecs <= 1)
    quant_rows_int8_kernel<TX, 1><<<grid, block, 0, s>>>(x, ld, q, sc, R, C, fixed_inv);
  else if (vecs <= 2)
    quant_rows_int8_kernel<TX, 2><<<grid, block, 0, s>>>(x, ld, q, sc, R, C, fixed_inv);
  else if (vecs <= 4)
    quant_rows_int8_kernel<TX, 4><<<grid, block, 0, s>>>(x, ld, q, sc, R, C, fixed_inv);
  else
    quant_rows_int8_kernel<TX, NV_MAX><<<grid, block, 0, s>>>(x, ld, q, sc, R, C, fixed_inv);
  return cudaGetLastError();
}

}  // namespace

// x: R rows of C elements, `ld` apart, each row's start 16-byte aligned and
// C a whole number of 16-byte vectors (8 bf16, 4 f32); q dense [R, C].
extern "C" int rt_quant_rows_int8(const void* x, int x_is_bf16, void* q, void* scale, int R,
                                  int C, int ld, float fixed_inv, void* stream) {
  const int e = x_is_bf16 ? 8 : 4;
  if (R <= 0 || C <= 0 || ld < C || fixed_inv < 0.0f || C % e || ld % e ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scale);
  if (x_is_bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), ld, qq, sc, R, C, fixed_inv, s);
  return (int)launch(static_cast<const float*>(x), ld, qq, sc, R, C, fixed_inv, s);
}
