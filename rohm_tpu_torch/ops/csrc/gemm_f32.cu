// gemm_f32: C = A @ W^T + bias in f32, with a fused epilogue.
//   A [M, K] f32 row-major; W [N, K] f32 row-major (a torch Linear weight,
//   [out, in]), handed over as its two TF32 halves W2 [2, N, K] =
//   (W_big, W_small), which split_tf32 makes once per weight (the wrapper
//   keeps them while the weight is unchanged).
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
// so the products run as 3xTF32 on the tensor cores: the main loop of
// f32_wgmma.cuh (a producer thread's TMA loads in a ring of shared-memory
// stages, two consumer warpgroups on wgmma m64nBNk8 tf32, A split into its
// TF32 halves in registers, W's halves loaded as they are). Error budget:
// the same products, order and partial sums as f32_gemm.cuh's mma.sync
// loop (its head has the budget): the dropped terms are <= ~3 2^-21 |a||b|
// per product, and each 32-deep k-step's partial sum is added to the
// running one rounded to nearest, within chip_smoke.py's gate of 1e-5
// max|ref| + 1e-6 against torch's f32 product. The epilogue runs on the
// tile staged in shared memory, one rolled loop of four columns per step.
// Bound: an f32-accurate product is three TF32 passes, 495 / 3 = 165
// TFLOP/s at most on an H100 SXM; at the layer's shapes (M = 32 x 144 to
// 64 x 145, K <= 1024) the four products are bound by their operations.
// Splitting W is elementwise (8 bytes written per 4 read); the old loop
// split every weight element again in every tile.
#include "f32_wgmma.cuh"

namespace {

// The loop's shape by N: 128 x 128 tiles on a persistent grid (one block
// per SM) above N = WIDE_ABOVE (qkv), 128 x NARROW_BN tiles, one per block,
// two blocks per SM, up to it (the out-projection, FF1, FF2); STAGES
// k-steps in the ring. On an H100 80GB HBM3 at 700 W, at 64 x 145 rows
// (rohm_tpu_torch/scripts/f32_gemm_variants.py measures each choice), qkv
// took 0.1261 ms on the persistent 128 x 128 grid against 0.1318 one tile
// per block and 0.1375 on 128 x 64 tiles; the other three 0.0517, 0.0987
// and 0.0955 ms on 128 x 64 tiles against 0.0540, 0.0994 and 0.0995.
constexpr int NARROW_BN = 64, WIDE_ABOVE = 1024, STAGES = 3;
constexpr bool WIDE_PERSIST = true;

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
cudaError_t launch(const float* A, const float* W2, const float* bias, float* C, int M, int N, int K, float scale,
                   int scale_cols, cudaStream_t s) {
  const LayerEpilogue<MODE> epi{bias, C, N, scale, scale_cols};
  if (N > WIDE_ABOVE) return f32g::launch<128, STAGES, WIDE_PERSIST, false>(A, W2, M, N, K, epi, s);
  return f32g::launch<NARROW_BN, STAGES, false, false>(A, W2, M, N, K, epi, s);
}

// x [n] (n % 4 == 0) -> out [2, n]: out[0] = big, out[1] = small (rohm::split)
__global__ void split_tf32_kernel(const float4* __restrict__ x, uint4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    uint4 hi, lo;
    rohm::split(v.x, hi.x, lo.x);
    rohm::split(v.y, hi.y, lo.y);
    rohm::split(v.z, hi.z, lo.z);
    rohm::split(v.w, hi.w, lo.w);
    out[i] = hi;
    out[n4 + i] = lo;
  }
}

}  // namespace

// N and K multiples of 4 (TMA's 16-byte row pitch, the epilogue's four
// columns); any M; pointers 16-byte aligned. W2: the weight's halves [2, N, K].
extern "C" int rt_gemm_f32(const void* A, const void* W2, const void* bias, void* C, int M, int N, int K, int mode,
                           float scale, int scale_cols, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 4 != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(W2);
  const auto* b = static_cast<const float*>(bias);
  auto* c = static_cast<float*>(C);
  if (mode == 0) return (int)launch<0>(a, w, b, c, M, N, K, scale, scale_cols, s);
  if (mode == 1) return (int)launch<1>(a, w, b, c, M, N, K, scale, scale_cols, s);
  return (int)launch<2>(a, w, b, c, M, N, K, scale, scale_cols, s);
}

// x [n] f32 -> out [2, n]: its TF32 halves, big then small. n a multiple of
// 4; pointers 16-byte aligned.
extern "C" int rt_split_tf32(const void* x, void* out, long long n, void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const int blocks = (int)(n4 < 132 * 8 * 256 ? (n4 + 255) / 256 : 132 * 8);
  split_tf32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(x),
                                                                           static_cast<uint4*>(out), n4);
  return (int)cudaGetLastError();
}
