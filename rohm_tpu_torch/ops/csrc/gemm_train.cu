// gemm_train: C[M,N] = op(A) @ op(B), f32 accumulation, with the epilogues
// of the PoseNet training layer; and round_bf16, the cast that stages the
// bf16 mode's activation operands.
//
//   op(A) is A [M,K] row-major, or (a_t) the transpose of A stored [K,M];
//   op(B) is B [K,N] row-major, or (b_t) the transpose of B stored [N,K]
//   (a torch Linear weight [out, in]).
// The three layouts of a training layer: X.W^T (forward, b_t), dY.W (the
// input gradients against torch's [out, in] weights) and dY^T.X (a_t: the
// weight gradients, reduced over all B*S rows, written in torch's layout).
//
// Two operand modes, as the `dtype` knob of the TPU kernels:
//   bf16: A and B are bf16 in device memory. The TPU kernel's c() on every
//         product operand happens before the product: the weights are cast
//         once per layer call, an activation by the bf16 copy that the
//         kernel making it writes (a product's epilogue, the attention
//         backward, a LayerNorm: layernorm_train.cu) or else by round_bf16
//         (the same round-to-nearest-even values). The Hopper main loop of
//         wgmma_gemm.cuh (TMA ring, wgmma m64n128k16) on 128 x 128 tiles,
//         each operand in its stored layout. Ragged edges (rows, the K of
//         the weight gradients) come from TMA's zero fill.
//   f32:  A and B are f32. 3xTF32 on the tensor cores: the f32 main loop
//         of f32_gemm.cuh (cp.async ring, mma.sync m16n8k8 tf32, each
//         operand split into two TF32 values in registers; its header has
//         the error budget against the 2e-5 sum|a||b| gate) on 64 x 64
//         tiles, each operand in its stored layout. Ragged edges come from
//         the copies' zero fill.
// Epilogue (both modes: on the tile staged in shared memory once the main
// loop is done, one rolled loop of coalesced float4 rows), in the TPU
// kernel's operation order (each optional):
//   v = acc (+ bias[n]); gelu == 1: aux[m,n] = v, v = gelu(v);
//   v = v * (mask[m,n] * inv_keep); gelu == 2: v = v * gelu'(aux[m,n]);
//   v = add[m,n] + v;  then C[m,n] = v (f32) and / or C16[m,n] = bf16(v).
// gelu is the exact-erf gelu with the Abramowitz-Stegun erf of the TPU
// kernel (rohm_tpu/ops/transformer_layer_train.py:45-67), its derivative
// with an exact exp.
//
// Replaces the dense products of rohm_tpu/ops/transformer_layer_train.py::
// _forward_body (inside _fwd_kernel and _bwd_kernel) and the weight- and
// input-gradient products of _bwd_kernel, and (round_bf16) the casts c()
// of their activation operands (:103). The TPU kernel holds a group of 8
// sequences in VMEM and sums the parameter gradients across its sequential
// grid; on the H100 each product is its own launch over all rows, and a
// weight gradient that gives too few output tiles to fill the card is split
// over K into a workspace [splits, M, N] whose slices a second kernel adds
// in a fixed order (deterministic; no atomics).
// Bound: at B*S = 9280 rows the bf16 products with an f32 result move more
// bytes (3.35 TB/s) than their operations take on the tensor cores (989
// TFLOP/s), the weight gradients the reverse; the f32 mode is bound by its
// operations (three TF32 passes: 495 / 3 = 165 TFLOP/s); round_bf16 is
// bound by its bytes.
// Shapes: any M, N, K > 0 whose contiguous dimensions (N, and K or M of the
// stored operands) are multiples of 8 (bf16: TMA's 16-byte row pitch) or 4
// (f32: 16-byte copies); the rows (B*S, any count) are free.
#include "f32_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

struct Epi {
  const float* bias;
  const int8_t* mask;
  float inv_keep;
  int gelu;
  float* aux;
  const float* add;
};

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  const float r = __fsub_rn(1.0f, __fmul_rn(p, expf(-__fmul_rn(ax, ax))));
  return x > 0.0f ? r : (x < 0.0f ? -r : 0.0f);
}

__device__ __forceinline__ float gelu_as(float x) {
  const float e = erf_as(__fdiv_rn(x, 1.4142135623730951f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ float gelu_grad_as(float x) {
  const float e = erf_as(__fdiv_rn(x, 1.4142135623730951f));
  const float a = __fmul_rn(0.5f, __fadd_rn(1.0f, e));
  const float g = expf(__fmul_rn(__fmul_rn(-0.5f, x), x));
  return __fadd_rn(a, __fmul_rn(__fmul_rn(x, 0.3989422804014327f), g));
}

// What the epilogue of acc[m, n..n+3] reads: read-only for the launch
// (__ldg), 16-byte (4-byte for the mask) aligned since N % 4 == 0
struct EpiIn {
  float4 bias, aux, add;
  char4 keep;
};

__device__ __forceinline__ EpiIn epi_load(int m, int n, int N, const Epi& e) {
  const size_t o = (size_t)m * N + n;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  EpiIn in{z, z, z, make_char4(0, 0, 0, 0)};
  if (e.bias) in.bias = __ldg(reinterpret_cast<const float4*>(e.bias + n));
  if (e.mask) in.keep = __ldg(reinterpret_cast<const char4*>(e.mask + o));
  if (e.gelu == 2) in.aux = __ldg(reinterpret_cast<const float4*>(e.aux + o));
  if (e.add) in.add = __ldg(reinterpret_cast<const float4*>(e.add + o));
  return in;
}

__device__ __forceinline__ float epi_one(float v, float bias, float aux, float add, signed char keep,
                                         float* aux_out, const Epi& e) {
  if (e.bias) v = __fadd_rn(v, bias);
  if (e.gelu == 1) {
    *aux_out = v;
    v = gelu_as(v);
  }
  if (e.mask) v = __fmul_rn(v, keep ? e.inv_keep : 0.0f);
  if (e.gelu == 2) v = __fmul_rn(v, gelu_grad_as(aux));
  if (e.add) v = __fadd_rn(add, v);
  return v;
}

// acc[m, n..n+3] through the epilogue (gelu == 1 also writes aux there)
__device__ __forceinline__ float4 epi_apply(float4 acc, const EpiIn& in, int m, int n, int N, const Epi& e) {
  float h[4];
  const float4 v = make_float4(epi_one(acc.x, in.bias.x, in.aux.x, in.add.x, in.keep.x, h + 0, e),
                               epi_one(acc.y, in.bias.y, in.aux.y, in.add.y, in.keep.y, h + 1, e),
                               epi_one(acc.z, in.bias.z, in.aux.z, in.add.z, in.keep.z, h + 2, e),
                               epi_one(acc.w, in.bias.w, in.aux.w, in.add.w, in.keep.w, h + 3, e));
  if (e.gelu == 1) *reinterpret_cast<float4*>(e.aux + (size_t)m * N + n) = make_float4(h[0], h[1], h[2], h[3]);
  return v;
}

using rohm::ld4;

using rohm::pack_bf16;

// The products' epilogue on the main loops of wgmma_gemm.cuh (bf16) and
// f32_gemm.cuh (f32): C (f32, split > 1: this split's slice of the
// workspace) and / or C16 (bf16; null in the f32 mode)
struct TrainEpilogue {
  float* C;
  __nv_bfloat16* C16;
  int M, N;
  Epi epi;

  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    float* out = C ? C + (size_t)blockIdx.z * M * N : nullptr;
    if (gridDim.z == 1) v = epi_apply(v, epi_load(m, n, N, epi), m, n, N, epi);
    const size_t o = (size_t)m * N + n;
    if (out) *reinterpret_cast<float4*>(out + o) = v;
    if (C16) *reinterpret_cast<uint2*>(C16 + o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
};

// out[i] = sum_s ws[s, i] in the order s = 0, 1, ..., then the epilogue-free
// result (split-K is used only for the plain weight-gradient products)
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                     int splits, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = ws[i];
  for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[(size_t)z * count + i]);
  out[i] = s;
}

// y = bf16(x), round to nearest even, 8 elements per thread and step: two
// 16-byte loads, one 16-byte store; the grid fills the card (8 blocks of
// 256 threads per SM), so ~8.6 MB of loads are in flight on 132 SMs
constexpr int ROUND_THREADS = 256, ROUND_BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(ROUND_THREADS) round_bf16_kernel(const float* __restrict__ x,
                                                                  __nv_bfloat16* __restrict__ y, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 8; i += stride) {
    const float4 a = ld4(x + 8 * i), b = ld4(x + 8 * i + 4);
    *reinterpret_cast<uint4*>(y + 8 * i) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 8) {
    const size_t i = n / 8 * 8 + threadIdx.x;
    y[i] = __float2bfloat16_rn(x[i]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <bool AT, bool BT>
cudaError_t launch_bf16(const void* A, const void* B, float* C, __nv_bfloat16* C16, int M, int N, int K,
                        int splits, int k_chunk, const Epi& epi, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!wg::encode_operands<AT, BT, 128>(&ta, &tb, A, B, M, N, K)) return cudaErrorInvalidValue;
  return wg::launch<AT, BT, 128>(ta, tb, M, N, K, splits, k_chunk, TrainEpilogue{C, C16, M, N, epi}, s);
}

template <bool AT, bool BT>
cudaError_t launch(bool bf16, const void* A, const void* B, float* C, __nv_bfloat16* C16, int M, int N,
                   int K, int splits, int k_chunk, const Epi& epi, cudaStream_t s) {
  if (bf16) return launch_bf16<AT, BT>(A, B, C, C16, M, N, K, splits, k_chunk, epi, s);
  return f32g::launch<AT, BT>(static_cast<const float*>(A), static_cast<const float*>(B), M, N, K, splits,
                              k_chunk, TrainEpilogue{C, nullptr, M, N, epi}, s);
}

}  // namespace

// A and B: bf16 (bf16 = 1) or f32. C: the f32 result; C16: its bf16 copy
// (bf16 mode only; either may be null, not both). splits > 1 (no epilogue,
// no C16): `workspace` holds [splits, M, N] f32 and each split covers
// k_chunk (a multiple of the k-step) of K.
extern "C" int rt_gemm_train(const void* A, const void* B, void* C, void* C16, int M, int N, int K,
                             int a_t, int b_t, int bf16, const void* bias, const void* mask,
                             float inv_keep, int gelu, void* aux, const void* add, int splits,
                             int k_chunk, void* workspace, void* stream) {
  // the contiguous dimension of every operand: 16-byte rows (bf16, TMA) or
  // 16-byte copies (f32)
  const int align = bf16 ? 8 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || N % align || (a_t ? M % align : K % align) || (b_t && K % align) ||
      gelu < 0 || gelu > 2)
    return (int)cudaErrorInvalidValue;
  const int step = bf16 ? wg::TB_K : f32g::TB_K;
  if (splits < 1 || k_chunk <= 0 || k_chunk % step || (long long)splits * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  if ((!C && !C16) || (C16 && !bf16)) return (int)cudaErrorInvalidValue;
  const Epi epi{static_cast<const float*>(bias), static_cast<const int8_t*>(mask), inv_keep, gelu,
                static_cast<float*>(aux), static_cast<const float*>(add)};
  const bool has_epi = bias || mask || gelu || add;
  if (splits > 1 && (has_epi || C16 || !C || !workspace)) return (int)cudaErrorInvalidValue;
  if (gelu && !aux) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(C);
  auto* dst16 = static_cast<__nv_bfloat16*>(C16);
  cudaError_t err;
  if (a_t && b_t) err = launch<true, true>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else if (a_t) err = launch<true, false>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else if (b_t) err = launch<false, true>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  else err = launch<false, false>(bf16, A, B, dst, dst16, M, N, K, splits, k_chunk, epi, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(C), splits, count);
  return (int)cudaGetLastError();
}

// y [n] bf16 = x [n] f32 rounded to nearest even; x and y 16-byte aligned
extern "C" int rt_round_bf16(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long want = (n / 8 + ROUND_THREADS - 1) / ROUND_THREADS + 1;
  const long long full = (long long)sms * ROUND_BLOCKS_PER_SM, blocks = want < full ? want : full;
  round_bf16_kernel<<<(unsigned)blocks, ROUND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(y), (size_t)n);
  return (int)cudaGetLastError();
}
