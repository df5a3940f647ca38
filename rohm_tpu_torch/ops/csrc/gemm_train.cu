// gemm_train: C[M,N] = op(A) @ op(B), f32 accumulation, f32 operands in
// device memory, with the epilogues of the PoseNet training layer.
//
//   op(A) is A [M,K] row-major, or (a_t) the transpose of A stored [K,M];
//   op(B) is B [K,N] row-major, or (b_t) the transpose of B stored [N,K]
//   (a torch Linear weight [out, in]).
// The three layouts of a training layer: X.W^T (forward, b_t), dY.W (the
// input gradients against torch's [out, in] weights) and dY^T.X (a_t: the
// weight gradients, reduced over all B*S rows, written in torch's layout).
//
// Two operand modes, as the `dtype` knob of the TPU kernels:
//   bf16: both operands are rounded to bf16 while they are staged in shared
//         memory (the TPU kernel's `c()` on every product operand, and its
//         one-time cast of the weight matrices: the same round-to-nearest-
//         even values), then WMMA 16x16x16 on the tensor cores;
//   f32:  register-tiled SIMT FFMA (TF32 would miss the f32 mode's gate).
// Epilogue, in the TPU kernel's operation order (each optional):
//   v = acc (+ bias[n]); gelu == 1: aux[m,n] = v, v = gelu(v);
//   v = v * (mask[m,n] * inv_keep); gelu == 2: v = v * gelu'(aux[m,n]);
//   v = add[m,n] + v.
// gelu is the exact-erf gelu with the Abramowitz-Stegun erf of the TPU
// kernel (rohm_tpu/ops/transformer_layer_train.py:45-67), its derivative
// with an exact exp.
//
// Replaces the dense products of rohm_tpu/ops/transformer_layer_train.py::
// _forward_body (inside _fwd_kernel and _bwd_kernel) and the weight- and
// input-gradient products of _bwd_kernel. The TPU kernel holds a group of
// 8 sequences in VMEM and sums the parameter gradients across its
// sequential grid; on the H100 each product is its own launch over all
// rows, and a weight gradient that gives too few output tiles to fill the
// card is split over K into a workspace [splits, M, N] whose slices a
// second kernel adds in a fixed order (deterministic; no atomics).
// Bound: at B*S = 9280 rows every product does >100 flops per byte, so the
// tensor cores (bf16, 989 TFLOP/s) or the f32 FMA units (67 TFLOP/s) bound
// it. This first version has no load pipelining (see PERF.md).
// Shapes: any M, N, K > 0 whose contiguous dimensions (N, and K or M of the
// stored operands) are multiples of 4, for 16-byte loads; the rows (B*S, any
// count) are free. Ragged tile edges are zero-filled on load and masked on
// store.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

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

__device__ __forceinline__ float epilogue(float v, int m, int n, int N, const Epi& e) {
  const size_t o = (size_t)m * N + n;
  if (e.bias) v = __fadd_rn(v, e.bias[n]);
  if (e.gelu == 1) {
    e.aux[o] = v;
    v = gelu_as(v);
  }
  if (e.mask) v = __fmul_rn(v, e.mask[o] ? e.inv_keep : 0.0f);
  if (e.gelu == 2) v = __fmul_rn(v, gelu_grad_as(e.aux[o]));
  if (e.add) v = __fadd_rn(e.add[o], v);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<__nv_bfloat162*>(p) = lo;
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = hi;
}

// ---------------------------------------------------------------------------
// bf16: WMMA, 64x64 block tile, 32-deep k-steps, 4 warps of 32x32
// ---------------------------------------------------------------------------

constexpr int HB_M = 64, HB_N = 64, HB_K = 32;
constexpr int HB_PAD = 8;  // bf16 elements: keeps every fragment row 32-byte aligned
constexpr int HB_LDC = HB_N + 4;

template <bool AT, bool BT>
__global__ void __launch_bounds__(128) gemm_bf16_kernel(const float* __restrict__ A,
                                                        const float* __restrict__ B,
                                                        float* __restrict__ C, int M, int N,
                                                        int K, int k_chunk, Epi epi) {
  // A tile: [BM][BK+8] (row-major) or [BK][BM+8] (AT, k-major)
  constexpr int A_ELEMS = AT ? HB_K * (HB_M + HB_PAD) : HB_M * (HB_K + HB_PAD);
  // B tile: [BK][BN+8] (row-major) or [BN][BK+8] (BT, n-major)
  constexpr int B_ELEMS = BT ? HB_N * (HB_K + HB_PAD) : HB_K * (HB_N + HB_PAD);
  __shared__ __align__(128) __nv_bfloat16 As[A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 Bs[B_ELEMS];
  __shared__ __align__(128) float Cs[HB_M * HB_LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * HB_M, n0 = blockIdx.x * HB_N;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = k_begin; k0 < k_end; k0 += HB_K) {
    if (AT) {  // stored [K][M]: read 4 consecutive m
      for (int c = tid; c < HB_K * HB_M / 4; c += 128) {
        const int r = c / (HB_M / 4), col = (c % (HB_M / 4)) * 4;
        const int k = k0 + r, m = m0 + col;
        st_bf16x4(As + r * (HB_M + HB_PAD) + col,
                  (k < k_end && m < M) ? ld4(A + (size_t)k * M + m) : zero4);
      }
    } else {  // stored [M][K]: read 4 consecutive k
      for (int c = tid; c < HB_M * HB_K / 4; c += 128) {
        const int r = c / (HB_K / 4), col = (c % (HB_K / 4)) * 4;
        const int m = m0 + r, k = k0 + col;
        st_bf16x4(As + r * (HB_K + HB_PAD) + col,
                  (m < M && k < k_end) ? ld4(A + (size_t)m * K + k) : zero4);
      }
    }
    if (BT) {  // stored [N][K]: read 4 consecutive k
      for (int c = tid; c < HB_N * HB_K / 4; c += 128) {
        const int r = c / (HB_K / 4), col = (c % (HB_K / 4)) * 4;
        const int n = n0 + r, k = k0 + col;
        st_bf16x4(Bs + r * (HB_K + HB_PAD) + col,
                  (n < N && k < k_end) ? ld4(B + (size_t)n * K + k) : zero4);
      }
    } else {  // stored [K][N]: read 4 consecutive n
      for (int c = tid; c < HB_K * HB_N / 4; c += 128) {
        const int r = c / (HB_N / 4), col = (c % (HB_N / 4)) * 4;
        const int k = k0 + r, n = n0 + col;
        st_bf16x4(Bs + r * (HB_N + HB_PAD) + col,
                  (k < k_end && n < N) ? ld4(B + (size_t)k * N + n) : zero4);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HB_K; kk += 16) {
      using ALayout = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
      using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm + i * 16;
        if (AT) wmma::load_matrix_sync(a[i], As + kk * (HB_M + HB_PAD) + row, HB_M + HB_PAD);
        else wmma::load_matrix_sync(a[i], As + row * (HB_K + HB_PAD) + kk, HB_K + HB_PAD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn + j * 16;
        if (BT) wmma::load_matrix_sync(b[j], Bs + col * (HB_K + HB_PAD) + kk, HB_K + HB_PAD);
        else wmma::load_matrix_sync(b[j], Bs + kk * (HB_N + HB_PAD) + col, HB_N + HB_PAD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * HB_LDC + wn + j * 16, acc[i][j], HB_LDC,
                              wmma::mem_row_major);
  __syncthreads();

  float* out = C + (size_t)blockIdx.z * M * N;  // split-K: this split's slice
  const bool split = gridDim.z > 1;
  for (int e = tid; e < HB_M * HB_N; e += 128) {
    const int r = e / HB_N, c = e % HB_N;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float v = Cs[r * HB_LDC + c];
    out[(size_t)m * N + n] = split ? v : epilogue(v, m, n, N, epi);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FFMA, 128x64 block tile, 16-deep k-steps, 256 threads of 8x4
// ---------------------------------------------------------------------------

constexpr int F_M = 128, F_N = 64, F_K = 16, F_TM = 8, F_TN = 4;
constexpr int F_THREADS = (F_M / F_TM) * (F_N / F_TN);  // 256
constexpr int F_LDA = F_M + 4, F_LDB = F_N + 4;

template <bool AT, bool BT>
__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(const float* __restrict__ A,
                                                             const float* __restrict__ B,
                                                             float* __restrict__ C, int M, int N,
                                                             int K, int k_chunk, Epi epi) {
  __shared__ __align__(16) float As[F_K][F_LDA];  // k-major
  __shared__ __align__(16) float Bs[F_K][F_LDB];  // k-major

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * F_M, n0 = blockIdx.x * F_N;
  const int ty = tid / (F_N / F_TN), tx = tid % (F_N / F_TN);
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.0f;

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = k_begin; k0 < k_end; k0 += F_K) {
    if (AT) {  // stored [K][M]
      for (int c = tid; c < F_K * F_M / 4; c += F_THREADS) {
        const int r = c / (F_M / 4), col = (c % (F_M / 4)) * 4;
        const int k = k0 + r, m = m0 + col;
        *reinterpret_cast<float4*>(&As[r][col]) =
            (k < k_end && m < M) ? ld4(A + (size_t)k * M + m) : zero4;
      }
    } else {  // stored [M][K]
      for (int c = tid; c < F_M * F_K / 4; c += F_THREADS) {
        const int r = c / (F_K / 4), k4 = (c % (F_K / 4)) * 4;
        const int m = m0 + r, k = k0 + k4;
        const float4 v = (m < M && k < k_end) ? ld4(A + (size_t)m * K + k) : zero4;
        As[k4 + 0][r] = v.x;
        As[k4 + 1][r] = v.y;
        As[k4 + 2][r] = v.z;
        As[k4 + 3][r] = v.w;
      }
    }
    if (BT) {  // stored [N][K]
      for (int c = tid; c < F_N * F_K / 4; c += F_THREADS) {
        const int r = c / (F_K / 4), k4 = (c % (F_K / 4)) * 4;
        const int n = n0 + r, k = k0 + k4;
        const float4 v = (n < N && k < k_end) ? ld4(B + (size_t)n * K + k) : zero4;
        Bs[k4 + 0][r] = v.x;
        Bs[k4 + 1][r] = v.y;
        Bs[k4 + 2][r] = v.z;
        Bs[k4 + 3][r] = v.w;
      }
    } else {  // stored [K][N]
      for (int c = tid; c < F_K * F_N / 4; c += F_THREADS) {
        const int r = c / (F_N / 4), col = (c % (F_N / 4)) * 4;
        const int k = k0 + r, n = n0 + col;
        *reinterpret_cast<float4*>(&Bs[r][col]) =
            (k < k_end && n < N) ? ld4(B + (size_t)k * N + n) : zero4;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * F_TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * F_TN]);
      const float a[F_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[F_TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = C + (size_t)blockIdx.z * M * N;
  const bool split = gridDim.z > 1;
  const int nb = n0 + tx * F_TN;
  if (nb >= N) return;
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int m = m0 + ty * F_TM + i;
    if (m >= M) continue;
    float o[F_TN];
#pragma unroll
    for (int j = 0; j < F_TN; ++j) o[j] = split ? acc[i][j] : epilogue(acc[i][j], m, nb + j, N, epi);
    *reinterpret_cast<float4*>(out + (size_t)m * N + nb) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

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

template <bool AT, bool BT>
cudaError_t launch(bool bf16, const float* A, const float* B, float* C, int M, int N, int K,
                   int splits, int k_chunk, const Epi& epi, cudaStream_t s) {
  if (bf16) {
    const dim3 grid((N + HB_N - 1) / HB_N, (M + HB_M - 1) / HB_M, splits);
    gemm_bf16_kernel<AT, BT><<<grid, 128, 0, s>>>(A, B, C, M, N, K, k_chunk, epi);
  } else {
    const dim3 grid((N + F_N - 1) / F_N, (M + F_M - 1) / F_M, splits);
    gemm_f32_kernel<AT, BT><<<grid, F_THREADS, 0, s>>>(A, B, C, M, N, K, k_chunk, epi);
  }
  return cudaGetLastError();
}

}  // namespace

// splits > 1 (no epilogue allowed): `workspace` holds [splits, M, N] f32 and
// each split covers k_chunk (a multiple of the k-step) of K.
extern "C" int rt_gemm_train(const void* A, const void* B, void* C, int M, int N, int K, int a_t,
                             int b_t, int bf16, const void* bias, const void* mask,
                             float inv_keep, int gelu, void* aux, const void* add, int splits,
                             int k_chunk, void* workspace, void* stream) {
  // the contiguous dimension of every operand is read 4 floats at a time
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || (a_t ? M % 4 : K % 4) || (b_t && K % 4) || gelu < 0 ||
      gelu > 2)
    return (int)cudaErrorInvalidValue;
  const int step = bf16 ? HB_K : F_K;
  if (splits < 1 || k_chunk <= 0 || k_chunk % step || (long long)splits * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  const Epi epi{static_cast<const float*>(bias), static_cast<const int8_t*>(mask), inv_keep, gelu,
                static_cast<float*>(aux), static_cast<const float*>(add)};
  const bool has_epi = bias || mask || gelu || add;
  if (splits > 1 && (has_epi || !workspace)) return (int)cudaErrorInvalidValue;
  if (gelu && !aux) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(B);
  float* dst = splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(C);
  cudaError_t err;
  if (a_t && b_t) err = launch<true, true>(bf16, a, b, dst, M, N, K, splits, k_chunk, epi, s);
  else if (a_t) err = launch<true, false>(bf16, a, b, dst, M, N, K, splits, k_chunk, epi, s);
  else if (b_t) err = launch<false, true>(bf16, a, b, dst, M, N, K, splits, k_chunk, epi, s);
  else err = launch<false, false>(bf16, a, b, dst, M, N, K, splits, k_chunk, epi, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(C), splits, count);
  return (int)cudaGetLastError();
}
