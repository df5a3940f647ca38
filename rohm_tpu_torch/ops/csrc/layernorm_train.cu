// layernorm_train: the training layer's residual + one-pass LayerNorm, and
// its backward, one block per row of width D.
//
// Forward (rohm_tpu/ops/transformer_layer_train.py::_ln_fwd, :70-75):
//   r = a + b;  mu = mean(r);  var = mean(r * r) - mu * mu;
//   rstd = rsqrt(var + eps);  norm = (r - mu) * rstd;  y = norm * gamma + beta
// writing y, norm [R, D] and rstd [R] (the backward's inputs), and, where
// asked, y16 = bf16(y) (the bf16 training mode's operand of FF1).
// Backward (_ln_bwd, :78-84), for y = norm * gamma + beta:
//   gdy = dy * gamma;  dr = (gdy - mean(gdy) - norm * mean(gdy * norm)) * rstd
// and, with a mask, also dr * (mask * inv_keep): the gradient into the
// dropout-ed branch of the residual (df, do in the TPU kernel), and where
// asked its bf16 copy (the bf16 mode's operand of the next products).
// Each bf16 copy is __float2bfloat16_rn of the very f32 value stored:
// round_bf16 of that output, bit for bit, without a launch of its own.
// The column sums that give dgamma and dbeta are colsum.cu's.
//
// Replaces the LayerNorms of _forward_body and _bwd_kernel (K6, K7). This
// is not residual_layernorm.cu: that kernel serves the inference layers
// (K1-K3) and writes neither norm nor rstd.
// Bound: memory traffic (one 512-wide row per block: 8 bytes read and 8
// written per element forward, 12-13 read and 4-8 written backward; 2
// more written for a bf16 copy).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) ln_fwd_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ y, float* __restrict__ norm,
    float* __restrict__ rstd, __nv_bfloat16* __restrict__ y16, int D, float eps) {
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * D;
  float s = 0.0f, ss = 0.0f;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float r = __fadd_rn(a[row + c], b[row + c]);
    s += r;
    ss = fmaf(r, r, ss);
  }
  const float mu = __fdiv_rn(rohm::block_sum(s, scratch), (float)D);
  const float ex2 = __fdiv_rn(rohm::block_sum(ss, scratch), (float)D);
  const float inv = rsqrtf(__fadd_rn(__fsub_rn(ex2, __fmul_rn(mu, mu)), eps));
  if (threadIdx.x == 0) rstd[blockIdx.x] = inv;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float r = __fadd_rn(a[row + c], b[row + c]);
    const float n = __fmul_rn(__fsub_rn(r, mu), inv);
    const float v = __fadd_rn(__fmul_rn(n, gamma[c]), beta[c]);
    norm[row + c] = n;
    y[row + c] = v;
    if (y16) y16[row + c] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(THREADS) ln_bwd_kernel(
    const float* __restrict__ dy, const float* __restrict__ norm, const float* __restrict__ rstd,
    const float* __restrict__ gamma, const int8_t* __restrict__ mask, float inv_keep,
    float* __restrict__ dr, float* __restrict__ dr_masked, __nv_bfloat16* __restrict__ dr_masked16, int D) {
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float g = __fmul_rn(dy[row + c], gamma[c]);
    s1 += g;
    s2 = fmaf(g, norm[row + c], s2);
  }
  const float m1 = __fdiv_rn(rohm::block_sum(s1, scratch), (float)D);
  const float m2 = __fdiv_rn(rohm::block_sum(s2, scratch), (float)D);
  const float inv = rstd[blockIdx.x];
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float g = __fmul_rn(dy[row + c], gamma[c]);
    const float n = norm[row + c];
    const float v = __fmul_rn(__fsub_rn(__fsub_rn(g, m1), __fmul_rn(n, m2)), inv);
    dr[row + c] = v;
    if (dr_masked) {
      const float vm = __fmul_rn(v, mask[row + c] ? inv_keep : 0.0f);
      dr_masked[row + c] = vm;
      if (dr_masked16) dr_masked16[row + c] = __float2bfloat16_rn(vm);
    }
  }
}

}  // namespace

// y16: null, or [R, D] bf16
extern "C" int rt_layernorm_train_fwd(const void* a, const void* b, const void* gamma,
                                      const void* beta, void* y, void* norm, void* rstd, void* y16,
                                      int R, int D, float eps, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  ln_fwd_kernel<<<R, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(y),
      static_cast<float*>(norm), static_cast<float*>(rstd), static_cast<__nv_bfloat16*>(y16), D, eps);
  return (int)cudaGetLastError();
}

// mask and dr_masked: both null, or both given ([R, D] int8 and f32);
// dr_masked16: null, or [R, D] bf16 beside dr_masked
extern "C" int rt_layernorm_train_bwd(const void* dy, const void* norm, const void* rstd,
                                      const void* gamma, const void* mask, float inv_keep, void* dr,
                                      void* dr_masked, void* dr_masked16, int R, int D, void* stream) {
  if (R <= 0 || D <= 0 || (!mask) != (!dr_masked) || (dr_masked16 && !dr_masked))
    return (int)cudaErrorInvalidValue;
  ln_bwd_kernel<<<R, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(norm),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const int8_t*>(mask), inv_keep, static_cast<float*>(dr),
      static_cast<float*>(dr_masked), static_cast<__nv_bfloat16*>(dr_masked16), D);
  return (int)cudaGetLastError();
}
