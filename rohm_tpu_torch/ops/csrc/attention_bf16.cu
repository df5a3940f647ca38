// attention_bf16: per-(sequence, head) self-attention on a fused QKV buffer.
//
// qkv [B*S, 3D] bf16 (the 1/sqrt(dh) scale is already folded into Q) ->
// out [B*S, D] bf16. Scores Q.K^T accumulate in f32, the softmax runs in
// f32, the probabilities round to bf16 and P.V accumulates in f32 before
// the final bf16 rounding: the arithmetic of
// rohm_tpu/ops/kernel_common.py::attention_bf16, which both TPU layer
// kernels (_layer_kernel_bf16 and _layer_kernel_int8 with qattn=False) call.
//
// Design: one block per (16-query chunk, sequence, head), reading Q, K and
// V in place from the QKV buffer. K and V of the whole sequence (S padded
// to a multiple of 16) stay in shared memory with the chunk's f32 scores,
// bf16 probs and f32 output tile: ~103 KB at S=144, dh=128, so two blocks
// fit on one SM. Bound: at S=144 the work is small (~2.4 GFLOP per layer
// at B=32) and the kernel is latency-bound; the 9x reload of K/V per head
// comes from L2.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int QC = 16;       // query rows per block
constexpr int THREADS = 256;  // 8 warps

__global__ void __launch_bounds__(THREADS) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S, int H,
    int dh, int s_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * dh, row_stride = 3 * D;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * QC;
  const int ldk = dh + 8, lds = s_pad + 4, ldp = s_pad + 8, ldo = dh + 4;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + s_pad * ldk;
  __nv_bfloat16* Qs = Vs + s_pad * ldk;
  float* Ss = reinterpret_cast<float*>(Qs + QC * ldk);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + QC * lds);
  float* Os = reinterpret_cast<float*>(Ps + QC * ldp);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = dh / 8;  // 16-byte chunks per head row
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;

  for (int c = tid; c < s_pad * chunks; c += THREADS) {
    const int r = c / chunks, col = (c % chunks) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride + D + col);
      vv = *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride + 2 * D + col);
    }
    *reinterpret_cast<uint4*>(Ks + r * ldk + col) = kv;
    *reinterpret_cast<uint4*>(Vs + r * ldk + col) = vv;
  }
  for (int c = tid; c < QC * chunks; c += THREADS) {
    const int r = c / chunks, col = (c % chunks) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) qv = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(Qs + r * ldk + col) = qv;
  }
  __syncthreads();

  // scores [QC, s_pad] = Q K^T (K read column-major as K^T)
  for (int tile = warp; tile < s_pad / 16; tile += THREADS / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < dh; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + kk, ldk);
      wmma::load_matrix_sync(bk, Ks + tile * 16 * ldk + kk, ldk);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + tile * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // f32 softmax over the S real keys, probs rounded to bf16; padded keys -> 0
  for (int r = warp; r < QC; r += THREADS / 32) {
    const float* srow = Ss + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c]);
    mx = rohm::warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32) sum += expf(srow[c] - mx);
    sum = rohm::warp_sum(sum);
    for (int c = lane; c < s_pad; c += 32) {
      const float p = c < S ? __fdiv_rn(expf(srow[c] - mx), sum) : 0.0f;
      Ps[r * ldp + c] = __float2bfloat16_rn(p);
    }
  }
  __syncthreads();

  // out [QC, dh] = P V
  for (int tile = warp; tile < dh / 16; tile += THREADS / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < s_pad; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + kk, ldp);
      wmma::load_matrix_sync(bv, Vs + kk * ldk + tile * 16, ldk);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + tile * 16, acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < QC * dh; e += THREADS) {
    const int r = e / dh, c = e % dh;
    if (q0 + r < S)
      out[((size_t)b * S + q0 + r) * D + h * dh + c] = __float2bfloat16_rn(Os[r * ldo + c]);
  }
}

size_t smem_bytes(int s_pad, int dh) {
  const size_t ldk = dh + 8, lds = s_pad + 4, ldp = s_pad + 8, ldo = dh + 4;
  return 2 * (2 * s_pad * ldk + QC * ldk) + 4 * QC * lds + 2 * QC * ldp + 4 * QC * ldo;
}

}  // namespace

// dh must be a multiple of 16; S any length whose padded K/V fit in shared memory.
extern "C" int rt_attention_bf16(const void* qkv, void* out, int B, int S, int H, int dh,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  const int s_pad = (S + 15) / 16 * 16;
  const size_t smem = smem_bytes(s_pad, dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s_pad / QC, B * H);
  attention_bf16_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, H, dh, s_pad);
  return (int)cudaGetLastError();
}
