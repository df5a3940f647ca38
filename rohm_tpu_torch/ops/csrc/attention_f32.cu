// attention_f32: per-(sequence, head) self-attention in full f32.
//
// qkv [B*S, 3D] f32, Q already multiplied by 1/sqrt(dh) (gemm_f32 mode 1)
// -> out [B*S, D] f32: scores Q.K^T, f32 softmax exp(s - max) / sum, P.V.
// The arithmetic of the attention inside
// rohm_tpu/ops/transformer_layer.py::_layer_kernel (the f32 TPU layer),
// which keeps q, k, v of one sequence in VMEM.
//
// Design (rohm::attn_tf32::forward_block, attention_tf32.cuh): both
// products on the tensor cores as 3xTF32 (mma.sync m16n8k8, each operand
// split into two TF32 halves, three products, a partial sum per 32-deep
// k-step), which keeps f32 accuracy (one TF32 pass would miss the layer's
// 1e-5 gate). Up to S = 160 (the shipped 144 included) one block per
// (sequence, head) stages K and V once (cp.async, 152 KB at S = 144,
// dh = 128: one block per SM, the 128 pairs of a 32-sequence batch in one
// wave), and its 5 warps take the 16-row tiles in turn, each keeping a
// 16 x 160 score tile in registers; the probs pass from the first
// product's accumulators to the second's A fragments in place. A longer
// sequence takes one block per (160 query rows, sequence, head) and three
// sweeps over 160-key tiles (the rows' max, their sum, then the probs and
// P.V), so the softmax is exact over the row, as the plain version's.
// Bound: its bytes (qkv read once, out written once: 11 us per layer at
// B = 32, S = 144 on 3.35 TB/s); 3 x 1.4 GFLOP of TF32 products.
#include "attention_tf32.cuh"

namespace {

template <bool TILED>
__global__ void __launch_bounds__(TILED ? rohm::attn_tf32::TILED_THREADS : rohm::attn_tf32::THREADS, 1)
    attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int H, int dh) {
  rohm::attn_tf32::forward_block<false, TILED>(qkv, nullptr, out, S, H, dh, 1.0f, 1.0f);
}

}  // namespace

// Any S; dh a multiple of 4 up to 128.
extern "C" int rt_attention_f32(const void* qkv, void* out, int B, int S, int H, int dh,
                                void* stream) {
  using namespace rohm::attn_tf32;
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 4 != 0 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, dh, false);
  auto kernel = tiled(S) ? attention_f32_kernel<true> : attention_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid(B, S, H), tiled(S) ? TILED_THREADS : THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, H, dh);
  return (int)cudaGetLastError();
}
