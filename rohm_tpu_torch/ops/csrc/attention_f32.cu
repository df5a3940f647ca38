// attention_f32: per-(sequence, head) self-attention in full f32.
//
// qkv [B*S, 3D] f32, Q already multiplied by 1/sqrt(dh) (gemm_f32 mode 1)
// -> out [B*S, D] f32: scores Q.K^T, f32 softmax exp(s - max) / sum, P.V.
// The arithmetic of the attention inside
// rohm_tpu/ops/transformer_layer.py::_layer_kernel (the f32 TPU layer),
// which keeps q, k, v of one sequence in VMEM.
//
// Design (rohm::attn_simt::forward_block, attention_simt.cuh): one block
// per (48 query rows, sequence, head), reading Q, K and V in place from the
// QKV buffer with 16-byte loads; K and V stream through shared memory in
// tiles of up to 160 keys, so any S runs. Up to S = 160 (the shipped 144
// included) one tile holds every key: 204 KB of shared memory at S = 144,
// dh = 128, one block per SM, each key read once per block. A longer
// sequence sweeps the key tiles three times (the rows' max, their sum, then
// the probs and P.V), so the softmax is exact over the row, as the plain
// version's. Every dot product sums in the order d = 0, 1, ... (keys j = 0,
// 1, ... for P.V), as a plain loop would. Bound: f32 FMA issue and
// shared-memory bandwidth, ~1.4 GFLOP per layer at B = 32, S = 144; no
// tensor cores (TF32 would miss the layer's 2e-5 gate).
#include "attention_simt.cuh"

namespace {

__global__ void __launch_bounds__(rohm::attn_simt::THREADS) attention_f32_kernel(
    const float* __restrict__ qkv, float* __restrict__ out, int S, int H, int dh) {
  rohm::attn_simt::forward_block<false>(qkv, nullptr, out, S, H, dh, 1.0f, 1.0f);
}

}  // namespace

// Any S; dh a multiple of 4 up to 128.
extern "C" int rt_attention_f32(const void* qkv, void* out, int B, int S, int H, int dh,
                                void* stream) {
  using namespace rohm::attn_simt;
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 4 != 0 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QT - 1) / QT, B * H);
  attention_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, H, dh);
  return (int)cudaGetLastError();
}
