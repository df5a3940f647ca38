// attention_bf16: per-(sequence, head) self-attention on a fused QKV buffer.
//
// qkv [B*S, 3D] bf16 (the 1/sqrt(dh) scale is already folded into Q) ->
// out [B*S, D] bf16. Scores Q.K^T accumulate in f32, the softmax runs in
// f32, the probabilities round to bf16 and P.V accumulates in f32 before
// the final bf16 rounding: the arithmetic of
// rohm_tpu/ops/kernel_common.py::attention_bf16, which both TPU layer
// kernels (_layer_kernel_bf16 and _layer_kernel_int8 with qattn=False) call.
// With no_softmax the probs are bf16(scores * 0.01), the `no_softmax`
// ablation of scripts/bench_int8_layer.py::make_kernel.
//
// Design: one block per (16-query chunk, sequence, head), reading Q, K and
// V in place from the QKV buffer (`rohm::attention_bf16_item`,
// layer_routines.cuh, which the whole-stack kernel runs too). K and V
// stream through shared memory in tiles of up to 144 keys, beside the
// chunk's f32 scores, bf16 probs and f32 output tile, so any S runs. At
// S <= 144 (the shipped length) one tile holds every key: ~103 KB at
// S = 144, dh = 128, two blocks per SM; a longer sequence sweeps the key
// tiles three times (the rows' max, their sum, then the probs and P.V).
// Bound: at S=144 the work is small (~2.4 GFLOP per layer at B=32) and the
// kernel is latency-bound; the 9x reload of K/V per head comes from L2.
#include "layer_routines.cuh"

namespace {

using rohm::attn_bf16::QC;
using rohm::attn_bf16::THREADS;

template <bool NO_SOFTMAX, bool TILED>
__global__ void __launch_bounds__(THREADS) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S, int H, int dh,
    int s_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  rohm::attention_bf16_item<NO_SOFTMAX, TILED>(qkv, out, S, H, dh, s_pad, blockIdx.y / H, blockIdx.y % H,
                                               blockIdx.x * QC, smem);
}

template <bool NO_SOFTMAX>
int launch(const void* qkv, void* out, int B, int S, int H, int dh, cudaStream_t stream) {
  const int s_pad = (S + 15) / 16 * 16;
  const size_t smem = rohm::attn_bf16::smem_bytes(s_pad, dh);
  auto kernel = rohm::attn_bf16::tiled(s_pad) ? attention_bf16_kernel<NO_SOFTMAX, true>
                                              : attention_bf16_kernel<NO_SOFTMAX, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s_pad / QC, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
                                          S, H, dh, s_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// Any S; dh a multiple of 16 up to 256 (where a tile of 144 keys fits).
extern "C" int rt_attention_bf16(const void* qkv, void* out, int B, int S, int H, int dh,
                                 int no_softmax, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return no_softmax ? launch<true>(qkv, out, B, S, H, dh, s) : launch<false>(qkv, out, B, S, H, dh, s);
}
