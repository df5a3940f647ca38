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
// Design (the routines of layer_routines.cuh, which the whole-stack kernel
// runs too): up to S = 144 (the shipped length) one block per row item, a
// share of at least 64 query rows of one (sequence, head) (two per head at
// S = 144: 80 and 64 rows), one warp per 16-row chunk. K, the item's Q and
// V are staged in shared memory once (cp.async, K first: ~98 KB at S = 144,
// dh = 128, two blocks per SM, every item of a 32 x 4-head layer in one
// wave); scores, probs and output stay in registers on mma.sync. A longer
// sequence takes one 256-thread block per (16 queries, sequence, head),
// streams K and V through shared memory in tiles of 144 keys and sweeps
// them three times (the rows' max, their sum, then the probs and P.V).
// Bound: its bytes (qkv read once, out written once: 5.6 us per layer at
// B = 32, S = 144 on 3.35 TB/s); the tensor cores need 1.4 us for its
// 1.4 GFLOP.
#include "layer_routines.cuh"

namespace {

using rohm::attn_bf16::QC;

// blockIdx.y = b * H + h; blockIdx.x: the row item (S <= 144) or the
// 16-query chunk (TILED). DH: the row items' head width fixed at compile
// time (128, the shipped one), or 0: any.
template <bool NO_SOFTMAX, bool TILED, int DH>
__global__ void __launch_bounds__(rohm::attn_bf16::THREADS) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S, int H, int dh,
    int s_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  if (TILED) {
    rohm::attention_bf16_tiled_item<NO_SOFTMAX>(qkv, out, S, H, dh, b, h, blockIdx.x * QC, smem);
  } else {
    const int nch = rohm::attn_bf16::item_chunks(s_pad), c0 = blockIdx.x * nch;
    rohm::attention_bf16_rows<NO_SOFTMAX, DH>(qkv, out, S, H, dh, s_pad, b, h, c0 * QC,
                                              min(nch, s_pad / QC - c0), smem);
  }
}

template <bool NO_SOFTMAX>
int launch(const void* qkv, void* out, int B, int S, int H, int dh, cudaStream_t stream) {
  const int s_pad = (S + 15) / 16 * 16;
  const bool tiled = rohm::attn_bf16::tiled(s_pad);
  const size_t smem = rohm::attn_bf16::smem_bytes(s_pad, dh);
  auto kernel = tiled       ? attention_bf16_kernel<NO_SOFTMAX, true, 0>
                : dh == 128 ? attention_bf16_kernel<NO_SOFTMAX, false, 128>
                            : attention_bf16_kernel<NO_SOFTMAX, false, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiled ? s_pad / QC : rohm::attn_bf16::row_items(s_pad), B * H);
  const int threads = tiled ? rohm::attn_bf16::THREADS : 32 * rohm::attn_bf16::item_chunks(s_pad);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
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
