// gemm_bf16: C[M,N] = A[M,K] bf16 @ W[K,N] bf16, f32 accumulation, with the
// three epilogues of the bf16 encoder layer.
//
// Replaces the four dense products inside
// rohm_tpu/ops/transformer_layer_bf16.py::_layer_kernel_bf16 (the TPU kernel
// runs them on VMEM-resident tiles of one whole layer). On the H100 a layer
// does not fit in 227 KB of shared memory, so each product is its own
// launch and its epilogue is fused into it:
//   mode 0: round to bf16, then add a bf16 bias, store bf16   (QKV)
//   mode 1: add an f32 bias, store f32                        (out-proj, FF2)
//   mode 2: add an f32 bias, tanh-gelu, store bf16            (FF1)
// Design: the Hopper main loop of wgmma_gemm.cuh, which the training
// products run too (TMA ring of 3 stages, a producer warp, two consumer
// warpgroups on wgmma), A K-major and W [K, N] as stored (MN-major, as
// prepare_layer_bf16 leaves it: no weight is transposed or repacked). The
// epilogue runs on the tile staged in shared memory, one rolled loop of
// four columns per step with 16-byte (f32) or 8-byte (bf16) stores.
// Tiles: 128 x 64 up to N = 1024 (at M = 4608: 288 tiles for the
// out-projection and FF2, 576 for FF1, three 73 KB blocks per SM, 396 at
// once), 128 x 128 above (qkv: 432 tiles, two 97 KB blocks per SM, 264 at
// once). 128 x 128 would leave 144 tiles to the N = 512 products and 288,
// one wave and 24 tiles, to FF1; 128 x 64 on qkv ran 15% slower (H100).
// Bound: at the production shapes (M = 32*144 rows, K <= 1024) the four
// products take at least 22.5 us: qkv and FF1 by their operations (989
// TFLOP/s), the out-projection and FF2 by their bytes (3.35 TB/s).
#include "wgmma_gemm.cuh"

namespace {

// C[m, n..n+3] from the sums v, in the plain version's operation order
template <int MODE>
struct LayerEpilogue {
  const void* bias;
  void* C;
  int N;

  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const size_t o = (size_t)m * N + n;
    float r[4] = {v.x, v.y, v.z, v.w};
    if (MODE == 0) {
      const uint2 b2 = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(bias) + n));
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&b2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = __fadd_rn(__bfloat162float(__float2bfloat16_rn(r[i])), __bfloat162float(b[i]));
    } else {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(bias) + n));
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = MODE == 1 ? __fadd_rn(r[i], b[i]) : rohm::gelu_tanh(__fadd_rn(r[i], b[i]));
    }
    if (MODE == 1)
      *reinterpret_cast<float4*>(static_cast<float*>(C) + o) = make_float4(r[0], r[1], r[2], r[3]);
    else
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(C) + o) =
          make_uint2(rohm::pack_bf16(r[0], r[1]), rohm::pack_bf16(r[2], r[3]));
  }
};

template <int MODE>
cudaError_t launch(const void* A, const void* W, const void* bias, void* C, int M, int N, int K,
                   cudaStream_t s) {
  CUtensorMap ta, tw;
  const LayerEpilogue<MODE> epi{bias, C, N};
  if (N <= 1024) {
    if (!wg::encode_operands<false, false, 64>(&ta, &tw, A, W, M, N, K)) return cudaErrorInvalidValue;
    return wg::launch<false, false, 64>(ta, tw, M, N, K, 1, K, epi, s);
  }
  if (!wg::encode_operands<false, false, 128>(&ta, &tw, A, W, M, N, K)) return cudaErrorInvalidValue;
  return wg::launch<false, false, 128>(ta, tw, M, N, K, 1, K, epi, s);
}

}  // namespace

// Any M; N and K multiples of 8 (TMA's 16-byte row pitch); pointers 16-byte
// aligned.
extern "C" int rt_gemm_bf16(const void* A, const void* W, const void* bias, void* C, int M,
                            int N, int K, int mode, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return (int)launch<0>(A, W, bias, C, M, N, K, s);
  if (mode == 1) return (int)launch<1>(A, W, bias, C, M, N, K, s);
  return (int)launch<2>(A, W, bias, C, M, N, K, s);
}
