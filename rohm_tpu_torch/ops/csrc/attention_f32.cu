// attention_f32: per-(sequence, head) self-attention in full f32.
//
// qkv [B*S, 3D] f32, Q already multiplied by 1/sqrt(dh) (gemm_f32 mode 1)
// -> out [B*S, D] f32: scores Q.K^T, f32 softmax exp(s - max) / sum, P.V.
// The arithmetic of the attention inside
// rohm_tpu/ops/transformer_layer.py::_layer_kernel (the f32 TPU layer),
// which keeps q, k, v of one sequence in VMEM.
//
// Design: one block per (48 query rows, sequence, head), reading Q, K and V
// in place from the QKV buffer with 16-byte loads. K and V of the whole
// (sequence, head) stay in shared memory with the tile's Q and its scores:
// 204 KB at S=144 and dh=128, so the block opts in to the large dynamic
// shared memory (up to 227 KB) and one block runs per SM; 48 query rows per
// block (3 blocks per head at S=144) amortize the K and V loads. Both
// products are register-tiled: a thread accumulates 4 query rows against
// one key (4 x 128 FMAs from 5 float4 loads per 4-deep step), then 4 rows x
// 4 output columns against the probs, which are stored transposed so one
// float4 load gives a key's probs for 4 rows. Every dot product sums in the
// order d = 0, 1, ... (keys j = 0, 1, ... for P.V), as a plain loop would.
// Bound: f32 FMA issue and shared-memory bandwidth, ~1.4 GFLOP per layer at
// B=32; no tensor cores (TF32 would miss the layer's 2e-5 gate).
#include "common.cuh"

namespace {

constexpr int QT = 48;        // query rows per block
constexpr int RM = 4;         // query rows per thread in both products
constexpr int THREADS = 384;  // 12 warps

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__global__ void __launch_bounds__(THREADS) attention_f32_kernel(
    const float* __restrict__ qkv, float* __restrict__ out, int S, int H, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, row_stride = 3 * D, ldk = dh + 4, ldp = QT + 4, d4 = dh / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * QT;
  const int nq = min(QT, S - q0);
  float* Ks = smem;            // [S][dh + 4]: 8 lanes reading 8 keys hit 32 banks
  float* Vs = Ks + S * ldk;    // [S][dh]
  float* Qs = Vs + S * dh;     // [QT][dh]
  float* Pt = Qs + QT * dh;    // [S][QT + 4]: scores, then probs, key-major

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;

  for (int e = tid; e < S * d4; e += THREADS) {
    const int r = e / d4, c = (e % d4) * 4;
    st4(Ks + r * ldk + c, ld4(base + (size_t)r * row_stride + D + c));
    st4(Vs + r * dh + c, ld4(base + (size_t)r * row_stride + 2 * D + c));
  }
  for (int e = tid; e < QT * d4; e += THREADS) {
    const int r = e / d4, c = (e % d4) * 4;
    st4(Qs + r * dh + c, r < nq ? ld4(base + (size_t)(q0 + r) * row_stride + c)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
  __syncthreads();

  // scores: thread task = (4 query rows, 1 key)
  for (int t = tid; t < (QT / RM) * S; t += THREADS) {
    const int g = t / S, c = t % S;
    const float* k = Ks + c * ldk;
    const float* q = Qs + g * RM * dh;
    float acc[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i] = 0.0f;
    for (int d = 0; d < dh; d += 4) {
      const float4 kv = ld4(k + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qv = ld4(q + i * dh + d);
        acc[i] = fmaf(qv.x, kv.x, acc[i]);
        acc[i] = fmaf(qv.y, kv.y, acc[i]);
        acc[i] = fmaf(qv.z, kv.z, acc[i]);
        acc[i] = fmaf(qv.w, kv.w, acc[i]);
      }
    }
    st4(Pt + c * ldp + g * RM, make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
  __syncthreads();

  // f32 softmax per query row (one warp per row)
  for (int r = warp; r < nq; r += THREADS / 32) {
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, Pt[c * ldp + r]);
    mx = rohm::warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32) sum += expf(Pt[c * ldp + r] - mx);
    sum = rohm::warp_sum(sum);
    for (int c = lane; c < S; c += 32) Pt[c * ldp + r] = __fdiv_rn(expf(Pt[c * ldp + r] - mx), sum);
  }
  __syncthreads();

  // out = P.V: thread task = (4 query rows, 4 output columns)
  for (int t = tid; t < (QT / RM) * d4; t += THREADS) {
    const int g = t / d4, c = (t % d4) * 4;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int j = 0; j < S; ++j) {
      const float4 p = ld4(Pt + j * ldp + g * RM);
      const float4 v = ld4(Vs + j * dh + c);
      const float pr[RM] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(pr[i], v.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], v.y, acc[i][1]);
        acc[i][2] = fmaf(pr[i], v.z, acc[i][2]);
        acc[i][3] = fmaf(pr[i], v.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = g * RM + i;
      if (r < nq)
        st4(out + ((size_t)b * S + q0 + r) * D + h * dh + c,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

size_t smem_bytes(int S, int dh) {
  return sizeof(float) * ((size_t)S * (dh + 4) + (size_t)S * dh + (size_t)QT * dh +
                          (size_t)S * (QT + 4));
}

}  // namespace

// dh must be a multiple of 4; any S whose K, V and tile fit in 227 KB of
// shared memory (S <= 160 at dh=128).
extern "C" int rt_attention_f32(const void* qkv, void* out, int B, int S, int H, int dh,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QT - 1) / QT, B * H);
  attention_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, H, dh);
  return (int)cudaGetLastError();
}
