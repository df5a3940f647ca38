// attention_int8: fully quantized per-(sequence, head) self-attention.
//
// qkv [B*S, 3D] bf16 (the 1/sqrt(dh) scale folded into Q by the int8 QKV
// weights) -> out [B*S, D] bf16, the arithmetic of
// rohm_tpu/ops/transformer_layer_int8.py::attention_int8 (the qattn=True
// variant of _layer_kernel_int8):
//   Q, K: int8 per row over dh, amax = max(max|x|, 1e-12),
//         code = clip(rint(x * (127 / amax))), scale = amax * (1/127)
//   scores = (float(int32 Q.K^T) * rq[i]) * rk[j]; f32 softmax
//   probs -> int8 at the fixed scale 127: rint(p * 127) (p <= 1, no clip)
//   V: int8 per COLUMN over the S rows (vmax per column of the head)
//   out = bf16(float(int32 P.V) * (vmax / 16129))
// Every rounding step is the explicitly rounded intrinsic in the JAX
// order: a division 127/amax (never a reciprocal multiply), rintf (half to
// even, as jnp.round), and vmax / 16129 as a division.
//
// Design: one block per (48 query rows, sequence, head), 3 blocks per head
// at S=144. The block first stages the head's K and V (and its Q rows) as
// bf16 in shared memory with 16-byte loads, then quantizes them there: the
// whole V slab is in the block, so the per-column vmax of V is an in-block
// reduction. Both products run on the int8 tensor cores (WMMA 16x16x16 s8,
// exact int32 sums) over 8 warps. Keys pad to a multiple of 16 with zero
// codes; 16-deep k-steps need no more (S=144 stays 144). Fragments sit in
// shared memory as 16-byte-wide panels, the layout of gemm_int8.cu,
// because WMMA wants 256-bit aligned fragment pointers: K and Q as
// [dh/16][rows][16] (K read as K^T, column-major), V as [dh/16][keys][16],
// the probs as [keys/16][48][16]. Bound: latency of the quantize passes and
// the tensor-core products at S=144 (~1.8 MOP of int8 products per block);
// shared memory ~187 KB, so one block runs per SM.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 48;        // query rows per block (a multiple of 16)
constexpr int THREADS = 256;  // 8 warps

struct Layout {
  size_t kb, vb, qb, kp, vp, qp, pp, rk, rq, vs, sc, oc, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline Layout layout(int s_pad, int dh) {
  Layout l;
  size_t o = 0;
  l.kb = o; o = align128(o + sizeof(__nv_bfloat16) * s_pad * dh);
  l.vb = o; o = align128(o + sizeof(__nv_bfloat16) * s_pad * dh);
  l.qb = o; o = align128(o + sizeof(__nv_bfloat16) * QT * dh);
  l.kp = o; o = align128(o + (size_t)s_pad * dh);
  l.vp = o; o = align128(o + (size_t)s_pad * dh);
  l.qp = o; o = align128(o + (size_t)QT * dh);
  l.pp = o; o = align128(o + (size_t)QT * s_pad);
  l.rk = o; o = align128(o + sizeof(float) * s_pad);
  l.rq = o; o = align128(o + sizeof(float) * QT);
  l.vs = o; o = align128(o + sizeof(float) * dh);
  l.sc = o; o = align128(o + sizeof(int) * QT * (s_pad + 4));
  l.oc = o; o = align128(o + sizeof(int) * QT * (dh + 4));
  l.total = o;
  return l;
}

__device__ __forceinline__ int8_t code(float x, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f));
}

// One row of dh bf16 values (shared memory) -> int8 codes in a panel layout, by one warp.
__device__ __forceinline__ float quant_row(const __nv_bfloat16* src, int8_t* panels, int rows,
                                           int r, int dh, int lane) {
  float amax = 0.0f;
  for (int c = lane; c < dh; c += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[c])));
  amax = fmaxf(rohm::warp_max(amax), 1e-12f);
  const float inv = __fdiv_rn(127.0f, amax);
  for (int c = lane; c < dh; c += 32)
    panels[((size_t)(c / 16) * rows + r) * 16 + c % 16] = code(__bfloat162float(src[c]), inv);
  return __fmul_rn(amax, (float)(1.0 / 127.0));
}

__global__ void __launch_bounds__(THREADS) attention_int8_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S, int H,
    int dh, int s_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(s_pad, dh);
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem + L.kb);  // [S][dh] staged
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(smem + L.vb);  // [S][dh] staged
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem + L.qb);  // [QT][dh] staged
  int8_t* Kp = reinterpret_cast<int8_t*>(smem + L.kp);  // [dh/16][s_pad][16]
  int8_t* Vp = reinterpret_cast<int8_t*>(smem + L.vp);  // [dh/16][s_pad][16]
  int8_t* Qp = reinterpret_cast<int8_t*>(smem + L.qp);  // [dh/16][QT][16]
  int8_t* Pp = reinterpret_cast<int8_t*>(smem + L.pp);  // [s_pad/16][QT][16]
  float* rk = reinterpret_cast<float*>(smem + L.rk);
  float* rq = reinterpret_cast<float*>(smem + L.rq);
  float* vscale = reinterpret_cast<float*>(smem + L.vs);
  int* Sc = reinterpret_cast<int*>(smem + L.sc);  // [QT][s_pad + 4]
  int* Oc = reinterpret_cast<int*>(smem + L.oc);  // [QT][dh + 4]
  const int lds = s_pad + 4, ldo = dh + 4;

  const int D = H * dh, row_stride = 3 * D, d8 = dh / 8;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * QT;
  const int nq = min(QT, S - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;

  // stage K, V and this block's Q rows as bf16 (16-byte loads)
  for (int e = tid; e < S * d8; e += THREADS) {
    const int r = e / d8, c = (e % d8) * 8;
    *reinterpret_cast<uint4*>(Kb + r * dh + c) =
        *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride + D + c);
    *reinterpret_cast<uint4*>(Vb + r * dh + c) =
        *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride + 2 * D + c);
  }
  for (int e = tid; e < nq * d8; e += THREADS) {
    const int r = e / d8, c = (e % d8) * 8;
    *reinterpret_cast<uint4*>(Qb + r * dh + c) =
        *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + c);
  }
  __syncthreads();

  // K and Q per row (one warp per row); padded rows get zero codes
  for (int r = warp; r < s_pad; r += nwarps) {
    if (r < S) {
      const float s = quant_row(Kb + r * dh, Kp, s_pad, r, dh, lane);
      if (lane == 0) rk[r] = s;
    } else {
      for (int c = lane; c < dh; c += 32) Kp[((size_t)(c / 16) * s_pad + r) * 16 + c % 16] = 0;
      if (lane == 0) rk[r] = 0.0f;
    }
  }
  for (int r = warp; r < QT; r += nwarps) {
    if (r < nq) {
      const float s = quant_row(Qb + r * dh, Qp, QT, r, dh, lane);
      if (lane == 0) rq[r] = s;
    } else {
      for (int c = lane; c < dh; c += 32) Qp[((c / 16) * QT + r) * 16 + c % 16] = 0;
      if (lane == 0) rq[r] = 0.0f;
    }
  }
  // V per column over the S rows (one thread per column)
  for (int c = tid; c < dh; c += THREADS) {
    float vmax = 0.0f;
    for (int r = 0; r < S; ++r) vmax = fmaxf(vmax, fabsf(__bfloat162float(Vb[r * dh + c])));
    vmax = fmaxf(vmax, 1e-12f);
    const float inv = __fdiv_rn(127.0f, vmax);
    int8_t* col = Vp + (size_t)(c / 16) * s_pad * 16 + c % 16;
    for (int r = 0; r < s_pad; ++r)
      col[r * 16] = r < S ? code(__bfloat162float(Vb[r * dh + c]), inv) : 0;
    vscale[c] = __fdiv_rn(vmax, 16129.0f);
  }
  __syncthreads();

  // int32 scores [QT, s_pad] = Q K^T, one 16x16 tile per warp at a time
  for (int t = warp; t < (QT / 16) * (s_pad / 16); t += nwarps) {
    const int i = t / (s_pad / 16), j = t % (s_pad / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    for (int kh = 0; kh < dh / 16; ++kh) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bk;
      wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(Qp + (kh * QT + i * 16) * 16), 16);
      wmma::load_matrix_sync(
          bk, reinterpret_cast<const signed char*>(Kp + ((size_t)kh * s_pad + j * 16) * 16), 16);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Sc + i * 16 * lds + j * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // f32 softmax over the S real keys, probs -> int8 codes (padded keys 0)
  for (int r = warp; r < QT; r += nwarps) {
    const int* srow = Sc + r * lds;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32)
      mx = fmaxf(mx, __fmul_rn(__fmul_rn((float)srow[c], rq[r]), rk[c]));
    mx = rohm::warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32)
      sum += expf(__fmul_rn(__fmul_rn((float)srow[c], rq[r]), rk[c]) - mx);
    sum = rohm::warp_sum(sum);
    for (int c = lane; c < s_pad; c += 32) {
      int8_t p = 0;
      if (c < S && r < nq) {
        const float e = expf(__fmul_rn(__fmul_rn((float)srow[c], rq[r]), rk[c]) - mx);
        p = static_cast<int8_t>(rintf(__fmul_rn(__fdiv_rn(e, sum), 127.0f)));
      }
      Pp[((c / 16) * QT + r) * 16 + c % 16] = p;
    }
  }
  __syncthreads();

  // int32 out [QT, dh] = P V
  for (int t = warp; t < (QT / 16) * (dh / 16); t += nwarps) {
    const int i = t / (dh / 16), n = t % (dh / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    for (int kh = 0; kh < s_pad / 16; ++kh) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bv;
      wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(Pp + (kh * QT + i * 16) * 16), 16);
      wmma::load_matrix_sync(
          bv, reinterpret_cast<const signed char*>(Vp + ((size_t)n * s_pad + kh * 16) * 16), 16);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Oc + i * 16 * ldo + n * 16, acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < nq * dh; e += THREADS) {
    const int r = e / dh, c = e % dh;
    out[((size_t)b * S + q0 + r) * D + h * dh + c] =
        __float2bfloat16_rn(__fmul_rn((float)Oc[r * ldo + c], vscale[c]));
  }
}

}  // namespace

// dh must be a multiple of 16; S any length whose staged and quantized K/V
// fit in 227 KB of shared memory (S <= 208 at dh=128).
extern "C" int rt_attention_int8(const void* qkv, void* out, int B, int S, int H, int dh,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  const int s_pad = (S + 15) / 16 * 16;
  const size_t smem = layout(s_pad, dh).total;
  cudaError_t err = cudaFuncSetAttribute(
      attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QT - 1) / QT, B * H);
  attention_int8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, H, dh, s_pad);
  return (int)cudaGetLastError();
}
