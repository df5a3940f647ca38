// Work items of the int8 encoder layer, shared by the per-layer kernels
// (gemm_int8.cu, attention_bf16.cu, quant_rows_int8.cu,
// residual_layernorm.cu) and the whole-stack kernel (encoder_stack_int8.cu).
// Both run these routines, so both do the same arithmetic in the same order
// and the stack's output is bit-identical to the per-layer chain.
//
// A routine is run by a group of threads: 128 threads (4 warps) for a GEMM
// tile or a row, the whole 256-thread block for an attention item. A
// 128-thread group synchronises on its own named barrier `bar`: barrier 0
// in the per-layer kernels, whose blocks are 128 threads, and 1 or 2 for
// the two halves of a 256-thread block in the stack kernel. The row
// reductions therefore always run over 128 threads in the same tree.
//
// Activation pointers are plain (no __restrict__, no __ldg): the stack
// kernel writes and reads its activations in one launch, where a load
// through the read-only path (ld.global.nc) could return stale data.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace rohm {

constexpr int GROUP = 128;  // threads of a GEMM tile or a row

__device__ __forceinline__ void group_sync(int bar, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
}

// Sum / max over a group of n threads (t = 0..n-1); every thread gets the
// result. `scratch` holds 32 floats. The tree of block_sum/block_max.
__device__ __forceinline__ float group_sum(float v, float* scratch, int t, int n, int bar) {
  const int lane = t % 32, warp = t / 32;
  v = warp_sum(v);
  group_sync(bar, n);
  if (lane == 0) scratch[warp] = v;
  group_sync(bar, n);
  v = lane < n / 32 ? scratch[lane] : 0.0f;
  return warp_sum(v);
}

__device__ __forceinline__ float group_max(float v, float* scratch, int t, int n, int bar) {
  const int lane = t % 32, warp = t / 32;
  v = warp_max(v);
  group_sync(bar, n);
  if (lane == 0) scratch[warp] = v;
  group_sync(bar, n);
  v = lane < n / 32 ? scratch[lane] : -INFINITY;
  return warp_max(v);
}

// ---------------------------------------------------------------------------
// one row -> int8 codes and its scale
//   dynamic (fixed_inv == 0): amax = max(max|x|, 1e-12);
//     q = clip(rint(x * (127 / amax)), -127, 127); scale = amax * (1/127)
//   fixed (fixed_inv > 0): q = clip(rint(x * fixed_inv), -127, 127);
//     scale = 1 / fixed_inv
// Rounding is half to even (rintf, as jnp.round and torch.round); the
// division and product are the explicitly rounded intrinsics.
// ---------------------------------------------------------------------------
template <typename TX>
__device__ __forceinline__ void quant_row(const TX* x, int8_t* q, float* scale, int C, float fixed_inv,
                                          int t, int n, int bar, float* scratch) {
  float inv, sc;
  if (fixed_inv > 0.0f) {
    inv = fixed_inv;
    sc = __fdiv_rn(1.0f, fixed_inv);
  } else {
    float amax = 0.0f;
    for (int c = t; c < C; c += n) amax = fmaxf(amax, fabsf(to_f32(x[c])));
    amax = fmaxf(group_max(amax, scratch, t, n, bar), 1e-12f);
    inv = __fdiv_rn(127.0f, amax);
    sc = __fmul_rn(amax, (float)(1.0 / 127.0));
  }
  for (int c = t; c < C; c += n) {
    const float v = rintf(__fmul_rn(to_f32(x[c]), inv));
    q[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (t == 0) *scale = sc;
}

// ---------------------------------------------------------------------------
// one row of LN(a + b), one-pass var = E[y^2] - mu^2 or two-pass
// var = E[(y - mu)^2], writing f32, bf16 or both (null pointers skip)
// ---------------------------------------------------------------------------
template <typename TA, bool TWO_PASS>
__device__ __forceinline__ void residual_layernorm_row(const TA* a, const float* b, const float* scale,
                                                       const float* bias, float* out_f32,
                                                       __nv_bfloat16* out_bf16, int D, float eps, int t,
                                                       int n, int bar, float* scratch) {
  float s = 0.0f, ss = 0.0f;
  for (int c = t; c < D; c += n) {
    const float y = to_f32(a[c]) + b[c];
    s += y;
    ss += y * y;
  }
  const float mu = group_sum(s, scratch, t, n, bar) / D;
  float var;
  if (TWO_PASS) {
    float sd = 0.0f;
    for (int c = t; c < D; c += n) {
      const float y = to_f32(a[c]) + b[c] - mu;
      sd += y * y;
    }
    var = group_sum(sd, scratch, t, n, bar) / D;
  } else {
    var = group_sum(ss, scratch, t, n, bar) / D - mu * mu;
  }
  const float inv = rsqrtf(var + eps);
  for (int c = t; c < D; c += n) {
    const float y = to_f32(a[c]) + b[c];
    const float o = (y - mu) * inv * scale[c] + bias[c];
    if (out_f32) out_f32[c] = o;
    if (out_bf16) out_bf16[c] = __float2bfloat16_rn(o);
  }
}

// ---------------------------------------------------------------------------
// one 64 x 64 tile of the W8A8 product, 128 threads (4 warps of 32 x 32)
//   C = (float(A_i8 @ W_i8) * row_scale[m]) * col_scale[n] + bias[n]
//   MODE 0: store bf16; 1: store f32; 2: tanh-gelu, store f32
// WMMA s8 16x16x16 tiles with int32 sums. WMMA wants 256-bit aligned
// fragment pointers, which 16-byte k-steps of int8 rows cannot give in a
// plain row-major tile, so the tiles sit in shared memory as 16-byte-wide
// panels: A as [k-half][row][16], W as [n-panel][k][16].
// ---------------------------------------------------------------------------
namespace gemm_i8 {
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDC = BN + 4;
constexpr int A_BYTES = (BK / 16) * BM * 16, B_BYTES = (BN / 16) * BK * 16;
constexpr int SMEM = A_BYTES + B_BYTES + BM * LDC * 4;  // 21504 bytes
}  // namespace gemm_i8

template <int MODE>
__device__ __forceinline__ void gemm_int8_tile(const int8_t* A, const float* row_scale, const int8_t* W,
                                               const float* col_scale, const float* bias, void* C, int M,
                                               int N, int K, int m0, int n0, int t, int bar,
                                               unsigned char* smem) {
  using namespace nvcuda;
  using namespace gemm_i8;
  auto As = reinterpret_cast<int8_t(*)[BM][16]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[BK][16]>(smem + A_BYTES);
  int* Cs = reinterpret_cast<int*>(smem + A_BYTES + B_BYTES);
  const int warp = t / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = t; c < BM * (BK / 16); c += GROUP) {
      const int r = c / (BK / 16), h = c % (BK / 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + h * 16);
      *reinterpret_cast<uint4*>(&As[h][r][0]) = v;
    }
    for (int c = t; c < BK * (BN / 16); c += GROUP) {
      const int kr = c / (BN / 16), p = c % (BN / 16);
      *reinterpret_cast<uint4*>(&Bs[p][kr][0]) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kr) * N + n0 + p * 16);
    }
    group_sync(bar, GROUP);
    for (int kh = 0; kh < BK / 16; ++kh) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(&As[kh][wm + i * 16][0]), 16);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const signed char*>(&Bs[(wn + j * 16) / 16][kh * 16][0]), 16);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    group_sync(bar, GROUP);
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  group_sync(bar, GROUP);

  for (int e = t; e < BM * BN; e += GROUP) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    float v = __fmul_rn(__fmul_rn((float)Cs[r * LDC + c], row_scale[m]), col_scale[n]);
    v = __fadd_rn(v, bias[n]);
    const size_t o = (size_t)m * N + n;
    if (MODE == 0) static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(v);
    else if (MODE == 1) static_cast<float*>(C)[o] = v;
    else static_cast<float*>(C)[o] = gelu_tanh(v);
  }
}

// ---------------------------------------------------------------------------
// attention of one (16-query chunk, sequence, head) on the fused QKV buffer
// [B*S, 3D] bf16 (1/sqrt(dh) folded into Q) -> out [B*S, D] bf16, run by
// the whole 256-thread block. Scores Q.K^T accumulate in f32; the probs
// are softmax in f32 rounded to bf16, or (NO_SOFTMAX) bf16(scores * 0.01);
// P.V accumulates in f32 before the final bf16 rounding. K and V of the
// sequence (S padded to a multiple of 16) stay in shared memory with the
// chunk's f32 scores, bf16 probs and f32 output tile.
// ---------------------------------------------------------------------------
namespace attn_bf16 {
constexpr int QC = 16;        // query rows per item
constexpr int THREADS = 256;  // 8 warps

inline __host__ __device__ size_t smem_bytes(int s_pad, int dh) {
  const size_t ldk = dh + 8, lds = s_pad + 4, ldp = s_pad + 8, ldo = dh + 4;
  return 2 * (2 * s_pad * ldk + QC * ldk) + 4 * QC * lds + 2 * QC * ldp + 4 * QC * ldo;
}
}  // namespace attn_bf16

template <bool NO_SOFTMAX>
__device__ __forceinline__ void attention_bf16_item(const __nv_bfloat16* qkv, __nv_bfloat16* out, int S,
                                                    int H, int dh, int s_pad, int b, int h, int q0,
                                                    unsigned char* smem) {
  using namespace nvcuda;
  using attn_bf16::QC;
  using attn_bf16::THREADS;
  const int D = H * dh, row_stride = 3 * D;
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

  // probs over the S real keys, rounded to bf16; padded keys -> 0
  for (int r = warp; r < QC; r += THREADS / 32) {
    const float* srow = Ss + r * lds;
    if (NO_SOFTMAX) {
      for (int c = lane; c < s_pad; c += 32)
        Ps[r * ldp + c] = __float2bfloat16_rn(c < S ? __fmul_rn(srow[c], 0.01f) : 0.0f);
      continue;
    }
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < S; c += 32) sum += expf(srow[c] - mx);
    sum = warp_sum(sum);
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

}  // namespace rohm
