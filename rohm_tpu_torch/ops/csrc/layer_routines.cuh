// Work items of the int8 encoder layer, shared by the per-layer kernels
// (attention_bf16.cu, quant_rows_int8.cu, residual_layernorm.cu) and the
// whole-stack kernel (encoder_stack_int8.cu). Both run these routines, so
// both do the same arithmetic in the same order and the stack's output is
// bit-identical to the per-layer chain. The W8A8 product is the TMA +
// wgmma s8 main loop of wgmma_gemm.cuh in both (gemm_int8.cu, and the
// stack's GEMM phases), and Int8Epilogue below finishes each output of
// both with gemm_int8_value.
//
// A row routine is run by a group of 128 threads (4 warps), an attention
// item by the whole block. A 128-thread group synchronises on its own
// named barrier `bar`: barrier 0 in the per-layer kernels, whose blocks
// are 128 threads, and 1 or 2 for the two 128-thread halves of the stack
// kernel's block. The row reductions therefore always run over 128
// threads in the same tree.
//
// Activation pointers are plain (no __restrict__, no __ldg): the stack
// kernel writes and reads its activations in one launch, where a load
// through the read-only path (ld.global.nc) could return stale data.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace rohm {

constexpr int GROUP = 128;  // threads of a row

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
// one output of the W8A8 product from its int32 sum converted to f32 (exact:
// |sum| <= K 127^2 < 2^24 for K <= 1040), in the plain version's rounded
// steps and order: (acc * row_scale) * col_scale, + bias, then MODE 2's
// tanh-gelu. The caller stores it (MODE 0 as bf16, rounded to nearest even).
// ---------------------------------------------------------------------------
template <int MODE>
__device__ __forceinline__ float gemm_int8_value(float acc, float rs, float cs, float bias) {
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(acc, rs), cs), bias);
  return MODE == 2 ? gelu_tanh(v) : v;
}

// ---------------------------------------------------------------------------
// C[m, n..n+3] of the W8A8 product
//   C = (float(A_i8 @ W_i8) * row_scale[m]) * col_scale[n] + bias[n]
//   MODE 0: store bf16; 1: store f32; 2: tanh-gelu, store f32
// from v, the int32 sums converted to f32 (wgmma_gemm.cuh's epilogue
// hands out four columns at a time). ROW_LDG reads row_scale through the
// read-only path: not in the stack kernel, which writes its row scales in
// the same launch.
// ---------------------------------------------------------------------------
template <int MODE, bool ROW_LDG>
struct Int8Epilogue {
  const float* row_scale;
  const float* col_scale;
  const float* bias;
  void* C;
  int N;

  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float rs = ROW_LDG ? __ldg(row_scale + m) : row_scale[m];
    const float4 cs = __ldg(reinterpret_cast<const float4*>(col_scale + n));
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
    const float r0 = gemm_int8_value<MODE>(v.x, rs, cs.x, b.x);
    const float r1 = gemm_int8_value<MODE>(v.y, rs, cs.y, b.y);
    const float r2 = gemm_int8_value<MODE>(v.z, rs, cs.z, b.z);
    const float r3 = gemm_int8_value<MODE>(v.w, rs, cs.w, b.w);
    const size_t o = (size_t)m * N + n;
    if (MODE == 0)
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(C) + o) = make_uint2(pack_bf16(r0, r1), pack_bf16(r2, r3));
    else
      *reinterpret_cast<float4*>(static_cast<float*>(C) + o) = make_float4(r0, r1, r2, r3);
  }
};

// ---------------------------------------------------------------------------
// attention on the fused QKV buffer [B*S, 3D] bf16 (1/sqrt(dh) folded into
// Q) -> out [B*S, D] bf16, per (sequence, head). Scores Q.K^T accumulate in
// f32; the probs are softmax in f32 over the S real keys, expf(s - max) /
// sum correctly rounded (__fdiv_rn, or div_rn in the row items: the same
// quotient), rounded to bf16 (padded keys give 0), or
// (NO_SOFTMAX) bf16(scores * 0.01); P.V accumulates in f32 before the final
// bf16 rounding. Two routines, both run by a whole block:
//  - attention_bf16_rows, S <= KT (the shipped 144): a row item, a share of
//    at least 64 query rows of one (sequence, head) where it has that many
//    (two items per head at S = 144). K, this item's Q rows, then V land in
//    shared memory once (cp.async; the scores start while V lands). Each
//    warp owns 16-row chunks: the scores of its chunk come from mma.sync
//    m16n8k16 into registers, the row max and sum from quad shuffles over
//    the accumulator layout, the probs are rounded to bf16 straight into
//    the A fragments of P.V, and the output accumulates in registers, 64
//    columns at a time, then leaves in 16-byte stores. A chunk's result
//    depends only on its rows, so any split of the rows into items and of
//    the chunks over warps gives the same bits.
//  - attention_bf16_tiled_item, S > KT: one 16-query chunk per item, K and
//    V streamed through shared memory in tiles of KT keys beside the
//    chunk's Q, f32 scores, bf16 probs and f32 output tile; sweeps over the
//    key tiles for the rows' max, again for their sum (never rescaled), and
//    a last time for the probs and P.V, whose f32 sums carry over the tiles
//    in the output tile. The probs are exp(s - max) / sum of the row's final
//    max and sum, as in the plain version.
// ---------------------------------------------------------------------------
namespace attn_bf16 {
constexpr int QC = 16;        // query rows per chunk
constexpr int THREADS = 256;  // the per-layer kernel's block for the tiled item (8 warps)
constexpr int KT = 144;       // keys of one tile: S <= KT takes the row items

inline __host__ __device__ bool tiled(int s_pad) { return s_pad > KT; }

// S <= KT: the row items of one (sequence, head), each at least 4 chunks
// (64 rows) where the head has that many, and the chunks of the largest
inline __host__ __device__ int row_items(int s_pad) {
  const int n = s_pad / QC / 4;
  return n > 1 ? n : 1;
}
inline __host__ __device__ int item_chunks(int s_pad) {
  const int n = row_items(s_pad);
  return (s_pad / QC + n - 1) / n;
}

inline __host__ __device__ size_t smem_bytes(int s_pad, int dh) {
  const size_t ldk = dh + 8;
  if (!tiled(s_pad)) return 2 * ldk * (2 * (size_t)s_pad + (size_t)QC * item_chunks(s_pad));
  const size_t kt = KT, lds = kt + 4, ldp = kt + 8, ldo = dh + 4;
  return 2 * (2 * kt * ldk + QC * ldk) + 4 * QC * lds + 2 * QC * ldp + 4 * QC * ldo + 4 * 2 * QC;
}
}  // namespace attn_bf16

// Query rows [q0, q0 + 16 nch) of (sequence b, head h) against every key,
// S <= s_pad <= KT (s_pad: S rounded up to 16), by the whole block (any
// number of warps; a warp may take several chunks). DH > 0 fixes the head
// width at compile time (the shared-memory offsets become constants: 14%
// faster at dh = 128 on an H100), DH = 0 takes head_dim, any multiple of
// 16; both give the same bits. Not inlined: its 72 score registers would
// otherwise raise the register pressure of every phase of the whole-stack
// kernel (one block of 288 threads per SM caps it at 168 registers; two
// would cap it at 96, where this routine spills).
template <bool NO_SOFTMAX, int DH>
__device__ __noinline__ void attention_bf16_rows(const __nv_bfloat16* qkv, __nv_bfloat16* out, int S,
                                                 int H, int head_dim, int s_pad, int b, int h, int q0,
                                                 int nch, unsigned char* smem) {
  using attn_bf16::KT;
  using attn_bf16::QC;
  const int dh = DH > 0 ? DH : head_dim;
  const int D = H * dh, stride = 3 * D, ld = dh + 8;  // 16 bytes of skew: ldmatrix without bank conflicts
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [s_pad][ld], rows past S zero
  __nv_bfloat16* Vs = Ks + s_pad * ld;                          // [s_pad][ld], rows past S zero
  __nv_bfloat16* Qs = Vs + s_pad * ld;                          // [16 nch][ld], rows past S zero
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = nthreads / 32, g = lane / 4, q = lane % 4, c8 = dh / 8;
  const __nv_bfloat16* base = qkv + (size_t)b * S * stride + h * dh;

  __syncthreads();  // the block's previous item is done with the buffers
  for (int e = tid; e < s_pad * c8; e += nthreads) {
    const int r = e / c8, c = (e % c8) * 8;
    cp_async16(Ks + r * ld + c, base + (size_t)(r < S ? r : 0) * stride + D + c, r < S);
  }
  for (int e = tid; e < nch * QC * c8; e += nthreads) {
    const int r = e / c8, c = (e % c8) * 8, row = q0 + r;
    cp_async16(Qs + r * ld + c, base + (size_t)(row < S ? row : 0) * stride + c, row < S);
  }
  cp_async_commit();
  for (int e = tid; e < s_pad * c8; e += nthreads) {
    const int r = e / c8, c = (e % c8) * 8;
    cp_async16(Vs + r * ld + c, base + (size_t)(r < S ? r : 0) * stride + 2 * D + c, r < S);
  }
  cp_async_commit();
  cp_async_wait_group<1>();  // K and Q
  __syncthreads();

  const int rounds = (nch + nwarps - 1) / nwarps;
  for (int round = 0; round < rounds; ++round) {
    const int chunk = warp + round * nwarps;
    const bool active = chunk < nch;
    __nv_bfloat16* Qc = Qs + chunk * QC * ld;
    uint32_t pa[KT / 16][4];  // the probs: A fragments of P.V (keys 16t..16t+15)
    if (active) {
      // scores [16 x s_pad] in the accumulator layout: s[j][e] is row
      // g + 8 (e / 2), key 8j + 2q + e % 2
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      for (int kk = 0; kk < dh / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(Qc + (lane & 15) * ld + 16 * kk + ((lane >> 4) << 3)));
#pragma unroll
        for (int jp = 0; jp < KT / 16; ++jp) {
          if (16 * jp >= s_pad) break;
          uint32_t kb[4];
          ldsm_x4(kb, smem_u32(Ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * kk +
                               (((lane >> 3) & 1) << 3)));
          mma_bf16(s[2 * jp], a, kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], a, kb[2], kb[3]);
        }
      }
      if (NO_SOFTMAX) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 8 * j + 2 * q + (e & 1) < S ? __fmul_rn(s[j][e], 0.01f) : 0.0f;
      } else {
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * q + (e & 1) < S) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = 8 * j + 2 * q + (e & 1) < S ? expf(s[j][e] - mx[e / 2]) : 0.0f;
            sum[e / 2] += s[j][e];
          }
        sum[0] = quad_sum(sum[0]);
        sum[1] = quad_sum(sum[1]);
        const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = div_rn(s[j][e], sum[e / 2], rs[e / 2]);
      }
      // accumulator (row g, keys 2q, 2q + 1), (row g + 8, the same) of
      // tiles 2t and 2t + 1 -> the A fragment of keys 16t..16t+15
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        pa[j / 2][2 * (j % 2)] = pack_bf16(s[j][0], s[j][1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[j][2], s[j][3]);
      }
    }
    if (round == 0) {  // V has landed (every thread reaches this once)
      cp_async_wait_group<0>();
      __syncthreads();
    }
    if (!active) continue;

    // out [16 x dh] = P.V, 64 columns at a time; each 16 x 64 block is
    // staged as bf16 in the chunk's own Q rows (free now), then leaves in
    // 16-byte stores
    for (int n0 = 0; n0 < dh; n0 += 64) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
      for (int t = 0; t < KT / 16; ++t) {
        if (16 * t >= s_pad) break;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (n0 + 16 * np >= dh) break;
          uint32_t vb[4];
          ldsm_x4_t(vb, smem_u32(Vs + (16 * t + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + 16 * np +
                                 ((lane >> 4) << 3)));
          mma_bf16(o[2 * np], pa[t], vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa[t], vb[2], vb[3]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n0 + 8 * n >= dh) break;
        const int col = n0 + 8 * n + 2 * q;
        *reinterpret_cast<uint32_t*>(Qc + g * ld + col) = pack_bf16(o[n][0], o[n][1]);
        *reinterpret_cast<uint32_t*>(Qc + (g + 8) * ld + col) = pack_bf16(o[n][2], o[n][3]);
      }
    }
    __syncwarp();
    for (int e = lane; e < QC * c8; e += 32) {
      const int r = e / c8, c = (e % c8) * 8, row = q0 + chunk * QC + r;
      if (row < S)
        *reinterpret_cast<uint4*>(out + ((size_t)b * S + row) * D + h * dh + c) =
            *reinterpret_cast<const uint4*>(Qc + r * ld + c);
    }
  }
}

// One 16-query chunk of (sequence b, head h), S > KT, by the whole block
// (any number of warps: each score tile, row and output tile is one
// warp's, so any count gives the same bits).
template <bool NO_SOFTMAX>
__device__ __forceinline__ void attention_bf16_tiled_item(const __nv_bfloat16* qkv, __nv_bfloat16* out, int S,
                                                          int H, int dh, int b, int h, int q0,
                                                          unsigned char* smem) {
  using namespace nvcuda;
  using attn_bf16::QC;
  constexpr int kt = attn_bf16::KT;
  const int D = H * dh, row_stride = 3 * D;
  const int ldk = dh + 8, lds = kt + 4, ldp = kt + 8, ldo = dh + 4;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kt * ldk;
  __nv_bfloat16* Qs = Vs + kt * ldk;
  float* Ss = reinterpret_cast<float*>(Qs + QC * ldk);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + QC * lds);
  float* Os = reinterpret_cast<float*>(Ps + QC * ldp);
  float* rmax = Os + QC * ldo;  // per query row: max, sum
  float* rsum = rmax + QC;

  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = nthreads / 32;
  const int chunks = dh / 8;  // 16-byte chunks per head row
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;

  for (int c = tid; c < QC * chunks; c += nthreads) {
    const int r = c / chunks, col = (c % chunks) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) qv = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(Qs + r * ldk + col) = qv;
  }
  // keys [k0, k0 + nk16) of K (and V), zero past S; then scores [QC, nk16]
  // = Q K^T (K read column-major as K^T)
  auto tile_scores = [&](int k0, int nk16, bool with_v) {
    __syncthreads();
    for (int c = tid; c < nk16 * chunks; c += nthreads) {
      const int r = c / chunks, col = (c % chunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        const __nv_bfloat16* row = base + (size_t)(k0 + r) * row_stride + col;
        kv = *reinterpret_cast<const uint4*>(row + D);
        if (with_v) vv = *reinterpret_cast<const uint4*>(row + 2 * D);
      }
      *reinterpret_cast<uint4*>(Ks + r * ldk + col) = kv;
      if (with_v) *reinterpret_cast<uint4*>(Vs + r * ldk + col) = vv;
    }
    __syncthreads();
    for (int tile = warp; tile < nk16 / 16; tile += nwarps) {
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
  };

  // the rows' max and sum over the S real keys (one warp per row)
  if (!NO_SOFTMAX) {
    if (tid < QC) rmax[tid] = -INFINITY, rsum[tid] = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < S; k0 += kt) {
        const int nk = min(kt, S - k0);
        tile_scores(k0, (nk + 15) / 16 * 16, false);
        for (int r = warp; r < QC; r += nwarps) {
          const float* srow = Ss + r * lds;
          if (pass == 0) {
            float mx = -INFINITY;
            for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, srow[c]);
            mx = warp_max(mx);
            if (lane == 0) rmax[r] = fmaxf(rmax[r], mx);
          } else {
            const float mx = rmax[r];
            float sum = 0.0f;
            for (int c = lane; c < nk; c += 32) sum += expf(srow[c] - mx);
            sum = warp_sum(sum);
            if (lane == 0) rsum[r] += sum;
          }
        }
      }
    }
  }

  for (int k0 = 0; k0 < S; k0 += kt) {
    const int nk = min(kt, S - k0), nk16 = (nk + 15) / 16 * 16;
    tile_scores(k0, nk16, true);
    // probs over the tile's real keys, rounded to bf16; padded keys -> 0
    for (int r = warp; r < QC; r += nwarps) {
      const float* srow = Ss + r * lds;
      if (NO_SOFTMAX) {
        for (int c = lane; c < nk16; c += 32)
          Ps[r * ldp + c] = __float2bfloat16_rn(c < nk ? __fmul_rn(srow[c], 0.01f) : 0.0f);
        continue;
      }
      const float mx = rmax[r], sum = rsum[r];
      for (int c = lane; c < nk16; c += 32) {
        const float p = c < nk ? __fdiv_rn(expf(srow[c] - mx), sum) : 0.0f;
        Ps[r * ldp + c] = __float2bfloat16_rn(p);
      }
    }
    __syncthreads();

    // out [QC, dh] += P V over the tile's keys
    for (int tile = warp; tile < dh / 16; tile += nwarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (k0 == 0) wmma::fill_fragment(acc, 0.0f);
      else wmma::load_matrix_sync(acc, Os + tile * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < nk16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + kk, ldp);
        wmma::load_matrix_sync(bv, Vs + kk * ldk + tile * 16, ldk);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + tile * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int e = tid; e < QC * dh; e += nthreads) {
    const int r = e / dh, c = e % dh;
    if (q0 + r < S)
      out[((size_t)b * S + q0 + r) * D + h * dh + c] = __float2bfloat16_rn(Os[r * ldo + c]);
  }
}

}  // namespace rohm
