// attention_train: the per-(sequence, head) self-attention of the PoseNet
// training layer, forward and backward, with dropout on the probabilities.
//
// Forward, out [B*S, D] f32 from qkv [B*S, 3D] (bf16 in the bf16 mode, f32
// in the f32 mode; q/k/v read in place):
//   scores = c(q) . c(k)^T * scale;  p = softmax(scores) (max-subtracted f32)
//   pd = p * (mask * inv_keep);       out = c(pd) . c(v)
// Backward, dqkv [B*S, 3D] f32 (and in the bf16 mode, where asked, its bf16
// copy) from qkv, dA = d(out) [B*S, D] (bf16 in the bf16 mode) and the mask:
//   p recomputed as above; dpd = c(dA) . c(v)^T;  dv = c(pd)^T . c(dA)
//   dp = dpd * (mask * inv_keep);   ds = (p * (dp - sum_k dp * p)) * scale
//   dq = c(ds) . c(k);               dk = c(ds)^T . c(q)
// c() rounds to bf16 in the bf16 mode (the TPU kernel's casts of every
// product operand) and is the identity in the f32 mode; scores, softmax and
// every sum stay f32. A product of two bf16 values is exact in f32, so the
// f32 sums here compute what a bf16 MMA with f32 accumulation computes,
// up to the order of the sum. The mask is int8 [B, H, S, S] (1 = keep).
//
// Replaces the attention of rohm_tpu/ops/transformer_layer_train.py::
// _forward_body (K6 and K7's recompute) and the attention backward of
// _bwd_kernel (:259-301). The TPU kernel keeps every (sequence, head) of its
// group in VMEM; an SM has 227 KB, so the keys (or, for dk and dv, the
// queries) stream through shared memory in tiles and any S runs. The
// softmax is never rescaled: p is formed from the row's final max and sum,
// found by sweeps over the key tiles (the max, then the sum) when the
// tiles are more than one, as the plain version forms it.
//   forward, bf16 mode: tensor cores (mma.sync m16n8k16, bf16 in, f32
//            sums), 5 warps of 16 query rows, each keeping a 16 x 160 score
//            tile in registers; the pd of the first product passes from its
//            accumulators into the A fragments of the second. Up to S = 160
//            (the shipped 145) one block per (sequence, head) stages K, V
//            and the mask slab once (108 KB at S = 145, dh = 128: two blocks
//            per SM, all 256 pairs of the training batch in one wave) and
//            its warps take every row tile. A longer sequence takes one
//            block per (80 query rows, sequence, head) and three sweeps
//            over 160-key tiles (max, sum, then pd and P.V). Bound: its
//            bytes (qkv and the mask read, the output written);
//   forward, f32 mode: rohm::attn_tf32::forward_block (attention_tf32.cuh):
//            the bf16 mode's structure with both products as 3xTF32 on
//            the tensor cores (mma.sync m16n8k8, each operand split into
//            two TF32 halves, a partial sum per 32-deep k-step). Up to
//            S = 160 one block per (sequence, head) stages K and V (f32)
//            and the mask slab once (190 KB at S = 145, dh = 128: one block
//            per SM) and its 5 warps take the 16-row tiles in turn; a
//            longer sequence takes one block per (160 query rows, sequence,
//            head) and the three sweeps. Bound: its bytes;
//   backward, bf16 mode: no [B, H, S, S] buffer, no atomics. The score and
//            dpd products are sequential f32 dot products on the FMA units
//            (seq_abt: one fmaf per d, in order, which is how the plain
//            version's f32 GEMM sums them, bit for bit), the softmax sums in
//            the plain version's order and divides (warp_order_sum,
//            div_rn), so p and dp are the plain version's bit for bit and
//            the bf16 roundings of pd and ds flip only where D, a sum in
//            another order, moves them; a tensor-core score sum moves p by
//            an ulp often enough that a flipped ds reaches the gate of
//            2^-10 of max|dq|. The products of the rounded operands (dq, dk,
//            dv) run on the tensor cores. A query kernel (64 rows, 4 warps x
//            16) stages K, V and its mask rows once up to S = 160
//            (cp.async), keeps dp in shared memory in V's place and p in
//            registers, then sweeps 32-key chunks for ds with dq = c(ds) .
//            c(k); above 160 keys it sweeps 160-key tiles, restaged,
//            recomputing p and dp in each sweep. It writes dq and, per row,
//            max, sum and D [3, B, H, S]. A key kernel (64 keys, 4 warps x
//            16) stages its K and V and the [S][S] mask once, sweeps 64-query
//            tiles, recomputes p^T and dp^T from them, and accumulates dk and
//            dv in registers. 4 S x S x dh products on the FMA units and 3 on
//            the tensor cores per (sequence, head) at S <= 160;
//   backward, f32 mode: rohm::attn_tf32::bwd_query_block and bwd_key_block
//            (attention_tf32.cuh): the bf16 mode's two kernels with all
//            seven products as 3xTF32 on the tensor cores, the forward's
//            routines. A query kernel (80 rows, 5 warps x 16) stages V and
//            K once up to S = 160, keeps dp in shared memory in V's place
//            and p in registers, and writes dq and the rows' max, sum and
//            D [3, B, H, S]; past 160 keys it sweeps 160-key tiles four
//            times. A key kernel (80 keys) stages dA, Q and the queries'
//            stats per 160-query tile (once up to S = 160), recomputes p^T
//            and dp^T, keeps ds^T in shared memory and writes dk and dv.
//            Each thread holds the mask as keep bits of its score tile. No
//            [B, H, S, S] buffer, no atomics. Bound: the tensor cores'
//            3xTF32 rate (7 S x S x dh products per (sequence, head)).
#include "attention_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward, f32 mode: 3xTF32 on the tensor cores (attention_tf32.cuh)
// ---------------------------------------------------------------------------

template <bool TILED>
__global__ void __launch_bounds__(TILED ? rohm::attn_tf32::TILED_THREADS : rohm::attn_tf32::THREADS, 1)
    attention_train_fwd_kernel(const float* __restrict__ qkv, const int8_t* __restrict__ mask, float* __restrict__ out,
                               int S, int H, int dh, float scale, float inv_keep) {
  rohm::attn_tf32::forward_block<true, TILED>(qkv, mask, out, S, H, dh, scale, inv_keep);
}

// ---------------------------------------------------------------------------
// tensor-core helpers (mma.sync m16n8k16, bf16 in, f32 sums)
// ---------------------------------------------------------------------------

using rohm::copy_bytes;
using rohm::cp_async16;
using rohm::cp_async_wait;
using rohm::div_rn;
using rohm::ldsm_x4;
using rohm::ldsm_x4_t;
using rohm::mma_bf16;
using rohm::pack_bf16;
using rohm::quad_max;
using rohm::quad_sum;
using rohm::smem_u32;

constexpr int TC_MAX_DH = 128;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// The A fragments of the 16 rows r0..r0+15 (rows >= S zero) of a bf16
// row-major [rows, dh] slice (row stride `stride`), for every 16-wide step
// of dh. Fragment (lane = 4 g + q): rows g and g + 8 of the tile, columns
// 16 kk + 2 q (+1) and + 8 (+9).
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[TC_MAX_DH / 16][4], const __nv_bfloat16* base,
                                             int stride, int r0, int S, int dh, int lane) {
  const int g = lane / 4, q = lane % 4, r_lo = r0 + g, r_hi = r_lo + 8;
  const __nv_bfloat16* lo = base + (size_t)r_lo * stride;
  const __nv_bfloat16* hi = base + (size_t)r_hi * stride;
#pragma unroll
  for (int kk = 0; kk < TC_MAX_DH / 16; ++kk) {
    if (16 * kk < dh) {
      const int c = 16 * kk + 2 * q;
      a[kk][0] = ld_pair(lo + c, r_lo < S);
      a[kk][1] = ld_pair(hi + c, r_hi < S);
      a[kk][2] = ld_pair(lo + c + 8, r_lo < S);
      a[kk][3] = ld_pair(hi + c + 8, r_hi < S);
    } else {
      a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
    }
  }
}

// rows [0, nrows) of a bf16 [rows, dh] slice -> smem [rows][ld] in 16-byte
// copies (cp.async); rows [nreal, nrows) are zero
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int stride,
                                           int nreal, int nrows, int dh, int tid, int nthreads) {
  const int c8 = dh / 8;
  for (int e = tid; e < nrows * c8; e += nthreads) {
    const int r = e / c8, c = (e % c8) * 8;
    cp_async16(dst + r * ld + c, r < nreal ? src + (size_t)r * stride + c : src, r < nreal);
  }
}

// acc[j] (columns 8j..8j+7, j < NJ) = A . B^T over dh, with A the warp's
// fragments and B the rows [0, n16) of a bf16 smem tile [rows][ld]
// (ldmatrix.x4 gives two 8-row B fragments: rows 16jp + 0..7 and + 8..15,
// dh 16kk + 0..7 and + 8..15)
template <int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const uint32_t (&a)[TC_MAX_DH / 16][4],
                                        const __nv_bfloat16* Bs, int ld, int n16, int dh, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < TC_MAX_DH / 16; ++kk) {
    if (16 * kk >= dh) break;
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      if (16 * jp >= n16) break;
      const int row = 16 * jp + (lane & 7) + ((lane >> 4) << 3);
      const int col = 16 * kk + (((lane >> 3) & 1) << 3);
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Bs + row * ld + col));
      mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// eight bf16 (16 bytes) -> f32
__device__ __forceinline__ void unpack8(float (&x)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// acc[j] in the accumulator layout of the mma (rows g and g + 8, columns
// 8j + 2q, +1) = a_row . B_col over dh as a sequential f32 dot product: one
// fmaf per d, d in order, from zero. That is how the plain version's f32
// GEMM (cuBLAS's SIMT kernels) sums each element, so the result is its
// result bit for bit. a_lo, a_hi: the thread's two bf16 rows (16-byte
// aligned); B: the rows [0, n16) of a bf16 smem tile [rows][ld].
template <int NJ>
__device__ __forceinline__ void seq_abt(float (&acc)[NJ][4], const __nv_bfloat16* a_lo, const __nv_bfloat16* a_hi,
                                        const __nv_bfloat16* Bs, int ld, int n16, int dh, int q) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const __nv_bfloat16* b0 = Bs + 2 * q * ld;
  // two 8-deep steps per pass for a short product (dh is a multiple of 16),
  // so that one step's loads overlap the other's FMAs
  constexpr int U = NJ <= 4 ? 2 : 1;
#pragma unroll 1
  for (int d0 = 0; d0 < dh; d0 += 8 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = d0 + 8 * u;
      float xl[8], xh[8];
      unpack8(xl, *reinterpret_cast<const uint4*>(a_lo + d));
      unpack8(xh, *reinterpret_cast<const uint4*>(a_hi + d));
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (8 * j >= n16) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xb[8];
          unpack8(xb, *reinterpret_cast<const uint4*>(b0 + (8 * j + e) * ld + d));
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            acc[j][e] = fmaf(xl[t], xb[t], acc[j][e]);
            acc[j][2 + e] = fmaf(xh[t], xb[t], acc[j][2 + e]);
          }
        }
      }
    }
  }
}

// The row sum of the plain version's softmax (torch's warp softmax), in its
// order, over values held in the accumulator layout. That softmax gives key c
// to lane c % 32 = 8 (j % 4) + 2q + (e & 1) of a warp, which adds its keys in
// order from zero (v[j % 4][e & 1], summed so by the caller); the lanes then
// meet in a butterfly of offsets 16 (j % 4 ^ 2), 8 (j % 4 ^ 1), 4 and 2 (the
// quad's lanes q ^ 2 and q ^ 1) and 1 (e & 1). Exact for S <= 1024, where
// that softmax runs.
__device__ __forceinline__ float warp_order_sum(const float (&v)[4][2]) {
  float w[4][2], x[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) w[m][0] = v[m][0] + v[m ^ 2][0], w[m][1] = v[m][1] + v[m ^ 2][1];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    x[t] = w[0][t] + w[1][t];
    x[t] += __shfl_xor_sync(0xffffffffu, x[t], 2);
    x[t] += __shfl_xor_sync(0xffffffffu, x[t], 1);
  }
  return x[0] + x[1];
}

// acc[n] (dh columns 8n..8n+7) += P . B over the k-rows [0, 16 * nk16s) of
// a bf16 smem tile [rows][ld] (row-major [k][dh]: ldmatrix.trans), with P
// the A fragments pa[t] of k-rows 16t..16t+15
template <int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[TC_MAX_DH / 8][4], const uint32_t (&pa)[NT][4],
                                       const __nv_bfloat16* Bs, int ld, int nk16s, int dh, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= nk16s) break;
#pragma unroll
    for (int np = 0; np < TC_MAX_DH / 16; ++np) {
      if (16 * np >= dh) break;
      const int row = 16 * t + (lane & 7) + (((lane >> 3) & 1) << 3);
      const int col = 16 * np + ((lane >> 4) << 3);
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(Bs + row * ld + col));
      mma_bf16(acc[2 * np], pa[t], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa[t], b[2], b[3]);
    }
  }
}

// two neighbouring accumulator tiles (columns 16t..16t+15) -> the A
// fragment of a 16-deep step of the next product, rounded to bf16
// (accumulator (lane = 4 g + q): (row g, columns 2q, 2q + 1), (row g + 8,
// the same); A: (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..))
template <int NJ>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[NJ / 2][4], const float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(acc[j][0], acc[j][1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(acc[j][2], acc[j][3]);
  }
}

__device__ __forceinline__ void store_rows(float* out, __nv_bfloat16* out16, int stride, int r_lo, int S,
                                           int col0, const float (&o)[TC_MAX_DH / 8][4], int dh, int q) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < TC_MAX_DH / 8; ++n) {
    if (8 * n >= dh) break;
    const int col = col0 + 8 * n + 2 * q;
    if (r_lo < S) {
      *reinterpret_cast<float2*>(out + (size_t)r_lo * stride + col) = make_float2(o[n][0], o[n][1]);
      if (out16) *reinterpret_cast<uint32_t*>(out16 + (size_t)r_lo * stride + col) = pack_bf16(o[n][0], o[n][1]);
    }
    if (r_hi < S) {
      *reinterpret_cast<float2*>(out + (size_t)r_hi * stride + col) = make_float2(o[n][2], o[n][3]);
      if (out16) *reinterpret_cast<uint32_t*>(out16 + (size_t)r_hi * stride + col) = pack_bf16(o[n][2], o[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, bf16 mode: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 5, TC_THREADS = 32 * TC_WARPS;
constexpr int TC_KT = 160;                 // keys per tile: a 16 x 160 score tile per warp in registers
constexpr int TC_GROUP = 16 * TC_WARPS;    // query rows per block when the keys take more than one tile

// !TILED (S <= TC_KT): one block per (sequence, head); TILED: one per
// (TC_GROUP query rows, sequence, head). blockIdx.x = b * H + h. Two
// instantiations, so that each path gets the registers to itself.
template <bool TILED>
__global__ void __launch_bounds__(TC_THREADS, 2) attention_train_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ qkv, const int8_t* __restrict__ mask, float* __restrict__ out, int S,
    int H, int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) __nv_bfloat16 kv[];
  const int D = H * dh, row_stride = 3 * D;
  const int ld = dh + 8;  // bf16 per row: 16 bytes of skew keep ldmatrix conflict-free
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;
  const int8_t* mslab = mask + (size_t)bh * S * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  __nv_bfloat16* Ks = kv;  // [keys][ld], rows past S zero
  uint32_t qa[TC_MAX_DH / 16][4];
  float s[TC_KT / 8][4];
  float o[TC_MAX_DH / 8][4];

  if (!TILED) {
    const int sp = (S + 15) / 16 * 16;  // keys (and query rows) padded to 16
    __nv_bfloat16* Vs = kv + sp * ld;
    int8_t* Ms = reinterpret_cast<int8_t*>(Vs + sp * ld);  // the mask slab, at its address's offset mod 16
    // the first row tile's Q fragments load now, so that their latency
    // overlaps the staging
    load_a_frags(qa, base, row_stride, 16 * warp, S, dh, lane);
    stage_rows(Ks, ld, base + D, row_stride, S, sp, dh, threadIdx.x, TC_THREADS);
    stage_rows(Vs, ld, base + 2 * D, row_stride, S, sp, dh, threadIdx.x, TC_THREADS);
    // this (sequence, head)'s [S][S] mask
    const int moff = copy_bytes(Ms, mslab, (size_t)S * S, threadIdx.x, TC_THREADS);
    cp_async_wait();
    __syncthreads();

    for (int t = warp; t < sp / 16; t += TC_WARPS) {
      const int r_lo = 16 * t + g, r_hi = r_lo + 8;  // this thread's two query rows
      if (t != warp) load_a_frags(qa, base, row_stride, 16 * t, S, dh, lane);
      mma_abt(s, qa, Ks, ld, sp, dh, lane);
      // exact softmax over the row: scale after the product, keys >= S out
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1);
          s[j][e] = col < S ? __fmul_rn(s[j][e], scale) : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < TC_KT / 8; ++j) {
        s[j][0] = expf(s[j][0] - mx_lo);
        s[j][1] = expf(s[j][1] - mx_lo);
        s[j][2] = expf(s[j][2] - mx_hi);
        s[j][3] = expf(s[j][3] - mx_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      // p = e * (1 / sum): within an f32 ulp of e / sum, and a tenth of the
      // kernel's time cheaper than 80 IEEE divisions per thread
      const float rs_lo = __frcp_rn(quad_sum(sum_lo)), rs_hi = __frcp_rn(quad_sum(sum_hi));
      // pd = c(p * keep) as the second product's A fragments; the mask is
      // read once per element
#pragma unroll
      for (int j = 0; j < TC_KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi, col = 8 * j + 2 * q + (e & 1);
          const bool kept = row < S && col < S && Ms[moff + row * S + col];
          s[j][e] = __fmul_rn(__fmul_rn(s[j][e], e < 2 ? rs_lo : rs_hi), kept ? inv_keep : 0.0f);
        }
      }
      uint32_t pa[TC_KT / 16][4];
      to_a_frags(pa, s);
#pragma unroll
      for (int n = 0; n < TC_MAX_DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      mma_pb(o, pa, Vs, ld, sp / 16, dh, lane);
      store_rows(out + (size_t)b * S * D, nullptr, D, r_lo, S, h * dh, o, dh, q);
    }
    return;
  }

  // S > TC_KT: this warp's 16 rows against 160-key tiles, three sweeps
  __nv_bfloat16* Vs = kv + TC_KT * ld;
  const int r0 = blockIdx.y * TC_GROUP + 16 * warp, r_lo = r0 + g, r_hi = r_lo + 8;
  load_a_frags(qa, base, row_stride, r0, S, dh, lane);
  float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo = 0.0f, sum_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll
  for (int n = 0; n < TC_MAX_DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  for (int pass = 0; pass < 3; ++pass) {
    for (int k0 = 0; k0 < S; k0 += TC_KT) {
      const int nk = min(TC_KT, S - k0), nk16 = (nk + 15) / 16 * 16;
      __syncthreads();
      stage_rows(Ks, ld, base + (size_t)k0 * row_stride + D, row_stride, nk, nk16, dh, threadIdx.x, TC_THREADS);
      if (pass == 2)
        stage_rows(Vs, ld, base + (size_t)k0 * row_stride + 2 * D, row_stride, nk, nk16, dh, threadIdx.x, TC_THREADS);
      cp_async_wait();
      __syncthreads();
      mma_abt(s, qa, Ks, ld, nk16, dh, lane);
#pragma unroll
      for (int j = 0; j < TC_KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * q + (e & 1), row = e < 2 ? r_lo : r_hi;
          const float x = col < S ? __fmul_rn(s[j][e], scale) : -INFINITY;
          if (pass == 0) {
            if (e < 2) mx_lo = fmaxf(mx_lo, x);
            else mx_hi = fmaxf(mx_hi, x);
          } else if (pass == 1) {
            if (e < 2) sum_lo += expf(x - mx_lo);
            else sum_hi += expf(x - mx_hi);
          } else {
            const bool kept = row < S && col < S && mslab[(size_t)row * S + col];
            s[j][e] = __fmul_rn(__fmul_rn(expf(x - (e < 2 ? mx_lo : mx_hi)), e < 2 ? rs_lo : rs_hi),
                                kept ? inv_keep : 0.0f);
          }
        }
      }
      if (pass == 2) {
        uint32_t pa[TC_KT / 16][4];
        to_a_frags(pa, s);
        mma_pb(o, pa, Vs, ld, nk16 / 16, dh, lane);
      }
    }
    if (pass == 0) mx_lo = quad_max(mx_lo), mx_hi = quad_max(mx_hi);
    if (pass == 1) rs_lo = __frcp_rn(quad_sum(sum_lo)), rs_hi = __frcp_rn(quad_sum(sum_hi));
  }
  store_rows(out + (size_t)b * S * D, nullptr, D, r_lo, S, h * dh, o, dh, q);
}

// ---------------------------------------------------------------------------
// backward, bf16 mode: tensor cores, a query kernel and a key kernel
// ---------------------------------------------------------------------------

constexpr int BW_THREADS = 128;  // 4 warps of 16 rows (queries or keys)
constexpr int BW_T = 64;         // query rows (query kernel) or keys (key kernel) per block
constexpr int BW_KT = 160;       // keys per tile of the query kernel: S <= 160 is staged once
constexpr int BW_C = 32;         // keys (query kernel) or queries (key kernel) per register step
constexpr int BW_SLAB = 160;     // the key kernel stages the whole [S][S] mask up to this S

// bytes per key of the query kernel's V tile, which up to S = 160 then holds
// the warps' dp (16 rows of f32 per warp)
__host__ __device__ inline int bwd_q_v_bytes(int dh) {
  const int v = 2 * (dh + 8), dp = 4 * 16 * (BW_THREADS / 32);
  return v > dp ? v : dp;
}
size_t bwd_q_tc_smem(int S, int dh) {
  const size_t kt = S < BW_KT ? (S + 15) / 16 * 16 : BW_KT;
  const size_t mask = S <= BW_KT ? (size_t)BW_T * S + 16 : (size_t)BW_T * BW_KT;
  return kt * (sizeof(__nv_bfloat16) * (dh + 8) + bwd_q_v_bytes(dh)) + mask;
}
size_t bwd_kv_tc_smem(int S, int dh) {
  const size_t mask = S <= BW_SLAB ? (size_t)S * S + 16 : (size_t)BW_T * BW_T;
  return 4 * sizeof(__nv_bfloat16) * BW_T * (dh + 8) + sizeof(float) * 4 * BW_T + mask;
}

// Query kernel: one block per (64 query rows, sequence, head); writes dq
// (f32, and bf16 where dqkv16 is given) and stats [3][B*H][S]: the rows'
// max, sum and D. Each thread's two rows of Q and dA are read from device
// memory by the FMA products. ONE (S <= 160): K, V and the rows' mask slab
// are staged once; dp of the warp's 16 rows over every key goes to shared
// memory in V's place (after a barrier: every warp is done with V), p stays
// in registers (a 16 x 160 tile per warp), D = sum_k dp p (as the plain
// version defines it), then one sweep of 32-key chunks for ds and dq +=
// c(ds) . c(k). Above that the keys come in 160-key tiles, restaged for each
// sweep: the rows' max, their sum, D, then ds and dq, p and dp recomputed in
// each.
template <bool ONE>
__global__ void __launch_bounds__(BW_THREADS, 2) attention_train_bwd_q_tc_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dA, const int8_t* __restrict__ mask,
    float* __restrict__ dqkv, __nv_bfloat16* __restrict__ dqkv16, float* __restrict__ stats, int S, int H,
    int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  const int kt = ONE ? (S + 15) / 16 * 16 : BW_KT, ld = dh + 8;
  __nv_bfloat16* Ks = tiles;                                           // [kt keys][ld]
  __nv_bfloat16* Vs = Ks + kt * ld;                                    // [kt keys][ld], then the warps' dp
  int8_t* Ms = reinterpret_cast<int8_t*>(Vs) + kt * bwd_q_v_bytes(dh);  // the block's mask rows
  const int D = H * dh, row_stride = 3 * D;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, q0 = blockIdx.y * BW_T, nq = min(BW_T, S - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8, rl_lo = 16 * warp + g, rl_hi = rl_lo + 8;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;
  const __nv_bfloat16* abase = dA + (size_t)b * S * D + h * dh;
  // the thread's rows of Q and dA (a row past S reads row S - 1; its results are dropped)
  const __nv_bfloat16* qlo = base + (size_t)min(r_lo, S - 1) * row_stride;
  const __nv_bfloat16* qhi = base + (size_t)min(r_hi, S - 1) * row_stride;
  const __nv_bfloat16* alo = abase + (size_t)min(r_lo, S - 1) * D;
  const __nv_bfloat16* ahi = abase + (size_t)min(r_hi, S - 1) * D;
  const int8_t* mrows = mask + ((size_t)bh * S + q0) * S;  // the block's rows of the [S][S] mask
  // mask of (row rl of the block, key cl of the tile at k0): ONE keeps the
  // rows' slab as it lies in memory (row stride S), else a [64][160] tile
  int moff = 0;
  const int mld = ONE ? S : BW_KT;
  auto stage = [&](int k0, bool with_v) {
    const int nk = min(kt, S - k0), nk16 = (nk + 15) / 16 * 16;
    stage_rows(Ks, ld, base + (size_t)k0 * row_stride + D, row_stride, nk, nk16, dh, tid, BW_THREADS);
    if (!with_v) return;
    stage_rows(Vs, ld, base + (size_t)k0 * row_stride + 2 * D, row_stride, nk, nk16, dh, tid, BW_THREADS);
    if (ONE) {
      moff = copy_bytes(Ms, mrows, (size_t)nq * S, tid, BW_THREADS);
    } else {
      for (int e = tid; e < BW_T * BW_KT; e += BW_THREADS) {
        const int rr = e / BW_KT, cc = e % BW_KT;
        Ms[e] = rr < nq && cc < nk ? mrows[(size_t)rr * S + k0 + cc] : 0;
      }
    }
  };
  auto keep = [&](int rl, int k0, int cl) {
    return rl < nq && k0 + cl < S && Ms[moff + rl * mld + cl] ? inv_keep : 0.0f;
  };
  float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo, sum_hi, d_lo, d_hi;
  float vl[4][2] = {}, vh[4][2] = {};  // per-lane partial sums in the warp softmax's order (warp_order_sum)
  float o[TC_MAX_DH / 8][4];
#pragma unroll
  for (int n = 0; n < TC_MAX_DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  if (ONE) {
    stage(0, true);
    cp_async_wait();
    __syncthreads();
    const bool live = q0 + 16 * warp < S;  // the warp has rows
    float* dps = reinterpret_cast<float*>(Vs) + warp * 16 * kt;  // its dp, [kt / 8][4][32 lanes]
    // the warp's 16 rows over every key (keys 8j..8j+7 in p[j]): dp, then p
    float p[BW_KT / 8][4];
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (live) seq_abt(p, pass ? qlo : alo, pass ? qhi : ahi, pass ? Ks : Vs, ld, kt, dh, q);
      if (pass == 1) break;
      __syncthreads();  // every warp is done with V: its place takes the warps' dp
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < BW_KT / 8; ++j) {
        if (8 * j >= kt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dps[(4 * j + e) * 32 + lane] = __fmul_rn(p[j][e], keep(e < 2 ? rl_lo : rl_hi, 0, 8 * j + 2 * q + (e & 1)));
      }
    }
    if (!live) return;  // no barrier left
#pragma unroll
    for (int j = 0; j < BW_KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 8 * j + 2 * q + (e & 1) < S ? __fmul_rn(p[j][e], scale) : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(p[j][0], p[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(p[j][2], p[j][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
#pragma unroll
    for (int j = 0; j < BW_KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = expf(p[j][e] - mx_lo);
        p[j][2 + e] = expf(p[j][2 + e] - mx_hi);
        vl[j % 4][e] += p[j][e];
        vh[j % 4][e] += p[j][2 + e];
      }
    }
    sum_lo = warp_order_sum(vl);
    sum_hi = warp_order_sum(vh);
    const float rb_lo = __frcp_rn(sum_lo), rb_hi = __frcp_rn(sum_hi);
#pragma unroll
    for (int j = 0; j < BW_KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = div_rn(p[j][e], sum_lo, rb_lo);
        p[j][2 + e] = div_rn(p[j][2 + e], sum_hi, rb_hi);
        vl[j % 4][e] = vh[j % 4][e] = 0.0f;
      }
    }
    // D = sum_k dp p, in the same order
#pragma unroll
    for (int j = 0; j < BW_KT / 8; ++j) {
      if (8 * j >= kt) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        vl[j % 4][e] += __fmul_rn(dps[(4 * j + e) * 32 + lane], p[j][e]);
        vh[j % 4][e] += __fmul_rn(dps[(4 * j + 2 + e) * 32 + lane], p[j][2 + e]);
      }
    }
    d_lo = warp_order_sum(vl);
    d_hi = warp_order_sum(vh);
    // ds and dq += c(ds) . c(k), 32 keys at a time
#pragma unroll
    for (int c = 0; c < BW_KT / BW_C; ++c) {
      if (BW_C * c >= kt) break;
      float ds[BW_C / 8][4];
#pragma unroll
      for (int j = 0; j < BW_C / 8; ++j) {
        const int jj = BW_C / 8 * c + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dp = 8 * jj < kt ? dps[(4 * jj + e) * 32 + lane] : 0.0f;
          ds[j][e] = __fmul_rn(__fmul_rn(p[jj][e], __fsub_rn(dp, e < 2 ? d_lo : d_hi)), scale);
        }
      }
      uint32_t pa[BW_C / 16][4];
      to_a_frags(pa, ds);
      mma_pb(o, pa, Ks + BW_C * c * ld, ld, min(BW_C, kt - BW_C * c) / 16, dh, lane);
    }
  } else {
    // the rows' max (pass 0) and sum (pass 1) over 160-key tiles
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < S; k0 += kt) {
        __syncthreads();
        stage(k0, false);
        cp_async_wait();
        __syncthreads();
        float s[BW_KT / 8][4];
        seq_abt(s, qlo, qhi, Ks, ld, (min(kt, S - k0) + 15) / 16 * 16, dh, q);
#pragma unroll
        for (int j = 0; j < BW_KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = k0 + 8 * j + 2 * q + (e & 1) < S ? __fmul_rn(s[j][e], scale) : -INFINITY;
            if (pass == 0) {
              if (e < 2) mx_lo = fmaxf(mx_lo, x);
              else mx_hi = fmaxf(mx_hi, x);
            } else {  // the tiles hold whole 32-key groups: key k0 + 8j + .. is lane (8j + ..) % 32's
              if (e < 2) vl[j % 4][e] += expf(x - mx_lo);
              else vh[j % 4][e - 2] += expf(x - mx_hi);
            }
          }
        }
      }
      if (pass == 0) mx_lo = quad_max(mx_lo), mx_hi = quad_max(mx_hi);
    }
    sum_lo = warp_order_sum(vl);
    sum_hi = warp_order_sum(vh);
    const float rb_lo = __frcp_rn(sum_lo), rb_hi = __frcp_rn(sum_hi);
    // D = sum_k dp p (pass 0), then ds and dq (pass 1), 32 keys at a time
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int m = 0; m < 4; ++m) vl[m][0] = vl[m][1] = vh[m][0] = vh[m][1] = 0.0f;
      for (int k0 = 0; k0 < S; k0 += kt) {
        const int nk16 = (min(kt, S - k0) + 15) / 16 * 16;
        __syncthreads();
        stage(k0, true);
        cp_async_wait();
        __syncthreads();
        for (int kc = 0; kc < nk16; kc += BW_C) {
          const int n16 = min(BW_C, nk16 - kc);
          float s[BW_C / 8][4], dpd[BW_C / 8][4];
          seq_abt(s, qlo, qhi, Ks + kc * ld, ld, n16, dh, q);
          seq_abt(dpd, alo, ahi, Vs + kc * ld, ld, n16, dh, q);
#pragma unroll
          for (int j = 0; j < BW_C / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = kc + 8 * j + 2 * q + (e & 1);  // the key within the tile
              const bool lo = e < 2;
              const float x = k0 + cl < S ? __fmul_rn(s[j][e], scale) : -INFINITY;
              const float pp = lo ? div_rn(expf(x - mx_lo), sum_lo, rb_lo) : div_rn(expf(x - mx_hi), sum_hi, rb_hi);
              const float dp = __fmul_rn(dpd[j][e], keep(lo ? rl_lo : rl_hi, k0, cl));
              if (pass == 0) {
                if (lo) vl[j][e] += __fmul_rn(dp, pp);
                else vh[j][e - 2] += __fmul_rn(dp, pp);
              } else {
                s[j][e] = __fmul_rn(__fmul_rn(pp, __fsub_rn(dp, lo ? d_lo : d_hi)), scale);
              }
            }
          }
          if (pass == 1) {  // dq += c(ds) . c(k) over the chunk's keys
            uint32_t pa[BW_C / 16][4];
            to_a_frags(pa, s);
            mma_pb(o, pa, Ks + kc * ld, ld, n16 / 16, dh, lane);
          }
        }
      }
      if (pass == 0) d_lo = warp_order_sum(vl), d_hi = warp_order_sum(vh);
    }
  }
  if (q == 0) {
    const size_t n = (size_t)gridDim.x * S, i = (size_t)bh * S;
    if (r_lo < S) stats[i + r_lo] = mx_lo, stats[n + i + r_lo] = sum_lo, stats[2 * n + i + r_lo] = d_lo;
    if (r_hi < S) stats[i + r_hi] = mx_hi, stats[n + i + r_hi] = sum_hi, stats[2 * n + i + r_hi] = d_hi;
  }
  store_rows(dqkv + (size_t)b * S * row_stride, dqkv16 ? dqkv16 + (size_t)b * S * row_stride : nullptr,
             row_stride, r_lo, S, h * dh, o, dh, q);
}

// Key kernel: one block per (64 keys, sequence, head), the keys' K and V
// staged once (and, up to S = 160, the whole [S][S] mask); sweeps 64-query
// tiles (Q, dA and the rows' stats staged), each warp computing for its 16
// keys s^T = k . q^T and dpd^T = v . dA^T on 32 queries at a time with the
// query kernel's sequential products, p^T from the rows' max and sum, then
// dv += c(pd^T) . c(dA) and dk += c(ds^T) . c(q) on the tensor cores, the
// sums in registers.
__global__ void __launch_bounds__(BW_THREADS, 2) attention_train_bwd_kv_tc_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dA, const int8_t* __restrict__ mask,
    const float* __restrict__ stats, float* __restrict__ dqkv, __nv_bfloat16* __restrict__ dqkv16, int S, int H,
    int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  const int ld = dh + 8;
  __nv_bfloat16* Ks = tiles;            // [BW_T keys][ld]
  __nv_bfloat16* Vs = Ks + BW_T * ld;   // [BW_T keys][ld]
  __nv_bfloat16* Qs = Vs + BW_T * ld;   // [BW_T queries][ld]
  __nv_bfloat16* As = Qs + BW_T * ld;   // [BW_T queries][ld]
  float* St = reinterpret_cast<float*>(As + BW_T * ld);  // [4][BW_T]: the queries' max, sum, 1 / sum, D
  int8_t* Ms = reinterpret_cast<int8_t*>(St + 4 * BW_T);   // the mask slab, or [BW_T queries][BW_T keys]
  const int D = H * dh, row_stride = 3 * D;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, k0 = blockIdx.y * BW_T;
  const int nk = min(BW_T, S - k0), nk16 = (nk + 15) / 16 * 16;
  const bool slab = S <= BW_SLAB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;
  const __nv_bfloat16* abase = dA + (size_t)b * S * D + h * dh;
  const int8_t* mslab = mask + (size_t)bh * S * S;
  const size_t nstat = (size_t)gridDim.x * S;
  const float* st = stats + (size_t)bh * S;
  stage_rows(Ks, ld, base + (size_t)k0 * row_stride + D, row_stride, nk, nk16, dh, tid, BW_THREADS);
  stage_rows(Vs, ld, base + (size_t)k0 * row_stride + 2 * D, row_stride, nk, nk16, dh, tid, BW_THREADS);
  const int moff = slab ? copy_bytes(Ms, mslab, (size_t)S * S, tid, BW_THREADS) : 0;
  // the thread's two keys (rows g and g + 8 of the warp's 16)
  const __nv_bfloat16* klo = Ks + (16 * warp + g) * ld;
  const __nv_bfloat16* vlo = Vs + (16 * warp + g) * ld;
  float dk[TC_MAX_DH / 8][4], dv[TC_MAX_DH / 8][4];
#pragma unroll
  for (int n = 0; n < TC_MAX_DH / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += BW_T) {
    const int nq = min(BW_T, S - t0), nq16 = (nq + 15) / 16 * 16;
    __syncthreads();
    stage_rows(Qs, ld, base + (size_t)t0 * row_stride, row_stride, nq, nq16, dh, tid, BW_THREADS);
    stage_rows(As, ld, abase + (size_t)t0 * D, D, nq, nq16, dh, tid, BW_THREADS);
    if (!slab) {
      for (int e = tid; e < BW_T * BW_T; e += BW_THREADS) {
        const int rr = e / BW_T, cc = e % BW_T;
        Ms[e] = rr < nq && cc < nk ? mslab[(size_t)(t0 + rr) * S + k0 + cc] : 0;
      }
    }
    for (int rr = tid; rr < BW_T; rr += BW_THREADS) {
      const bool ok = rr < nq;
      const float sum = ok ? st[nstat + t0 + rr] : 1.0f;
      St[rr] = ok ? st[t0 + rr] : 0.0f;
      St[BW_T + rr] = sum;
      St[2 * BW_T + rr] = __frcp_rn(sum);
      St[3 * BW_T + rr] = ok ? st[2 * nstat + t0 + rr] : 0.0f;
    }
    cp_async_wait();
    __syncthreads();
    if (16 * warp >= nk16) continue;  // no keys for this warp (it still meets every barrier)
    // the mask of (query ql of the tile, key kl of the block)
    const int8_t* mt = slab ? Ms + moff + (size_t)t0 * S + k0 : Ms;
    const int mld = slab ? S : BW_T;
    for (int qc = 0; qc < nq16; qc += BW_C) {
      const int n16 = min(BW_C, nq16 - qc);
      float s[BW_C / 8][4], dpd[BW_C / 8][4];
      seq_abt(s, klo, klo + 8 * ld, Qs + qc * ld, ld, n16, dh, q);
      seq_abt(dpd, vlo, vlo + 8 * ld, As + qc * ld, ld, n16, dh, q);
      // s -> pd^T, dpd -> ds^T (key rows g and g + 8 of the warp, queries by column)
#pragma unroll
      for (int j = 0; j < BW_C / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 16 * warp + g + (e < 2 ? 0 : 8), ql = qc + 8 * j + 2 * q + (e & 1);
          const bool ok = kl < nk && ql < nq;
          const float p =
              ok ? div_rn(expf(__fmul_rn(s[j][e], scale) - St[ql]), St[BW_T + ql], St[2 * BW_T + ql]) : 0.0f;
          const float keep = ok && mt[ql * mld + kl] ? inv_keep : 0.0f;
          const float dp = __fmul_rn(dpd[j][e], keep);
          s[j][e] = __fmul_rn(p, keep);
          dpd[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, St[3 * BW_T + ql])), scale);
        }
      }
      uint32_t pa[BW_C / 16][4], sa[BW_C / 16][4];
      to_a_frags(pa, s);
      to_a_frags(sa, dpd);
      mma_pb(dv, pa, As + qc * ld, ld, n16 / 16, dh, lane);
      mma_pb(dk, sa, Qs + qc * ld, ld, n16 / 16, dh, lane);
    }
  }
  const int r_lo = k0 + 16 * warp + g;
  float* rows = dqkv + (size_t)b * S * row_stride;
  __nv_bfloat16* rows16 = dqkv16 ? dqkv16 + (size_t)b * S * row_stride : nullptr;
  store_rows(rows, rows16, row_stride, r_lo, S, D + h * dh, dk, dh, q);
  store_rows(rows, rows16, row_stride, r_lo, S, 2 * D + h * dh, dv, dh, q);
}

// ---------------------------------------------------------------------------
// backward, f32 mode: 3xTF32 on the tensor cores (attention_tf32.cuh)
// ---------------------------------------------------------------------------

template <bool TILED>
__global__ void __launch_bounds__(rohm::attn_tf32::BWD_THREADS, 1)
    attention_train_bwd_query_kernel(const float* __restrict__ qkv, const float* __restrict__ dA,
                                      const int8_t* __restrict__ mask, float* __restrict__ dqkv,
                                      float* __restrict__ stats, int S, int H, int dh, float scale, float inv_keep) {
  rohm::attn_tf32::bwd_query_block<TILED>(qkv, dA, mask, dqkv, stats, S, H, dh, scale, inv_keep);
}

template <bool TILED>
__global__ void __launch_bounds__(rohm::attn_tf32::BWD_THREADS, 1)
    attention_train_bwd_key_kernel(const float* __restrict__ qkv, const float* __restrict__ dA,
                                   const int8_t* __restrict__ mask, const float* __restrict__ stats,
                                   float* __restrict__ dqkv, int S, int H, int dh, float scale, float inv_keep) {
  rohm::attn_tf32::bwd_key_block<TILED>(qkv, dA, mask, stats, dqkv, S, H, dh, scale, inv_keep);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// as much shared memory as the SM has, so that two ~100 KB blocks share it
template <typename Kernel>
cudaError_t allow_two_blocks(Kernel kernel, size_t bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  return err == cudaSuccess ? cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100) : err;
}

bool bad_shape(int B, int S, int H, int dh, bool bf16) {
  return B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % (bf16 ? 16 : 4) != 0 || dh > TC_MAX_DH;
}

}  // namespace

// Any S; dh up to 128, a multiple of 16 in the bf16 mode (qkv bf16) and of
// 4 in the f32 mode (qkv f32).
extern "C" int rt_attention_train_fwd(const void* qkv, const void* mask, void* out, int B, int S,
                                      int H, int dh, float scale, float inv_keep, int bf16,
                                      void* stream) {
  if (bad_shape(B, S, H, dh, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (bf16) {
    // up to TC_KT keys: K and V of the sequence, then the mask slab (S^2
    // bytes at an offset < 16); above: a tile of K and V
    const size_t row = sizeof(__nv_bfloat16) * (dh + 8);
    const size_t smem = S <= TC_KT ? 2 * row * ((S + 15) / 16 * 16) + (size_t)S * S + 16 : 2 * row * TC_KT;
    auto kernel = S <= TC_KT ? attention_train_fwd_tc_kernel<false> : attention_train_fwd_tc_kernel<true>;
    const cudaError_t err = allow_two_blocks(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, S <= TC_KT ? 1 : (S + TC_GROUP - 1) / TC_GROUP);
    kernel<<<grid, TC_THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(qkv), m, o, S, H, dh, scale, inv_keep);
    return (int)cudaGetLastError();
  }
  namespace tf = rohm::attn_tf32;
  const size_t smem = tf::smem_bytes(S, dh, true);
  auto kernel = tf::tiled(S) ? attention_train_fwd_kernel<true> : attention_train_fwd_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<tf::grid(B, S, H), tf::tiled(S) ? tf::TILED_THREADS : tf::THREADS, smem, s>>>(
      static_cast<const float*>(qkv), m, o, S, H, dh, scale, inv_keep);
  return (int)cudaGetLastError();
}

// qkv and dA bf16 (bf16 mode) or f32; dqkv f32 and, in the bf16 mode unless
// null, its bf16 copy dqkv16; work [3, B, H, S] f32 (the rows' max, sum and
// D, from the query kernel to the key kernel). The two kernels run in
// stream order.
extern "C" int rt_attention_train_bwd(const void* qkv, const void* dA, const void* mask, void* dqkv,
                                      void* dqkv16, void* work, int B, int S, int H, int dh, float scale,
                                      float inv_keep, int bf16, void* stream) {
  if (bad_shape(B, S, H, dh, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int8_t*>(mask);
  auto* out = static_cast<float*>(dqkv);
  auto* w = static_cast<float*>(work);
  if (bf16) {
    const size_t smem_q = bwd_q_tc_smem(S, dh), smem_kv = bwd_kv_tc_smem(S, dh);
    auto kq = S <= BW_KT ? attention_train_bwd_q_tc_kernel<true> : attention_train_bwd_q_tc_kernel<false>;
    cudaError_t err = allow_two_blocks(kq, smem_q);
    if (err == cudaSuccess) err = allow_two_blocks(attention_train_bwd_kv_tc_kernel, smem_kv);
    if (err != cudaSuccess) return (int)err;
    const auto* q = static_cast<const __nv_bfloat16*>(qkv);
    const auto* da = static_cast<const __nv_bfloat16*>(dA);
    auto* out16 = static_cast<__nv_bfloat16*>(dqkv16);
    const dim3 grid(B * H, (S + BW_T - 1) / BW_T);
    kq<<<grid, BW_THREADS, smem_q, s>>>(q, da, m, out, out16, w, S, H, dh, scale, inv_keep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attention_train_bwd_kv_tc_kernel<<<grid, BW_THREADS, smem_kv, s>>>(q, da, m, w, out, out16, S, H, dh, scale,
                                                                       inv_keep);
    return (int)cudaGetLastError();
  }
  namespace tf = rohm::attn_tf32;
  const size_t smem_q = tf::bwd_query_smem(S, dh), smem_k = tf::bwd_key_smem(S, dh);
  auto kq = tf::tiled(S) ? attention_train_bwd_query_kernel<true> : attention_train_bwd_query_kernel<false>;
  auto kk = tf::tiled(S) ? attention_train_bwd_key_kernel<true> : attention_train_bwd_key_kernel<false>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err == cudaSuccess) err = allow_smem(kk, smem_k);
  if (err != cudaSuccess) return (int)err;
  const auto* q = static_cast<const float*>(qkv);
  const auto* da = static_cast<const float*>(dA);
  const dim3 grid = tf::bwd_grid(B, S, H);
  kq<<<grid, tf::BWD_THREADS, smem_q, s>>>(q, da, m, out, w, S, H, dh, scale, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kk<<<grid, tf::BWD_THREADS, smem_k, s>>>(q, da, m, w, out, S, H, dh, scale, inv_keep);
  return (int)cudaGetLastError();
}
