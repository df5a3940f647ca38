// The f32 attention on the tensor cores (3xTF32), with the keys streamed
// through shared memory in tiles: the forward, the body of attention_f32.cu
// (K1) and of the f32 mode of attention_train.cu's forward (K6), and the
// f32 mode of attention_train.cu's backward (K7; its own section below).
//
// What it computes, for one (sequence, head): scores s = Q.K^T (x scale,
// rounded once, in TRAIN: K6's arithmetic; otherwise Q arrives pre-scaled,
// K1's); p = exp(s - max) / sum, exact over the row and never rescaled;
// in TRAIN p x (the int8 [B, H, S, S] keep mask x inv_keep); out = P.V.
//
// Both products run as 3xTF32 on mma.sync m16n8k8, as the f32 GEMM main
// loop does (f32_gemm.cuh: the split of each operand into big + small, the
// three products small terms first, and its error budget): each 32-deep
// k-step of a product sums into a partial accumulator that starts at zero
// and is added to the running sum rounded to nearest, so the tensor cores'
// truncating f32 sums cannot drift over the product's depth.
//
// Warps of 16 query rows, each holding a 16 x 160 score tile in registers
// (20 accumulator tiles of 16 x 8, 80 f32 a thread), as the bf16 forward
// does. The k labels of every product are permuted so that each operand
// comes in 16-byte loads and nothing is shuffled between the products:
//   Q.K^T (k = dh): in a 32-deep k-step lane (g, t) = (lane / 4, lane % 4)
//     owns dh 8t .. 8t + 7 (k8 step kk: slot t is dh 8t + 2kk, slot t + 4
//     is 8t + 2kk + 1), so Q's A fragments are two float4 of each of its
//     rows g, g + 8 (read from device memory once per k-step, the next
//     one's in flight while this one multiplies; only the current k-step is
//     split, 32 registers), and K's B fragments two float4 of key row g
//     (banks 8t + 4g: conflict-free at a pitch of 4 mod 32).
//   P.V (k = keys): the C fragment of a score tile gives lane (g, t) keys
//     2t and 2t + 1 of its 8; slot t is key 2t and slot t + 4 key 2t + 1,
//     so the accumulators c0, c1, c2, c3 are the A fragment's a0, a2, a1,
//     a3 as they stand. V's B fragments read key rows 2t and 2t + 1, and
//     the output columns are labelled as f32_gemm.cuh labels an MN-major
//     operand: in a group of 32 dh columns, mma tile n's column g is dh
//     4g + n, so one float4 of a V row gives four tiles' b (banks 8t + 4g),
//     and a thread's outputs are 8 contiguous floats of each of its rows.
// The order of each sum differs from the plain version's; the emulation in
// tests/test_torch_attention_tf32_numerics.py holds it under the gates.
//
// dh is any multiple of 4 up to 128: K and V are staged with zeros in the
// columns past dh up to a multiple of 32, and Q reads zeros there.
//
// Up to KT keys (the shipped S = 144 and 145 included) every key is staged
// once in shared memory (K and V f32 at a pitch of dh + 4, keys padded to
// 16: 152 KB at S = 144 and 169 KB at S = 145, dh = 128; then in TRAIN the
// block's rows of the mask; K in a cp.async group of its own, so that the
// scores start while V lands) and the block's warps take its row tiles in
// turn. The block is one (sequence, head) with every row tile (HEAD_GRID),
// or 16 WARPS query rows of one
// (rohm_tpu_torch/scripts/attention_f32_variants.py times both). A longer
// sequence takes one block per (16 TILED_WARPS query rows, sequence, head)
// and three sweeps over KT-key tiles: the rows' max, their sum, then p and
// P.V.
#pragma once

#include "common.cuh"

namespace rohm {
namespace attn_tf32 {

constexpr int KT = 160;             // keys per tile: a 16 x 160 score tile per warp
constexpr int NJ = KT / 8;          // score accumulator tiles per warp
constexpr int JC = 4;               // score tiles per partial accumulator (independent mma chains)
constexpr int MAX_DH = 128;
constexpr int WARPS = 5;            // up to KT keys: warps of a block, which take the row tiles in turn
constexpr bool HEAD_GRID = true;    // up to KT keys: one block per (sequence, head), else per 16 WARPS rows
constexpr int TILED_WARPS = 10;     // past KT keys: warps of a block, one row tile each

__host__ __device__ inline int dh_pad(int dh) { return (dh + 31) / 32 * 32; }
__host__ __device__ inline bool tiled(int S) { return S > KT; }
constexpr int THREADS = 32 * WARPS, TILED_THREADS = 32 * TILED_WARPS;
// query rows per block
__host__ __device__ inline int block_rows(int S) {
  return tiled(S) ? 16 * TILED_WARPS : HEAD_GRID ? S : 16 * WARPS;
}

// keys staged per tile: a multiple of 16 (zeros past S)
__host__ __device__ inline int keys_pad(int n) { return (n + 15) / 16 * 16; }

inline size_t smem_bytes(int S, int dh, bool train) {
  const size_t keys = tiled(S) ? KT : keys_pad(S), ld = dh_pad(dh) + 4;
  size_t bytes = 2 * keys * ld * sizeof(float);
  if (train && !tiled(S)) bytes += (size_t)(block_rows(S) < S ? block_rows(S) : S) * S + 16;
  return bytes;
}

// blockIdx.x = b * H + h, blockIdx.y = the block's row group
inline dim3 grid(int B, int S, int H) { return dim3(B * H, (S + block_rows(S) - 1) / block_rows(S)); }

// rows [0, nrows) of one head's K or V columns -> smem [rows][ld] (cp.async);
// rows [nreal, nrows) and columns [dh, dh_pad) zero
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int stride, int nreal, int nrows,
                                      int dh) {
  const int c4 = dh_pad(dh) / 4;
  for (int e = threadIdx.x; e < nrows * c4; e += blockDim.x) {
    const int r = e / c4, c = (e % c4) * 4;
    const bool ok = r < nreal && c < dh;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)r * stride + c : src, ok);
  }
}

// Q of rows g (lo) and g + 8 (hi), dh c .. c + 7, zeros past dh or S
__device__ __forceinline__ void load_q(float4 (&q)[4], const float* lo, const float* hi, bool lo_ok, bool hi_ok,
                                       int c, int dh) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  q[0] = lo_ok && c < dh ? ld4(lo + c) : z;
  q[1] = lo_ok && c + 4 < dh ? ld4(lo + c + 4) : z;
  q[2] = hi_ok && c < dh ? ld4(hi + c) : z;
  q[3] = hi_ok && c + 4 < dh ? ld4(hi + c + 4) : z;
}

// s[j0 .. j0 + W) += the products of one 32-deep k-step (K from smem
// [keys][ld], column kb on; ab / as the split A fragments of its four k8
// steps), summed in a partial accumulator: W independent chains of mma's
template <int W>
__device__ __forceinline__ void score_chunk(float (&s)[NJ][4], int j0, const uint32_t (&ab)[4][4],
                                            const uint32_t (&as)[4][4], const float* Ks, int ld, int kb, int g,
                                            int t) {
  float kv[W][8], part[W][4];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const float* krow = Ks + (8 * (j0 + u) + g) * ld + kb + 8 * t;
    const float4 k0 = ld4(krow), k1 = ld4(krow + 4);
    kv[u][0] = k0.x, kv[u][1] = k0.y, kv[u][2] = k0.z, kv[u][3] = k0.w;
    kv[u][4] = k1.x, kv[u][5] = k1.y, kv[u][6] = k1.z, kv[u][7] = k1.w;
    part[u][0] = part[u][1] = part[u][2] = part[u][3] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t bb[W][2], bs[W][2];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      split(kv[u][2 * kk], bb[u][0], bs[u][0]);
      split(kv[u][2 * kk + 1], bb[u][1], bs[u][1]);
    }
#pragma unroll
    for (int u = 0; u < W; ++u) mma_tf32(part[u], as[kk], bb[u][0], bb[u][1]);
#pragma unroll
    for (int u = 0; u < W; ++u) mma_tf32(part[u], ab[kk], bs[u][0], bs[u][1]);
#pragma unroll
    for (int u = 0; u < W; ++u) mma_tf32(part[u], ab[kk], bb[u][0], bb[u][1]);
  }
#pragma unroll
  for (int u = 0; u < W; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j0 + u][e] = __fadd_rn(s[j0 + u][e], part[u][e]);
}

// s[j] (rows g, g + 8; keys 8j + 2t, + 1 of the tile) = Q.K^T over dh for
// the tile's first nj accumulator tiles (nj even: keys padded to 16); Q
// rows from device memory (lo, hi: this thread's two rows), K from smem
// [keys][ld]
__device__ __forceinline__ void scores(float (&s)[NJ][4], const float* lo, const float* hi, bool lo_ok,
                                       bool hi_ok, const float* Ks, int ld, int nj, int dh, int lane) {
  const int g = lane / 4, t = lane % 4, dp = dh_pad(dh);
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  float4 qn[4];
  load_q(qn, lo, hi, lo_ok, hi_ok, 8 * t, dh);
#pragma unroll 1
  for (int kb = 0; kb < dp; kb += 32) {
    const float ql[8] = {qn[0].x, qn[0].y, qn[0].z, qn[0].w, qn[1].x, qn[1].y, qn[1].z, qn[1].w};
    const float qh[8] = {qn[2].x, qn[2].y, qn[2].z, qn[2].w, qn[3].x, qn[3].y, qn[3].z, qn[3].w};
    if (kb + 32 < dp) load_q(qn, lo, hi, lo_ok, hi_ok, kb + 32 + 8 * t, dh);
    uint32_t ab[4][4], as[4][4];  // A fragments of the four k8 steps, split
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split(ql[2 * kk], ab[kk][0], as[kk][0]);
      split(qh[2 * kk], ab[kk][1], as[kk][1]);
      split(ql[2 * kk + 1], ab[kk][2], as[kk][2]);
      split(qh[2 * kk + 1], ab[kk][3], as[kk][3]);
    }
#pragma unroll
    for (int jc = 0; jc < NJ; jc += JC) {
      if (jc + JC <= nj) score_chunk<JC>(s, jc, ab, as, Ks, ld, kb, g, t);
      else if (jc + 2 <= nj) score_chunk<2>(s, jc, ab, as, Ks, ld, kb, g, t);
    }
  }
}

// o[n] += the products of the W k8 steps j0 .. j0 + W - 1 (keys 8 j0 on),
// summed in a partial accumulator: P the probs in the score accumulators'
// layout, V smem [keys][ld], dh columns 32m + 4g + n of mma tile n
template <int W>
__device__ __forceinline__ void pv_kstep(float (&o)[4][4], const float (&p)[NJ][4], int j0, const float* Vs, int ld,
                                         int m, int g, int t) {
  float part[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const int j = j0 + kk;
    uint32_t ab[4], as[4], bb[4][2], bs[4][2];
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const float* v = Vs + (8 * j + 2 * t) * ld + 32 * m + 4 * g;
    const float4 x0 = ld4(v), x1 = ld4(v + ld);
    const float b0[4] = {x0.x, x0.y, x0.z, x0.w}, b1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      split(b0[n], bb[n][0], bs[n][0]);
      split(b1[n], bb[n][1], bs[n][1]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(part[n], as, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(part[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(part[n], ab, bb[n][0], bb[n][1]);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = __fadd_rn(o[n][e], part[n][e]);
}

// o[n] += P.V for dh columns 32m + 4g + n of mma tile n (n < 4), over the
// tile's keys [0, 8 nj) (nj even) in 32-key k-steps. o[n]'s accumulators
// are (row g, dh 32m + 8t + n), (g, 32m + 8t + 4 + n), (g + 8, ...),
// (g + 8, ...).
__device__ __forceinline__ void pv_group(float (&o)[4][4], const float (&p)[NJ][4], const float* Vs, int ld,
                                         int m, int nj, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < NJ; ks += 4) {
    if (ks + 4 <= nj) pv_kstep<4>(o, p, ks, Vs, ld, m, g, t);
    else if (ks + 2 <= nj) pv_kstep<2>(o, p, ks, Vs, ld, m, g, t);
  }
}

// o (one group of 32 dh columns, pv_group's layout) -> out rows r_lo and
// r_lo + 8 (< S), 16 bytes at a time
__device__ __forceinline__ void store_group(float* out, int stride, int r_lo, int S, const float (&o)[4][4], int m,
                                            int dh, int t) {
  const int c = 32 * m + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    if (r >= S) continue;
    float* row = out + (size_t)r * stride;
    if (c < dh) st4(row + c, make_float4(o[0][2 * h], o[1][2 * h], o[2][2 * h], o[3][2 * h]));
    if (c + 4 < dh) st4(row + c + 4, make_float4(o[0][2 * h + 1], o[1][2 * h + 1], o[2][2 * h + 1], o[3][2 * h + 1]));
  }
}

// s (scores of rows g, g + 8 against keys 0 .. KT - 1) -> p = softmax, exact
// over the row: x scale in TRAIN (after the product, rounded once), keys >=
// S out, the row's max, exp(s - max), its sum, p = e / sum rounded once
template <bool TRAIN>
__device__ __forceinline__ void row_softmax(float (&s)[NJ][4], int S, float scale, int t, float& mx_lo,
                                            float& mx_hi, float& sum_lo, float& sum_hi) {
  mx_lo = mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      s[j][e] = 8 * j + 2 * t + (e & 1) < S ? (TRAIN ? __fmul_rn(x, scale) : x) : -INFINITY;
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  sum_lo = sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = expf(s[j][0] - mx_lo);
    s[j][1] = expf(s[j][1] - mx_lo);
    s[j][2] = expf(s[j][2] - mx_hi);
    s[j][3] = expf(s[j][3] - mx_hi);
    sum_lo += s[j][0] + s[j][1];
    sum_hi += s[j][2] + s[j][3];
  }
  sum_lo = quad_sum(sum_lo);
  sum_hi = quad_sum(sum_hi);
  const float rs_lo = __frcp_rn(sum_lo), rs_hi = __frcp_rn(sum_hi);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = div_rn(s[j][0], sum_lo, rs_lo);
    s[j][1] = div_rn(s[j][1], sum_lo, rs_lo);
    s[j][2] = div_rn(s[j][2], sum_hi, rs_hi);
    s[j][3] = div_rn(s[j][3], sum_hi, rs_hi);
  }
}

template <bool TRAIN, bool TILED>
__device__ inline void forward_block(const float* __restrict__ qkv, const int8_t* __restrict__ mask,
                                     float* __restrict__ out, int S, int H, int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, stride = 3 * D, ld = dh_pad(dh) + 4, groups = dh_pad(dh) / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* base = qkv + (size_t)b * S * stride + h * dh;
  float* obase = out + (size_t)b * S * D + h * dh;
  const int8_t* mslab = TRAIN ? mask + (size_t)bh * S * S : nullptr;
  const int row0 = blockIdx.y * block_rows(S), nrows = min(block_rows(S), S - row0);
  float* Ks = smem;
  float s[NJ][4];

  // the score of accumulator e of tile j (key col of the tile) as the softmax sees it
  auto score = [&](float x, int col) { return col < S ? (TRAIN ? __fmul_rn(x, scale) : x) : -INFINITY; };

  if (!TILED) {
    const int keys = keys_pad(S), nj = keys / 8;
    float* Vs = Ks + keys * ld;
    int8_t* Ms = reinterpret_cast<int8_t*>(Vs + keys * ld);  // the block's mask rows, at their offset mod 16
    // K first, in a group of its own: the scores start when it has landed,
    // while V and the mask are still on their way
    stage(Ks, ld, base + D, stride, S, keys, dh);
    cp_async_commit();
    stage(Vs, ld, base + 2 * D, stride, S, keys, dh);
    const int moff = TRAIN ? copy_bytes(Ms, mslab + (size_t)row0 * S, (size_t)nrows * S, threadIdx.x, blockDim.x) : 0;
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();

    const int tiles = (nrows + 15) / 16;
    for (int i = 0; i < (tiles + WARPS - 1) / WARPS; ++i) {
      const int rt = warp + WARPS * i;
      const int r_lo = row0 + 16 * rt + g, r_hi = r_lo + 8;  // this thread's two query rows
      if (rt < tiles) {
        scores(s, base + (size_t)r_lo * stride, base + (size_t)r_hi * stride, r_lo < S, r_hi < S, Ks, ld, nj, dh,
               lane);
        float mx_lo, mx_hi, sum_lo, sum_hi;
        row_softmax<TRAIN>(s, S, scale, t, mx_lo, mx_hi, sum_lo, sum_hi);
      }
      if (i == 0) {  // V and the mask have landed (every warp passes here once)
        cp_async_wait_group<0>();
        __syncthreads();
      }
      if (rt >= tiles) continue;
      if (TRAIN) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r_lo : r_hi, col = 8 * j + 2 * t + (e & 1);
            const bool kept = row < S && col < S && Ms[moff + (row - row0) * S + col];
            s[j][e] = __fmul_rn(s[j][e], kept ? inv_keep : 0.0f);
          }
        }
      }
      for (int m = 0; m < groups; ++m) {
        float o[4][4] = {};
        pv_group(o, s, Vs, ld, m, nj, lane);
        store_group(obase, D, r_lo, S, o, m, dh, t);
      }
    }
    return;
  }

  // S > KT: this warp's 16 rows against KT-key tiles, three sweeps
  float* Vs = Ks + KT * ld;
  const int r_lo = row0 + 16 * warp + g, r_hi = r_lo + 8;
  const float* q_lo = base + (size_t)r_lo * stride;
  const float* q_hi = base + (size_t)r_hi * stride;
  float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo = 0.0f, sum_hi = 0.0f, rs_lo = 0.0f, rs_hi = 0.0f;
  float o[MAX_DH / 32][4][4] = {};
  for (int pass = 0; pass < 3; ++pass) {
    for (int k0 = 0; k0 < S; k0 += KT) {
      const int nk = min(KT, S - k0), nj = keys_pad(nk) / 8;
      __syncthreads();  // the previous tile is done with
      stage(Ks, ld, base + (size_t)k0 * stride + D, stride, nk, 8 * nj, dh);
      if (pass == 2) stage(Vs, ld, base + (size_t)k0 * stride + 2 * D, stride, nk, 8 * nj, dh);
      cp_async_wait();
      __syncthreads();
      scores(s, q_lo, q_hi, r_lo < S, r_hi < S, Ks, ld, nj, dh, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const float x = score(s[j][e], col);
          if (pass == 0) {
            if (lo) mx_lo = fmaxf(mx_lo, x);
            else mx_hi = fmaxf(mx_hi, x);
          } else if (pass == 1) {
            if (lo) sum_lo += expf(x - mx_lo);
            else sum_hi += expf(x - mx_hi);
          } else {
            float p = div_rn(expf(x - (lo ? mx_lo : mx_hi)), lo ? sum_lo : sum_hi, lo ? rs_lo : rs_hi);
            if (TRAIN) {
              const int row = lo ? r_lo : r_hi;
              const bool kept = row < S && col < S && mslab[(size_t)row * S + col];
              p = __fmul_rn(p, kept ? inv_keep : 0.0f);
            }
            s[j][e] = p;
          }
        }
      }
      if (pass == 2) {
#pragma unroll
        for (int m = 0; m < MAX_DH / 32; ++m)
          if (m < groups) pv_group(o[m], s, Vs, ld, m, nj, lane);
      }
    }
    if (pass == 0) mx_lo = quad_max(mx_lo), mx_hi = quad_max(mx_hi);
    if (pass == 1) {
      sum_lo = quad_sum(sum_lo), sum_hi = quad_sum(sum_hi);
      rs_lo = __frcp_rn(sum_lo), rs_hi = __frcp_rn(sum_hi);
    }
  }
#pragma unroll
  for (int m = 0; m < MAX_DH / 32; ++m)
    if (m < groups) store_group(obase, D, r_lo, S, o[m], m, dh, t);
}

// ---------------------------------------------------------------------------
// The backward (the f32 mode of attention_train.cu's backward, K7)
// ---------------------------------------------------------------------------
//
// For one (sequence, head), with p = softmax(Q.K^T x scale) as the forward
// forms it and keep = mask x inv_keep:
//   dpd = dA.V^T, dp = dpd keep, D = sum_k dp p (per query row),
//   ds = p (dp - D) x scale, dq = ds.K;  dv = (p keep)^T.dA, dk = ds^T.Q.
// Seven products, each one of the forward's two shapes, in 3xTF32 with a
// partial sum per 32-deep k-step: A.B^T over dh (`scores`: A rows from
// device memory, B a [rows][ld] smem tile) or a tile in the score
// accumulators' layout times an MN-major smem operand (`pv_group`: the k
// labels 2t and 2t + 1 of each 8 read rows 2t and 2t + 1 of the operand).
// Two kernels, no [B, H, S, S] buffer and no atomics: dq comes from the
// query kernel alone, dk and dv from the key kernel alone, and between them
// go the rows' max, sum and D (work [3, B, H, S]).
//
// Each routine has one call site in each kernel (a loop over its two uses):
// with two, the backward took 0.52 ms on the card at 64 x 4 x 145 against
// 0.48, with no spill (scripts/attention_bwd_f32_variants.py, "two call
// sites"): the larger code costs the time, not the registers.
//
// The mask enters both kernels as each thread's keep bits of its 80 score
// accumulators (3 registers). The query kernel's one-tile path loads its
// bytes before the staging copies and packs them once the copies are
// issued (loaded after them, queued behind them, it took 4% longer: the
// script's "keep bits after the staging"). The key kernel and the query
// kernel's sweeps load and pack them before they issue the copies.
//
// Query kernel: one block per (BWD_ROWS query rows, sequence, head), warps
// of 16 rows. Up to KT keys, V, then K are staged once; dpd = scores(dA
// rows, V); after a barrier (every warp is done with V) dp goes to shared
// memory in V's place, each thread's own values in its own slots (no two
// tiles of 80 f32 a thread live at once: forward_block already takes ~250
// registers with one); s = scores(Q rows, K), the softmax as forward_block
// forms it, D, ds in place of p, then dq = pv_group(ds, K) one group of 32
// dh columns at a time. Past KT keys four sweeps over KT-key tiles,
// restaged: the rows' max, their sum, D, then ds and dq, each tile's dq
// added to what the earlier tiles stored (the block owns its rows).
//
// Key kernel: one block per (BWD_ROWS keys, sequence, head), warps of 16
// keys; a query tile (up to KT queries: every query up to S = KT) of dA and
// Q and the queries' stats staged; dpd^T = scores(V rows, dA) -> dp^T to
// the warp's slots; s^T = scores(K rows, Q) -> p^T from the stats, ds^T =
// p^T (dp^T - D) x scale to the slots in dp^T's place and pd^T = p^T keep
// in the registers; dv = pv_group(pd^T, dA), then ds^T back into the
// registers and dk = pv_group(ds^T, Q), each group stored as it is done.
// Past KT queries each tile's dk and dv are added to what the earlier tiles
// stored (the block owns its keys' rows, so each sum stays in one order).
// At S = 145, dh = 128: the query kernel 169 KB of shared memory, the key
// kernel 222 KB (Q and dA 84 KB each, the slots 51 KB); one block per SM.

constexpr int BWD_WARPS = 5;
constexpr int BWD_ROWS = 16 * BWD_WARPS;  // query rows (query kernel) or keys (key kernel) per block
constexpr int BWD_THREADS = 32 * BWD_WARPS;
static_assert(KT <= BWD_THREADS, "the key kernel stages one query's stats per thread");

// keys of the query kernel's tile, queries of the key kernel's: a multiple of 16
__host__ __device__ inline int bwd_tile(int S) { return tiled(S) ? KT : keys_pad(S); }

// floats of the query kernel's V tile, whose place then takes the warps' dp
__host__ __device__ inline int bwd_v_floats(int S, int dh) {
  const int kt = bwd_tile(S), v = kt * (dh_pad(dh) + 4), dp = BWD_ROWS * kt;
  return v > dp ? v : dp;
}

// K, V (then dp)
inline size_t bwd_query_smem(int S, int dh) {
  return sizeof(float) * ((size_t)bwd_tile(S) * (dh_pad(dh) + 4) + bwd_v_floats(S, dh));
}

// dA and Q of a query tile, the warps' slots (dp^T, then ds^T), the
// queries' (max, sum, 1 / sum, D)
inline size_t bwd_key_smem(int S, int dh) {
  const size_t qt = bwd_tile(S);
  return sizeof(float) * (2 * qt * (dh_pad(dh) + 4) + (size_t)BWD_ROWS * qt + 4 * qt);
}

// blockIdx.x = the block's rows (query kernel) or keys (key kernel), blockIdx.y = b * H + h: the
// blocks that stage one (sequence, head)'s tiles run together, so the later ones read them from L2
inline dim3 bwd_grid(int B, int S, int H) { return dim3((S + BWD_ROWS - 1) / BWD_ROWS, B * H); }

// the mask bytes of this thread's 80 accumulators of a score tile:
// mask[row][col] of the (sequence, head)'s [S][S] int8 slab at (row, col) =
// rc(j, e), 0 past S. 80 independent loads: issued before a tile's staging
// copies, they are in flight while it lands (issued after them, they wait
// behind them); keep_bits packs them once the copies are issued.
template <typename RC>
__device__ __forceinline__ void load_keep(int8_t (&kbytes)[NJ][4], const int8_t* mslab, int S, RC rc) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 x = rc(j, e);
      const bool ok = (x.x < S) & (x.y < S);  // the load itself unconditional: all 80 in flight at once
      const int8_t v = mslab[ok ? (size_t)x.x * S + x.y : 0];
      kbytes[j][e] = ok ? v : 0;
    }
  }
}

// bit 4j + e of kb[(4j + e) / 32]: accumulator e of tile j is kept
__device__ __forceinline__ void keep_bits(uint32_t (&kb)[3], const int8_t (&kbytes)[NJ][4]) {
  kb[0] = kb[1] = kb[2] = 0u;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) kb[(4 * j + e) / 32] |= (uint32_t)(kbytes[j][e] != 0) << ((4 * j + e) % 32);
  }
}

__device__ __forceinline__ float keep_of(const uint32_t (&kb)[3], int j, int e, float inv_keep) {
  return (kb[(4 * j + e) / 32] >> ((4 * j + e) % 32)) & 1u ? inv_keep : 0.0f;
}

// the shared-memory slot of accumulator e of tile j in a warp's [16 x n]
// tile (each thread reads back only what it wrote)
__device__ __forceinline__ int slot(int j, int e, int lane) { return (4 * j + e) * 32 + lane; }

// o (pv_group's layout) <- rows r_lo and r_lo + 8 of what store_group wrote (zeros past S)
__device__ __forceinline__ void load_group(float (&o)[4][4], const float* in, int stride, int r_lo, int S, int m,
                                           int dh, int t) {
  const int c = 32 * m + 8 * t;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    const float* row = in + (size_t)r * stride;
    const float4 x0 = r < S && c < dh ? ld4(row + c) : z, x1 = r < S && c + 4 < dh ? ld4(row + c + 4) : z;
    o[0][2 * h] = x0.x, o[1][2 * h] = x0.y, o[2][2 * h] = x0.z, o[3][2 * h] = x0.w;
    o[0][2 * h + 1] = x1.x, o[1][2 * h + 1] = x1.y, o[2][2 * h + 1] = x1.z, o[3][2 * h + 1] = x1.w;
  }
}

// dq (columns h dh of dqkv) and stats [3][B * H][S]: the rows' max, sum, D
template <bool TILED>
__device__ inline void bwd_query_block(const float* __restrict__ qkv, const float* __restrict__ dA,
                                       const int8_t* __restrict__ mask, float* __restrict__ dqkv,
                                       float* __restrict__ stats, int S, int H, int dh, float scale,
                                       float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, stride = 3 * D, ld = dh_pad(dh) + 4, groups = dh_pad(dh) / 32, kt = bwd_tile(S);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * BWD_ROWS, nrows = min(BWD_ROWS, S - row0);
  const int r_lo = row0 + 16 * warp + g, r_hi = r_lo + 8;  // this thread's two query rows
  const float* base = qkv + (size_t)b * S * stride + h * dh;
  const float* q_lo = base + (size_t)r_lo * stride;
  const float* q_hi = base + (size_t)r_hi * stride;
  const float* a_lo = dA + ((size_t)b * S + r_lo) * D + h * dh;
  const float* a_hi = a_lo + 8 * (size_t)D;
  const int8_t* mslab = mask + (size_t)bh * S * S;
  float* Ks = smem;
  float* Vs = Ks + kt * ld;
  float* dps = Vs + warp * 16 * kt;  // the warp's dp, in V's place
  float* obase = dqkv + (size_t)b * S * stride + h * dh;
  float s[NJ][4];
  float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo = 0.0f, sum_hi = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
  uint32_t kb[3];  // the keep bits of the thread's (row, key) pairs of the tile
  int8_t kbytes[NJ][4];
  auto keep_bytes = [&](int k0) {
    load_keep(kbytes, mslab, S,
              [&](int j, int e) { return make_int2(e < 2 ? r_lo : r_hi, k0 + 8 * j + 2 * t + (e & 1)); });
  };
  // dpd (in s) -> dp = dpd keep, to the warp's slots (keys of the tile)
  auto dp_to_smem = [&](int nj) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) dps[slot(j, e, lane)] = __fmul_rn(s[j][e], keep_of(kb, j, e, inv_keep));
    }
  };

  if (!TILED) {
    const int nj = kt / 8;
    const bool live = 16 * warp < nrows;
    if (live) keep_bytes(0);
    // V first, in a group of its own: dpd starts when it has landed
    stage(Vs, ld, base + 2 * D, stride, S, kt, dh);
    cp_async_commit();
    stage(Ks, ld, base + D, stride, S, kt, dh);
    cp_async_commit();
    if (live) keep_bits(kb, kbytes);
    cp_async_wait_group<1>();
    __syncthreads();
    // dpd = dA.V^T (-> dp to the slots), then s = Q.K^T: one call site
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (live) scores(s, pass ? q_lo : a_lo, pass ? q_hi : a_hi, r_lo < S, r_hi < S, pass ? Ks : Vs, ld, nj, dh, lane);
      if (pass) break;
      cp_async_wait_group<0>();
      __syncthreads();  // K has landed; every warp is done with V
      if (live) dp_to_smem(nj);
    }
    if (!live) return;
    row_softmax<true>(s, S, scale, t, mx_lo, mx_hi, sum_lo, sum_hi);
    // D = sum_k dp p (each thread its keys in order, then the quad), then
    // ds = p (dp - D) scale in p's place
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d_lo += __fmul_rn(dps[slot(j, e, lane)], s[j][e]);
        d_hi += __fmul_rn(dps[slot(j, 2 + e, lane)], s[j][2 + e]);
      }
    }
    d_lo = quad_sum(d_lo);
    d_hi = quad_sum(d_hi);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dp = j < nj ? dps[slot(j, e, lane)] : 0.0f;
        s[j][e] = __fmul_rn(__fmul_rn(s[j][e], __fsub_rn(dp, e < 2 ? d_lo : d_hi)), scale);
      }
    }
    for (int m = 0; m < groups; ++m) {
      float o[4][4] = {};
      pv_group(o, s, Ks, ld, m, nj, lane);
      store_group(obase, stride, r_lo, S, o, m, dh, t);
    }
  } else {
    // S > KT: four sweeps over KT-key tiles: the rows' max, their sum, D,
    // then ds and dq (dq's sums in dqkv between tiles, as the key kernel
    // keeps dk and dv: in registers they spilled)
    float rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll 1
    for (int pass = 0; pass < 4; ++pass) {
      for (int k0 = 0; k0 < S; k0 += KT) {
        const int nk = min(KT, S - k0), nj = keys_pad(nk) / 8;
        __syncthreads();  // the previous tile (K, V, dp) is done with
        if (pass >= 2) {  // the keep bits first, before the staging's copies queue ahead of their loads
          keep_bytes(k0);
          keep_bits(kb, kbytes);
        }
        stage(Ks, ld, base + (size_t)k0 * stride + D, stride, nk, 8 * nj, dh);
        if (pass >= 2) stage(Vs, ld, base + (size_t)k0 * stride + 2 * D, stride, nk, 8 * nj, dh);
        cp_async_wait();
        __syncthreads();
#pragma unroll 1
        for (int which = pass >= 2 ? 0 : 1; which < 2; ++which) {  // dpd (passes 2 and 3), then s
          scores(s, which ? q_lo : a_lo, which ? q_hi : a_hi, r_lo < S, r_hi < S, which ? Ks : Vs, ld, nj, dh, lane);
          if (which) break;
          __syncthreads();  // every warp is done with V
          dp_to_smem(nj);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo = e < 2;
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const float x = col < S ? __fmul_rn(s[j][e], scale) : -INFINITY;
            if (pass == 0) {
              if (lo) mx_lo = fmaxf(mx_lo, x);
              else mx_hi = fmaxf(mx_hi, x);
            } else if (pass == 1) {
              if (lo) sum_lo += expf(x - mx_lo);
              else sum_hi += expf(x - mx_hi);
            } else {
              const float p = div_rn(expf(x - (lo ? mx_lo : mx_hi)), lo ? sum_lo : sum_hi, lo ? rs_lo : rs_hi);
              const float dp = j < nj ? dps[slot(j, e, lane)] : 0.0f;
              if (pass == 2) {
                if (lo) d_lo += __fmul_rn(dp, p);
                else d_hi += __fmul_rn(dp, p);
              } else {
                s[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, lo ? d_lo : d_hi)), scale);
              }
            }
          }
        }
        if (pass == 3) {
          for (int m = 0; m < groups; ++m) {
            float o[4][4] = {};
            if (k0) load_group(o, obase, stride, r_lo, S, m, dh, t);
            pv_group(o, s, Ks, ld, m, nj, lane);
            store_group(obase, stride, r_lo, S, o, m, dh, t);
          }
        }
      }
      if (pass == 0) mx_lo = quad_max(mx_lo), mx_hi = quad_max(mx_hi);
      if (pass == 1) {
        sum_lo = quad_sum(sum_lo), sum_hi = quad_sum(sum_hi);
        rs_lo = __frcp_rn(sum_lo), rs_hi = __frcp_rn(sum_hi);
      }
      if (pass == 2) d_lo = quad_sum(d_lo), d_hi = quad_sum(d_hi);
    }
  }
  if (t == 0) {
    const size_t n = (size_t)gridDim.y * S, i = (size_t)bh * S;
    if (r_lo < S) stats[i + r_lo] = mx_lo, stats[n + i + r_lo] = sum_lo, stats[2 * n + i + r_lo] = d_lo;
    if (r_hi < S) stats[i + r_hi] = mx_hi, stats[n + i + r_hi] = sum_hi, stats[2 * n + i + r_hi] = d_hi;
  }
}

// dk and dv (columns D + h dh and 2 D + h dh of dqkv) from the query kernel's stats
template <bool TILED>
__device__ inline void bwd_key_block(const float* __restrict__ qkv, const float* __restrict__ dA,
                                     const int8_t* __restrict__ mask, const float* __restrict__ stats,
                                     float* __restrict__ dqkv, int S, int H, int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, stride = 3 * D, ld = dh_pad(dh) + 4, groups = dh_pad(dh) / 32, qt = bwd_tile(S);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int key0 = blockIdx.x * BWD_ROWS;
  const int k_lo = key0 + 16 * warp + g, k_hi = k_lo + 8;  // this thread's two keys
  const bool live = 16 * warp < S - key0;
  const float* base = qkv + (size_t)b * S * stride + h * dh;
  const float* krow = base + (size_t)k_lo * stride + D;
  const float* vrow = krow + D;
  const int8_t* mslab = mask + (size_t)bh * S * S;
  float* As = smem;                                      // [qt][ld]: dA of the query tile
  float* Qs = As + qt * ld;                              // [qt][ld]: its Q
  float* dps = Qs + qt * ld + warp * 16 * qt;            // the warp's dp^T, then ds^T
  auto* St = reinterpret_cast<float4*>(Qs + qt * ld + BWD_ROWS * qt);  // [qt]: the queries' max, sum, 1 / sum, D
  const size_t n = (size_t)gridDim.y * S;
  const float* st = stats + (size_t)bh * S;
  float* obase = dqkv + (size_t)b * S * stride + h * dh;
  float s[NJ][4];
  uint32_t kb[3];  // the keep bits of the thread's (query, key) pairs of the tile

  for (int q0 = 0; q0 < S; q0 += qt) {
    const int nq = min(qt, S - q0), nj = keys_pad(nq) / 8;
    if (TILED) __syncthreads();  // the previous tile is done with
    // the keep bits first, before the staging's copies are issued (after
    // them the kernel ran 4% faster at S = 145 but 7-9% slower at S = 161 and
    // 1024: the variants script's "keep bits after the staging")
    if (live) {
      int8_t kbytes[NJ][4];
      load_keep(kbytes, mslab, S,
                [&](int j, int e) { return make_int2(q0 + 8 * j + 2 * t + (e & 1), e < 2 ? k_lo : k_hi); });
      keep_bits(kb, kbytes);
    }
    // the stats of query i (one per thread: 8 nj <= KT = blockDim.x), loaded before the staging
    const int i = threadIdx.x;
    const bool ok = i < nq;
    const float mx = ok ? st[q0 + i] : 0.0f, sum = ok ? st[n + q0 + i] : 1.0f, d = ok ? st[2 * n + q0 + i] : 0.0f;
    stage(As, ld, dA + ((size_t)b * S + q0) * D + h * dh, D, nq, 8 * nj, dh);
    cp_async_commit();
    stage(Qs, ld, base + (size_t)q0 * stride, stride, nq, 8 * nj, dh);
    cp_async_commit();
    if (i < 8 * nj) St[i] = make_float4(mx, sum, __frcp_rn(sum), d);
    cp_async_wait_group<1>();
    __syncthreads();  // dA and the stats have landed
    // dpd^T = V.dA^T (-> dp^T to the slots), then s^T = K.Q^T: one call site
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const float* a = pass ? krow : vrow;
      if (live) scores(s, a, a + 8 * (size_t)stride, k_lo < S, k_hi < S, pass ? Qs : As, ld, nj, dh, lane);
      if (pass) break;
      if (live) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) dps[slot(j, e, lane)] = __fmul_rn(s[j][e], keep_of(kb, j, e, inv_keep));
        }
      }
      cp_async_wait_group<0>();
      __syncthreads();  // Q has landed
    }
    if (!live) continue;  // no keys for this warp (it still met every barrier)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1);
        const float4 st4 = St[ql];  // max, sum, 1 / sum, D
        const float p = q0 + ql < S ? div_rn(expf(__fmul_rn(s[j][e], scale) - st4.x), st4.y, st4.z) : 0.0f;
        float& x = dps[slot(j, e, lane)];
        x = __fmul_rn(__fmul_rn(p, __fsub_rn(x, st4.w)), scale);  // ds^T in dp^T's place
        s[j][e] = __fmul_rn(p, keep_of(kb, j, e, inv_keep));    // pd^T
      }
    }
    // dv += pd^T.dA, then dk += ds^T.Q (ds^T back from the slots): one call site
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (pass) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = j < nj ? dps[slot(j, e, lane)] : 0.0f;
        }
      }
      float* out = obase + (pass ? D : 2 * D);
      for (int m = 0; m < groups; ++m) {
        float o[4][4] = {};
        if (TILED && q0) load_group(o, out, stride, k_lo, S, m, dh, t);
        pv_group(o, s, pass ? Qs : As, ld, m, nj, lane);
        store_group(out, stride, k_lo, S, o, m, dh, t);
      }
    }
  }
}

}  // namespace attn_tf32
}  // namespace rohm
