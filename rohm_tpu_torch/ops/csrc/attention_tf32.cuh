// The f32 attention forward on the tensor cores (3xTF32), with the keys
// streamed through shared memory in tiles: the body of attention_f32.cu
// (K1) and of the f32 mode of attention_train.cu's forward (K6).
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
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = score(s[j][e], 8 * j + 2 * t + (e & 1));
          mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
        }
        mx_lo = quad_max(mx_lo);
        mx_hi = quad_max(mx_hi);
        float sum_lo = 0.0f, sum_hi = 0.0f;
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

}  // namespace attn_tf32
}  // namespace rohm
