// The f32 attention forward on the SIMT cores, with the keys streamed
// through shared memory in tiles: the body of attention_f32.cu (K1) and of
// the f32 mode of attention_train.cu's forward (K6).
//
// One block per (48 query rows, sequence, head), 12 warps. The tile's Q
// rows stay in shared memory; K and V come in tiles of up to KT keys, each
// row read in place from the QKV buffer with 16-byte loads. Both products
// are register-tiled: a thread accumulates 4 query rows against one key,
// then 4 rows x 4 output columns against the probs, which are stored
// key-major so one float4 load gives a key's probs for 4 rows. The output
// accumulators stay in registers across the key tiles (one task of 4 x 4
// per thread: dh <= 128), so P.V sums keys in the order j = 0, 1, ... as a
// plain loop would.
//
// The softmax is exact over the row, never rescaled: when one tile holds
// every key (S <= KT) the scores are staged once and the row's max, sum
// and probs come from them; a longer sequence takes a sweep over the key
// tiles for the row's max, one for its sum (sum of exp(s - max), each
// tile's part added in key order), and a last one that forms the probs
// from those and accumulates P.V. So p = exp(s - max) / sum as in the
// plain version at every S.
//
// TRAIN: the scores are scaled after the product (x scale) and the probs
// multiplied by the dropout keep-mask [B, H, S, S] int8 times inv_keep
// (K6's arithmetic); otherwise Q arrives pre-scaled and nothing is
// dropped (K1's).
#pragma once

#include "common.cuh"

namespace rohm {
namespace attn_simt {

constexpr int QT = 48;        // query rows per block
constexpr int RM = 4;         // rows per thread task in both products
constexpr int THREADS = 384;  // 12 warps
constexpr int KT = 160;       // keys per tile: S <= 160 is staged once (224 KB at dh = 128)
constexpr int MAX_DH = 128;   // one 4 x 4 output task per thread

inline size_t smem_bytes(int S, int dh) {
  const size_t kt = S < KT ? S : KT;
  return sizeof(float) * (kt * (dh + 4) + kt * dh + (size_t)QT * dh + kt * (QT + 4) + 2 * QT);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

template <bool TRAIN>
__device__ inline void forward_block(const float* __restrict__ qkv, const int8_t* __restrict__ mask,
                                     float* __restrict__ out, int S, int H, int dh, float scale,
                                     float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int kt = S < KT ? S : KT, nt = (S + KT - 1) / KT;
  const int D = H * dh, row_stride = 3 * D, ldk = dh + 4, ldp = QT + 4, d4 = dh / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * QT;
  const int nq = min(QT, S - q0);
  float* Ks = smem;           // [kt][dh + 4]: 8 lanes reading 8 keys hit 32 banks
  float* Vs = Ks + kt * ldk;  // [kt][dh]
  float* Qs = Vs + kt * dh;   // [QT][dh]
  float* Pt = Qs + QT * dh;   // [kt][QT + 4]: scores, then probs, key-major
  float* rmax = Pt + kt * ldp;
  float* rsum = rmax + QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;
  const int8_t* mrow = TRAIN ? mask + ((size_t)blockIdx.y * S + q0) * S : nullptr;

  for (int e = tid; e < QT * d4; e += THREADS) {
    const int r = e / d4, c = (e % d4) * 4;
    st4(Qs + r * dh + c, r < nq ? ld4(base + (size_t)(q0 + r) * row_stride + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
  // keys [k0, k0 + nk): K, and V when the probs will be applied
  auto stage = [&](int k0, int nk, bool with_v) {
    for (int e = tid; e < nk * d4; e += THREADS) {
      const int r = e / d4, c = (e % d4) * 4;
      const float* row = base + (size_t)(k0 + r) * row_stride + c;
      st4(Ks + r * ldk + c, ld4(row + D));
      if (with_v) st4(Vs + r * dh + c, ld4(row + 2 * D));
    }
  };
  // Pt[c][g*RM + i] = Q[g*RM + i] . K[c] (x scale): thread task = (RM rows, one key)
  auto scores = [&](int nk) {
    for (int t = tid; t < (QT / RM) * nk; t += THREADS) {
      const int g = t / nk, c = t % nk;
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
      if (TRAIN) {
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i] = __fmul_rn(acc[i], scale);
      }
      st4(Pt + c * ldp + g * RM, make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
  };

  // the row statistics: max, then sum of exp(s - max), per query row (one warp)
  if (nt == 1) {
    stage(0, S, true);
    __syncthreads();
    scores(S);
    __syncthreads();
    for (int r = warp; r < nq; r += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < S; c += 32) mx = fmaxf(mx, Pt[c * ldp + r]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < S; c += 32) sum += expf(Pt[c * ldp + r] - mx);
      sum = warp_sum(sum);
      if (lane == 0) rmax[r] = mx, rsum[r] = sum;
    }
  } else {
    if (tid < QT) rmax[tid] = -INFINITY, rsum[tid] = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < S; k0 += KT) {
        const int nk = min(KT, S - k0);
        __syncthreads();
        stage(k0, nk, false);
        __syncthreads();
        scores(nk);
        __syncthreads();
        for (int r = warp; r < nq; r += nwarps) {
          if (pass == 0) {
            float mx = -INFINITY;
            for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, Pt[c * ldp + r]);
            mx = warp_max(mx);
            if (lane == 0) rmax[r] = fmaxf(rmax[r], mx);
          } else {
            const float mx = rmax[r];
            float sum = 0.0f;
            for (int c = lane; c < nk; c += 32) sum += expf(Pt[c * ldp + r] - mx);
            sum = warp_sum(sum);
            if (lane == 0) rsum[r] += sum;
          }
        }
      }
    }
  }
  __syncthreads();

  // out = P.V (pd.V in TRAIN): thread task = (4 query rows, 4 output columns)
  const int tasks = (QT / RM) * d4, g = tid / d4, c4 = (tid % d4) * 4;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += KT) {
    const int nk = min(KT, S - k0);
    if (nt > 1) {
      __syncthreads();
      stage(k0, nk, true);
      __syncthreads();
      scores(nk);
      __syncthreads();
    }
    for (int r = warp; r < nq; r += nwarps) {
      const float mx = rmax[r], sum = rsum[r];
      for (int c = lane; c < nk; c += 32) {
        float p = __fdiv_rn(expf(Pt[c * ldp + r] - mx), sum);
        if (TRAIN) p = __fmul_rn(p, mrow[(size_t)r * S + k0 + c] ? inv_keep : 0.0f);
        Pt[c * ldp + r] = p;
      }
    }
    __syncthreads();
    if (tid < tasks) {
      for (int j = 0; j < nk; ++j) {
        const float4 p = ld4(Pt + j * ldp + g * RM);
        const float4 v = ld4(Vs + j * dh + c4);
        const float pr[RM] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][0] = fmaf(pr[i], v.x, acc[i][0]);
          acc[i][1] = fmaf(pr[i], v.y, acc[i][1]);
          acc[i][2] = fmaf(pr[i], v.z, acc[i][2]);
          acc[i][3] = fmaf(pr[i], v.w, acc[i][3]);
        }
      }
    }
  }
  if (tid < tasks) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = g * RM + i;
      if (r < nq)
        st4(out + ((size_t)b * S + q0 + r) * D + h * dh + c4, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

}  // namespace attn_simt
}  // namespace rohm
