// attention_train: the per-(sequence, head) self-attention of the PoseNet
// training layer, forward and backward, with dropout on the probabilities.
//
// Forward, out [B*S, D] from qkv [B*S, 3D] (f32, q/k/v read in place):
//   scores = c(q) . c(k)^T * scale;  p = softmax(scores) (max-subtracted f32)
//   pd = p * (mask * inv_keep);       out = c(pd) . c(v)
// Backward, dqkv [B*S, 3D] from qkv, dA = d(out) [B*S, D] and the mask:
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
// group in VMEM; an SM has 227 KB, so:
//   forward, bf16 mode: one block per (sequence, head) reads K and V once,
//            rounded to bf16 into shared memory (108 KB with the mask at
//            S = 145, dh = 128: two blocks per SM, all 256 pairs of the
//            training batch in one wave); each warp takes 16 query rows,
//            its Q fragments straight from device memory, and runs both
//            products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//            sums). The warp
//            keeps its whole 16 x S score tile in registers, so the softmax
//            is exact over the row (no online rescaling), with the rounding
//            points of the plain version (p = e * (1 / sum), within an f32
//            ulp of e / sum); the rounded pd passes from the accumulators of
//            the first product into the A fragments of the second. The
//            mask slab of the (sequence, head) is staged in shared memory
//            with K and V. Bound: its bytes (qkv and the mask read, the
//            output written);
//   forward, f32 mode: one block per (48 query rows, sequence, head) with
//            K and V in shared memory (205 KB at S = 145, dh = 128), SIMT;
//   backward pass 1: one block per (32 query rows, sequence, head): K, V,
//            the tile's Q then dA, its p and dp/ds rows (211 KB): writes dq
//            and, to a scratch of [B, H, S, S] f32 each, pd and ds;
//   backward pass 2: one block per (32 keys, sequence, head): all of the
//            sequence's Q and dA (148 KB) and the key tile's columns of pd
//            and ds: writes dk and dv.
// P is recomputed from Q and K (nothing of [B, H, S, S] is kept from the
// forward); the two-pass split keeps every sum in one block, so dq, dk and
// dv need no atomics. Bound of the SIMT kernels: f32 FMA issue and
// shared-memory bandwidth (2.8 GFLOP forward, 5.5 backward per layer at
// B = 64, S = 145).
#include "common.cuh"

namespace {

constexpr int RM = 4;  // rows per thread task in every product

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool BF16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z), rnd<BF16>(v.w));
}

// rows [0, nrows) of one head's q/k/v column block -> smem [rows][ld], rounded;
// rows in [nrows, cap) are zero
template <bool BF16>
__device__ void load_rows(float* dst, int ld, const float* src, int row_stride, int nrows, int cap,
                          int dh, int tid, int nthreads) {
  const int d4 = dh / 4;
  for (int e = tid; e < cap * d4; e += nthreads) {
    const int r = e / d4, c = (e % d4) * 4;
    st4(dst + r * ld + c, r < nrows ? rnd4<BF16>(ld4(src + (size_t)r * row_stride + c))
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
}

// Pt[c][g*RM + i] = (X[g*RM + i] . Y[c]) * scale for every key c < S:
// thread task = (RM rows of X, one row of Y)
__device__ void products_xy(float* Pt, int ldp, const float* X, int ldx, const float* Y, int ldy,
                            int S, int nrows_pad, int dh, float scale, bool scaled, int tid,
                            int nthreads) {
  for (int t = tid; t < (nrows_pad / RM) * S; t += nthreads) {
    const int g = t / S, c = t % S;
    const float* y = Y + c * ldy;
    const float* x = X + g * RM * ldx;
    float acc[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i] = 0.0f;
    for (int d = 0; d < dh; d += 4) {
      const float4 yv = ld4(y + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 xv = ld4(x + i * ldx + d);
        acc[i] = fmaf(xv.x, yv.x, acc[i]);
        acc[i] = fmaf(xv.y, yv.y, acc[i]);
        acc[i] = fmaf(xv.z, yv.z, acc[i]);
        acc[i] = fmaf(xv.w, yv.w, acc[i]);
      }
    }
    if (scaled) {
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i] = __fmul_rn(acc[i], scale);
    }
    st4(Pt + c * ldp + g * RM, make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
}

// f32 softmax of row r over its S keys (one warp), in place in Pt
__device__ __forceinline__ void softmax_row(float* Pt, int ldp, int r, int S, int lane) {
  float mx = -INFINITY;
  for (int c = lane; c < S; c += 32) mx = fmaxf(mx, Pt[c * ldp + r]);
  mx = rohm::warp_max(mx);
  float sum = 0.0f;
  for (int c = lane; c < S; c += 32) sum += expf(Pt[c * ldp + r] - mx);
  sum = rohm::warp_sum(sum);
  for (int c = lane; c < S; c += 32) Pt[c * ldp + r] = __fdiv_rn(expf(Pt[c * ldp + r] - mx), sum);
}

// ---------------------------------------------------------------------------
// forward, f32 mode: SIMT
// ---------------------------------------------------------------------------

constexpr int FQT = 48, FTHREADS = 384;

__global__ void __launch_bounds__(FTHREADS) attention_train_fwd_kernel(
    const float* __restrict__ qkv, const int8_t* __restrict__ mask, float* __restrict__ out, int S,
    int H, int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, row_stride = 3 * D, ldk = dh + 4, ldp = FQT + 4, d4 = dh / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * FQT;
  const int nq = min(FQT, S - q0);
  float* Ks = smem;          // [S][dh + 4]
  float* Vs = Ks + S * ldk;  // [S][dh]
  float* Qs = Vs + S * dh;   // [FQT][dh]
  float* Pt = Qs + FQT * dh; // [S][FQT + 4]: scores, then pd, key-major
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;
  const int8_t* mrow = mask + ((size_t)blockIdx.y * S + q0) * S;

  load_rows<false>(Ks, ldk, base + D, row_stride, S, S, dh, tid, FTHREADS);
  load_rows<false>(Vs, dh, base + 2 * D, row_stride, S, S, dh, tid, FTHREADS);
  load_rows<false>(Qs, dh, base + (size_t)q0 * row_stride, row_stride, nq, FQT, dh, tid, FTHREADS);
  __syncthreads();
  products_xy(Pt, ldp, Qs, dh, Ks, ldk, S, FQT, dh, scale, true, tid, FTHREADS);
  __syncthreads();
  for (int r = warp; r < nq; r += FTHREADS / 32) {
    softmax_row(Pt, ldp, r, S, lane);
    __syncwarp();
    for (int c = lane; c < S; c += 32) {
      const float keep = mrow[(size_t)r * S + c] ? inv_keep : 0.0f;
      Pt[c * ldp + r] = __fmul_rn(Pt[c * ldp + r], keep);
    }
  }
  __syncthreads();

  // out = pd . v: thread task = (4 query rows, 4 output columns)
  for (int t = tid; t < (FQT / RM) * d4; t += FTHREADS) {
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

// ---------------------------------------------------------------------------
// forward, bf16 mode: tensor cores, one block per (sequence, head)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 5, TC_THREADS = 32 * TC_WARPS;
constexpr int TC_MAX_S = 160, TC_MAX_DH = 128;  // registers: a 16 x 160 score tile per warp
constexpr int TC_ROWS = 8;                      // K/V rows per warp and staging step

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d[16x8] += a[16x16] . b[16x8], bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 ld2_or0(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragments (lane = 4 g + q): an accumulator tile [16 x 8] holds, per
// thread, (row g, columns 2q, 2q + 1) and (row g + 8, the same columns);
// the A fragment of a [16 x 16] slice holds (g, 2q..), (g + 8, 2q..),
// (g, 2q + 8..), (g + 8, 2q + 8..). So two neighbouring accumulator tiles
// of the first product are one A fragment of the second.
__global__ void __launch_bounds__(TC_THREADS, 2) attention_train_fwd_tc_kernel(
    const float* __restrict__ qkv, const int8_t* __restrict__ mask, float* __restrict__ out, int S,
    int H, int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) __nv_bfloat16 kv[];
  const int D = H * dh, row_stride = 3 * D;
  const int ld = dh + 8;               // bf16 per row: 16 bytes of skew keep ldmatrix conflict-free
  const int sp = (S + 15) / 16 * 16;   // keys (and query rows) padded to 16
  __nv_bfloat16* Ks = kv;              // [sp][ld], rows >= S zero
  __nv_bfloat16* Vs = kv + sp * ld;
  int8_t* Ms = reinterpret_cast<int8_t*>(Vs + sp * ld);  // the mask slab, at its address's offset mod 16
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;

  // The first row tile's c(q) A fragments are loaded now, so that their
  // latency overlaps the staging. Fragment (lane = 4 g + q): rows g and
  // g + 8 of the tile, columns 16 kk + 2 q (+1) and + 8 (+9).
  float2 qraw[TC_MAX_DH / 16][4];
  auto load_q = [&](int t) {
    const int r_lo = 16 * t + g, r_hi = r_lo + 8;
    const float* q_lo = base + (size_t)r_lo * row_stride;
    const float* q_hi = base + (size_t)r_hi * row_stride;
#pragma unroll
    for (int kk = 0; kk < TC_MAX_DH / 16; ++kk) {
      if (16 * kk < dh) {
        const int c = 16 * kk + 2 * q;
        qraw[kk][0] = ld2_or0(q_lo + c, r_lo < S);
        qraw[kk][1] = ld2_or0(q_hi + c, r_hi < S);
        qraw[kk][2] = ld2_or0(q_lo + c + 8, r_lo < S);
        qraw[kk][3] = ld2_or0(q_hi + c + 8, r_hi < S);
      }
    }
  };
  load_q(warp);

  // K and V, each read once, rounded to bf16: each warp takes TC_ROWS rows
  // at a time, a lane per 4 columns, so 2 * TC_ROWS loads are in flight
  for (int r0 = TC_ROWS * warp; r0 < sp; r0 += TC_ROWS * TC_WARPS) {
    float4 kr[TC_ROWS], vr[TC_ROWS];
#pragma unroll
    for (int u = 0; u < TC_ROWS; ++u) {
      const bool in = r0 + u < S && 4 * lane < dh;
      const float* row = base + (size_t)(r0 + u) * row_stride + 4 * lane;
      kr[u] = in ? ld4(row + D) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vr[u] = in ? ld4(row + 2 * D) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < TC_ROWS; ++u) {
      if (r0 + u < sp && 4 * lane < dh) {
        *reinterpret_cast<uint2*>(Ks + (r0 + u) * ld + 4 * lane) =
            make_uint2(pack_bf16(kr[u].x, kr[u].y), pack_bf16(kr[u].z, kr[u].w));
        *reinterpret_cast<uint2*>(Vs + (r0 + u) * ld + 4 * lane) =
            make_uint2(pack_bf16(vr[u].x, vr[u].y), pack_bf16(vr[u].z, vr[u].w));
      }
    }
  }
  // this (sequence, head)'s [S][S] mask: its 16-byte aligned interior in
  // 16-byte loads, the ragged ends byte by byte; smem keeps the address's
  // offset mod 16, so both sides stay aligned
  const int8_t* mslab = mask + (size_t)blockIdx.x * S * S;
  const uintptr_t m0 = reinterpret_cast<uintptr_t>(mslab), m1 = m0 + (size_t)S * S;
  const uintptr_t a0 = (m0 + 15) & ~uintptr_t(15), a1 = m1 & ~uintptr_t(15);
  const int moff = static_cast<int>(m0 & 15);
  if (a0 < a1) {
    for (int i = threadIdx.x; i < static_cast<int>((a1 - a0) / 16); i += TC_THREADS)
      *reinterpret_cast<int4*>(Ms + moff + (a0 - m0) + 16 * i) = *reinterpret_cast<const int4*>(a0 + 16 * i);
    if (threadIdx.x < a0 - m0) Ms[moff + threadIdx.x] = mslab[threadIdx.x];
    if (threadIdx.x < m1 - a1) Ms[moff + (a1 - m0) + threadIdx.x] = mslab[(a1 - m0) + threadIdx.x];
  } else {
    for (int i = threadIdx.x; i < S * S; i += TC_THREADS) Ms[moff + i] = mslab[i];
  }
  __syncthreads();

  for (int t = warp; t < sp / 16; t += TC_WARPS) {
    const int r_lo = 16 * t + g, r_hi = r_lo + 8;  // this thread's two query rows
    if (t != warp) load_q(t);
    uint32_t qa[TC_MAX_DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_MAX_DH / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = pack_bf16(qraw[kk][i].x, qraw[kk][i].y);

    // scores: s[j] is keys 8j..8j+7; ldmatrix.x4 gives two key tiles' B
    // fragments (keys 16jp + 0..7 and + 8..15, dh 16kk + 0..7 and + 8..15)
    float s[TC_MAX_S / 8][4];
#pragma unroll
    for (int j = 0; j < TC_MAX_S / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < TC_MAX_DH / 16; ++kk) {
      if (16 * kk >= dh) break;
#pragma unroll
      for (int jp = 0; jp < TC_MAX_S / 16; ++jp) {
        if (16 * jp >= sp) break;
        const int key = 16 * jp + (lane & 7) + ((lane >> 4) << 3);
        const int col = 16 * kk + (((lane >> 3) & 1) << 3);
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(Ks + key * ld + col));
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // exact softmax over the row: scale after the product, keys >= S out
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < TC_MAX_S / 8; ++j) {
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
    for (int j = 0; j < TC_MAX_S / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx_lo);
      s[j][1] = expf(s[j][1] - mx_lo);
      s[j][2] = expf(s[j][2] - mx_hi);
      s[j][3] = expf(s[j][3] - mx_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
    // p = e * (1 / sum): within an f32 ulp of e / sum, and a tenth of the
    // kernel's time cheaper than 80 IEEE divisions per thread
    const float rs_lo = __frcp_rn(sum_lo), rs_hi = __frcp_rn(sum_hi);

    // pd = c(p * keep), packed as the second product's A fragments; the
    // mask is read once per element
    uint32_t pa[TC_MAX_S / 16][4];
#pragma unroll
    for (int j = 0; j < TC_MAX_S / 8; ++j) {
      float pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r_lo : r_hi, col = 8 * j + 2 * q + (e & 1);
        const bool kept = row < S && col < S && Ms[moff + row * S + col];
        pd[e] = __fmul_rn(__fmul_rn(s[j][e], e < 2 ? rs_lo : rs_hi), kept ? inv_keep : 0.0f);
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(pd[0], pd[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pd[2], pd[3]);
    }

    // out = c(pd) . c(v): ldmatrix.trans gives two dh tiles' B fragments
    // (keys 16kc + 0..7 and + 8..15, dh 16np + 0..7 and + 8..15)
    float o[TC_MAX_DH / 8][4];
#pragma unroll
    for (int n = 0; n < TC_MAX_DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < TC_MAX_S / 16; ++kc) {
      if (16 * kc >= sp) break;
#pragma unroll
      for (int np = 0; np < TC_MAX_DH / 16; ++np) {
        if (16 * np >= dh) break;
        const int key = 16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = 16 * np + ((lane >> 4) << 3);
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_u32(Vs + key * ld + col));
        mma_bf16(o[2 * np], pa[kc], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa[kc], vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < TC_MAX_DH / 8; ++n) {
      if (8 * n >= dh) break;
      const int col = h * dh + 8 * n + 2 * q;
      if (r_lo < S)
        *reinterpret_cast<float2*>(out + ((size_t)b * S + r_lo) * D + col) = make_float2(o[n][0], o[n][1]);
      if (r_hi < S)
        *reinterpret_cast<float2*>(out + ((size_t)b * S + r_hi) * D + col) = make_float2(o[n][2], o[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass 1: dq, and pd / ds to the scratch
// ---------------------------------------------------------------------------

constexpr int BQT = 32, BTHREADS = 256;

template <bool BF16>
__global__ void __launch_bounds__(BTHREADS) attention_train_bwd_q_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dA, const int8_t* __restrict__ mask,
    float* __restrict__ dqkv, float* __restrict__ pd_out, float* __restrict__ ds_out, int S, int H,
    int dh, float scale, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, row_stride = 3 * D, ldk = dh + 4, ldp = BQT + 4, d4 = dh / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BQT;
  const int nq = min(BQT, S - q0);
  float* Ks = smem;            // [S][dh + 4]
  float* Vs = Ks + S * ldk;    // [S][dh + 4]
  float* Xs = Vs + S * ldk;    // [BQT][dh]: the tile's Q, then its dA
  float* Pt = Xs + BQT * dh;   // [S][BQT + 4]: p
  float* Dt = Pt + S * ldp;    // [S][BQT + 4]: dpd, then ds
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;
  const size_t sq0 = (size_t)blockIdx.y * S + q0;  // first (b, h, query) row of the [B,H,S,S] arrays
  const int8_t* mrow = mask + sq0 * S;

  load_rows<BF16>(Ks, ldk, base + D, row_stride, S, S, dh, tid, BTHREADS);
  load_rows<BF16>(Vs, ldk, base + 2 * D, row_stride, S, S, dh, tid, BTHREADS);
  load_rows<BF16>(Xs, dh, base + (size_t)q0 * row_stride, row_stride, nq, BQT, dh, tid, BTHREADS);
  __syncthreads();
  products_xy(Pt, ldp, Xs, dh, Ks, ldk, S, BQT, dh, scale, true, tid, BTHREADS);
  __syncthreads();
  for (int r = warp; r < nq; r += BTHREADS / 32) softmax_row(Pt, ldp, r, S, lane);
  load_rows<BF16>(Xs, dh, dA + ((size_t)b * S + q0) * D + h * dh, D, nq, BQT, dh, tid, BTHREADS);
  __syncthreads();
  products_xy(Dt, ldp, Xs, dh, Vs, ldk, S, BQT, dh, 1.0f, false, tid, BTHREADS);
  __syncthreads();
  for (int r = warp; r < nq; r += BTHREADS / 32) {
    float rs = 0.0f;
    for (int c = lane; c < S; c += 32) {
      const float keep = mrow[(size_t)r * S + c] ? inv_keep : 0.0f;
      rs += __fmul_rn(__fmul_rn(Dt[c * ldp + r], keep), Pt[c * ldp + r]);
    }
    rs = rohm::warp_sum(rs);
    for (int c = lane; c < S; c += 32) {
      const float keep = mrow[(size_t)r * S + c] ? inv_keep : 0.0f;
      const float p = Pt[c * ldp + r];
      const float dp = __fmul_rn(Dt[c * ldp + r], keep);
      const float ds = rnd<BF16>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, rs)), scale));
      Dt[c * ldp + r] = ds;
      ds_out[(sq0 + r) * S + c] = ds;
      pd_out[(sq0 + r) * S + c] = rnd<BF16>(__fmul_rn(p, keep));
    }
  }
  // rows >= nq of Dt hold products of zero rows (never stored below)
  __syncthreads();

  // dq = c(ds) . c(k): thread task = (4 query rows, 4 columns)
  for (int t = tid; t < (BQT / RM) * d4; t += BTHREADS) {
    const int g = t / d4, c = (t % d4) * 4;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int j = 0; j < S; ++j) {
      const float4 s4 = ld4(Dt + j * ldp + g * RM);
      const float4 k = ld4(Ks + j * ldk + c);
      const float sr[RM] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(sr[i], k.x, acc[i][0]);
        acc[i][1] = fmaf(sr[i], k.y, acc[i][1]);
        acc[i][2] = fmaf(sr[i], k.z, acc[i][2]);
        acc[i][3] = fmaf(sr[i], k.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = g * RM + i;
      if (r < nq)
        st4(dqkv + ((size_t)b * S + q0 + r) * row_stride + h * dh + c,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass 2: dk and dv of a tile of keys
// ---------------------------------------------------------------------------

constexpr int BKT = 32;

template <bool BF16>
__global__ void __launch_bounds__(BTHREADS) attention_train_bwd_kv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ dA, const float* __restrict__ pd,
    const float* __restrict__ ds, float* __restrict__ dqkv, int S, int H, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int D = H * dh, row_stride = 3 * D, ldt = BKT + 4, d4 = dh / 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H, k0 = blockIdx.x * BKT;
  const int nk = min(BKT, S - k0);
  float* Qs = smem;            // [S][dh]
  float* As = Qs + S * dh;     // [S][dh]
  float* Pk = As + S * dh;     // [S][BKT + 4]: pd[q][k0 + kc]
  float* Sk = Pk + S * ldt;    // [S][BKT + 4]: ds[q][k0 + kc]
  const int tid = threadIdx.x;
  const float* base = qkv + (size_t)b * S * row_stride + h * dh;

  load_rows<BF16>(Qs, dh, base, row_stride, S, S, dh, tid, BTHREADS);
  load_rows<BF16>(As, dh, dA + (size_t)b * S * D + h * dh, D, S, S, dh, tid, BTHREADS);
  const size_t s0 = (size_t)blockIdx.y * S * S;
  for (int e = tid; e < S * BKT; e += BTHREADS) {
    const int q = e / BKT, kc = e % BKT;
    const bool in = kc < nk;
    Pk[q * ldt + kc] = in ? pd[s0 + (size_t)q * S + k0 + kc] : 0.0f;
    Sk[q * ldt + kc] = in ? ds[s0 + (size_t)q * S + k0 + kc] : 0.0f;
  }
  __syncthreads();

  // thread task = (4 keys, 4 columns): dv = pd^T . dA, dk = ds^T . q
  for (int t = tid; t < (BKT / RM) * d4; t += BTHREADS) {
    const int g = t / d4, c = (t % d4) * 4;
    float av[RM][4], ak[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) av[i][j] = ak[i][j] = 0.0f;
    for (int q = 0; q < S; ++q) {
      const float4 p4 = ld4(Pk + q * ldt + g * RM);
      const float4 s4 = ld4(Sk + q * ldt + g * RM);
      const float4 a = ld4(As + q * dh + c);
      const float4 x = ld4(Qs + q * dh + c);
      const float pr[RM] = {p4.x, p4.y, p4.z, p4.w};
      const float sr[RM] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        av[i][0] = fmaf(pr[i], a.x, av[i][0]);
        av[i][1] = fmaf(pr[i], a.y, av[i][1]);
        av[i][2] = fmaf(pr[i], a.z, av[i][2]);
        av[i][3] = fmaf(pr[i], a.w, av[i][3]);
        ak[i][0] = fmaf(sr[i], x.x, ak[i][0]);
        ak[i][1] = fmaf(sr[i], x.y, ak[i][1]);
        ak[i][2] = fmaf(sr[i], x.z, ak[i][2]);
        ak[i][3] = fmaf(sr[i], x.w, ak[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kc = g * RM + i;
      if (kc >= nk) continue;
      float* row = dqkv + ((size_t)b * S + k0 + kc) * row_stride + h * dh + c;
      st4(row + D, make_float4(ak[i][0], ak[i][1], ak[i][2], ak[i][3]));
      st4(row + 2 * D, make_float4(av[i][0], av[i][1], av[i][2], av[i][3]));
    }
  }
}

size_t fwd_smem(int S, int dh) {
  return sizeof(float) * ((size_t)S * (dh + 4) + (size_t)S * dh + (size_t)FQT * dh +
                          (size_t)S * (FQT + 4));
}
size_t bwd_q_smem(int S, int dh) {
  return sizeof(float) * (2 * (size_t)S * (dh + 4) + (size_t)BQT * dh + 2 * (size_t)S * (BQT + 4));
}
size_t bwd_kv_smem(int S, int dh) {
  return sizeof(float) * (2 * (size_t)S * dh + 2 * (size_t)S * (BKT + 4));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int B, int S, int H, int dh) {
  return B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 4 != 0;
}

}  // namespace

// f32 mode: any S whose tiles fit in 227 KB of shared memory (S <= 150 at
// dh = 128); bf16 mode: S <= 160, dh a multiple of 16 up to 128.
extern "C" int rt_attention_train_fwd(const void* qkv, const void* mask, void* out, int B, int S,
                                      int H, int dh, float scale, float inv_keep, int bf16,
                                      void* stream) {
  if (bad_shape(B, S, H, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(qkv);
  const auto* m = static_cast<const int8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (bf16) {
    if (S > TC_MAX_S || dh % 16 || dh > TC_MAX_DH) return (int)cudaErrorInvalidValue;
    // K and V as bf16, then the mask slab (S^2 bytes at an offset < 16)
    const size_t smem = 2 * sizeof(__nv_bfloat16) * (size_t)((S + 15) / 16 * 16) * (dh + 8) + (size_t)S * S + 16;
    cudaError_t err = allow_smem(attention_train_fwd_tc_kernel, smem);
    if (err == cudaSuccess)  // as much shared memory as the SM has: two blocks share it
      err = cudaFuncSetAttribute(attention_train_fwd_tc_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
    attention_train_fwd_tc_kernel<<<B * H, TC_THREADS, smem, s>>>(q, m, o, S, H, dh, scale, inv_keep);
    return (int)cudaGetLastError();
  }
  const size_t smem = fwd_smem(S, dh);
  cudaError_t err = allow_smem(attention_train_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + FQT - 1) / FQT, B * H);
  attention_train_fwd_kernel<<<grid, FTHREADS, smem, s>>>(q, m, o, S, H, dh, scale, inv_keep);
  return (int)cudaGetLastError();
}

// pd_scratch and ds_scratch: [B, H, S, S] f32 each, written by pass 1 and
// read by pass 2 (stream order).
extern "C" int rt_attention_train_bwd(const void* qkv, const void* dA, const void* mask,
                                      void* dqkv, void* pd_scratch, void* ds_scratch, int B, int S,
                                      int H, int dh, float scale, float inv_keep, int bf16,
                                      void* stream) {
  if (bad_shape(B, S, H, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_q = bwd_q_smem(S, dh), smem_kv = bwd_kv_smem(S, dh);
  auto kq = bf16 ? attention_train_bwd_q_kernel<true> : attention_train_bwd_q_kernel<false>;
  auto kkv = bf16 ? attention_train_bwd_kv_kernel<true> : attention_train_bwd_kv_kernel<false>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err == cudaSuccess) err = allow_smem(kkv, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const auto* q = static_cast<const float*>(qkv);
  const auto* da = static_cast<const float*>(dA);
  auto* pd = static_cast<float*>(pd_scratch);
  auto* ds = static_cast<float*>(ds_scratch);
  auto* out = static_cast<float*>(dqkv);
  kq<<<dim3((S + BQT - 1) / BQT, B * H), BTHREADS, smem_q, s>>>(
      q, da, static_cast<const int8_t*>(mask), out, pd, ds, S, H, dh, scale, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((S + BKT - 1) / BKT, B * H), BTHREADS, smem_kv, s>>>(q, da, pd, ds, out, S, H, dh);
  return (int)cudaGetLastError();
}
