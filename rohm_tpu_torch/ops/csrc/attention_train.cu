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
// f32 FMA sums here compute what a bf16 MMA with f32 accumulation computes,
// up to the order of the sum. The mask is int8 [B, H, S, S] (1 = keep).
//
// Replaces the attention of rohm_tpu/ops/transformer_layer_train.py::
// _forward_body (K6 and K7's recompute) and the attention backward of
// _bwd_kernel (:259-301). The TPU kernel keeps every (sequence, head) of its
// group in VMEM; an SM has 227 KB, and in f32 the K and V of one (sequence,
// head) alone take 2 x 145 x 128 x 4 = 148 KB at S = 145, so:
//   forward: one block per (48 query rows, sequence, head) with K and V in
//            shared memory (205 KB at S = 145, dh = 128);
//   backward pass 1: one block per (32 query rows, sequence, head): K, V,
//            the tile's Q then dA, its p and dp/ds rows (211 KB): writes dq
//            and, to a scratch of [B, H, S, S] f32 each, pd and ds;
//   backward pass 2: one block per (32 keys, sequence, head): all of the
//            sequence's Q and dA (148 KB) and the key tile's columns of pd
//            and ds: writes dk and dv.
// P is recomputed from Q and K (nothing of [B, H, S, S] is kept from the
// forward); the two-pass split keeps every sum in one block, so dq, dk and
// dv need no atomics. Bound: f32 FMA issue and shared-memory bandwidth
// (2.8 GFLOP forward, 5.5 backward per layer at B = 64, S = 145); no
// tensor cores in this first version.
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
// forward
// ---------------------------------------------------------------------------

constexpr int FQT = 48, FTHREADS = 384;

template <bool BF16>
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

  load_rows<BF16>(Ks, ldk, base + D, row_stride, S, S, dh, tid, FTHREADS);
  load_rows<BF16>(Vs, dh, base + 2 * D, row_stride, S, S, dh, tid, FTHREADS);
  load_rows<BF16>(Qs, dh, base + (size_t)q0 * row_stride, row_stride, nq, FQT, dh, tid, FTHREADS);
  __syncthreads();
  products_xy(Pt, ldp, Qs, dh, Ks, ldk, S, FQT, dh, scale, true, tid, FTHREADS);
  __syncthreads();
  for (int r = warp; r < nq; r += FTHREADS / 32) {
    softmax_row(Pt, ldp, r, S, lane);
    __syncwarp();
    for (int c = lane; c < S; c += 32) {
      const float keep = mrow[(size_t)r * S + c] ? inv_keep : 0.0f;
      Pt[c * ldp + r] = rnd<BF16>(__fmul_rn(Pt[c * ldp + r], keep));
    }
  }
  __syncthreads();

  // out = c(pd) . c(v): thread task = (4 query rows, 4 output columns)
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

// Any S whose tiles fit in 227 KB of shared memory (S <= 150 at dh = 128).
extern "C" int rt_attention_train_fwd(const void* qkv, const void* mask, void* out, int B, int S,
                                      int H, int dh, float scale, float inv_keep, int bf16,
                                      void* stream) {
  if (bad_shape(B, S, H, dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(S, dh);
  auto kernel = bf16 ? attention_train_fwd_kernel<true> : attention_train_fwd_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + FQT - 1) / FQT, B * H);
  kernel<<<grid, FTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const int8_t*>(mask), static_cast<float*>(out), S,
      H, dh, scale, inv_keep);
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
