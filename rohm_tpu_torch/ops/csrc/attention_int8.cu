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
// at S=144. The block stages its Q rows as bf16 in shared memory with
// 16-byte loads and quantizes them there; K and V come in tiles of up to
// 176 keys, staged and quantized the same way. Both products run on the
// int8 tensor cores (WMMA 16x16x16 s8, exact int32 sums) over 8 warps, and
// the int32 P.V sums stay in shared memory across the key tiles (exact in
// any order). Up to S = 176 one tile holds every key (the shipped 144
// included: ~187 KB of shared memory, one block per SM): V's per-column
// vmax is then an in-block reduction of the staged V, and the scores are
// computed once. A longer sequence first reads V's columns in place for
// their vmax, then sweeps the key tiles for the rows' max, again for their
// sum (never rescaled: each prob code comes from the row's final max and
// sum, as in the JAX package), and a last time for the prob codes and
// P.V; a tile's int32 scores are the same in every sweep. Keys pad to a
// multiple of 16 with zero codes. Fragments sit in shared memory as
// 16-byte-wide panels, the layout of gemm_int8.cu, because WMMA wants
// 256-bit aligned fragment pointers: K and Q as [dh/16][rows][16] (K read
// as K^T, column-major), V as [dh/16][keys][16], the probs as
// [keys/16][48][16]. Bound: latency of the quantize passes and the
// tensor-core products at S=144 (~1.8 MOP of int8 products per block).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 48;        // query rows per block (a multiple of 16)
constexpr int THREADS = 256;  // 8 warps
constexpr int KT = 176;       // keys per tile (a multiple of 16)
constexpr size_t SMEM_MAX = 232448;

struct Layout {
  size_t kb, vb, qb, kp, vp, qp, pp, rk, rq, vs, vi, st, sc, oc, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// kt: keys per tile (padded to 16)
__host__ __device__ inline Layout layout(int kt, int dh) {
  Layout l;
  size_t o = 0;
  l.kb = o; o = align128(o + sizeof(__nv_bfloat16) * kt * dh);
  l.vb = o; o = align128(o + sizeof(__nv_bfloat16) * kt * dh);
  l.qb = o; o = align128(o + sizeof(__nv_bfloat16) * QT * dh);
  l.kp = o; o = align128(o + (size_t)kt * dh);
  l.vp = o; o = align128(o + (size_t)kt * dh);
  l.qp = o; o = align128(o + (size_t)QT * dh);
  l.pp = o; o = align128(o + (size_t)QT * kt);
  l.rk = o; o = align128(o + sizeof(float) * kt);
  l.rq = o; o = align128(o + sizeof(float) * QT);
  l.vs = o; o = align128(o + sizeof(float) * dh);
  l.vi = o; o = align128(o + sizeof(float) * dh);
  l.st = o; o = align128(o + sizeof(float) * 2 * QT);
  l.sc = o; o = align128(o + sizeof(int) * QT * (kt + 4));
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
    int dh, int kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(kt, dh);
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem + L.kb);  // [kt][dh] staged
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(smem + L.vb);  // [kt][dh] staged
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem + L.qb);  // [QT][dh] staged
  int8_t* Kp = reinterpret_cast<int8_t*>(smem + L.kp);  // [dh/16][kt][16]
  int8_t* Vp = reinterpret_cast<int8_t*>(smem + L.vp);  // [dh/16][kt][16]
  int8_t* Qp = reinterpret_cast<int8_t*>(smem + L.qp);  // [dh/16][QT][16]
  int8_t* Pp = reinterpret_cast<int8_t*>(smem + L.pp);  // [kt/16][QT][16]
  float* rk = reinterpret_cast<float*>(smem + L.rk);
  float* rq = reinterpret_cast<float*>(smem + L.rq);
  float* vscale = reinterpret_cast<float*>(smem + L.vs);  // vmax / 16129 per column
  float* vinv = reinterpret_cast<float*>(smem + L.vi);    // 127 / vmax per column
  float* rmax = reinterpret_cast<float*>(smem + L.st);    // per query row: max, sum
  float* rsum = rmax + QT;
  int* Sc = reinterpret_cast<int*>(smem + L.sc);  // [QT][kt + 4]
  int* Oc = reinterpret_cast<int*>(smem + L.oc);  // [QT][dh + 4]
  const int lds = kt + 4, ldo = dh + 4;

  const int D = H * dh, row_stride = 3 * D, d8 = dh / 8;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * QT;
  const int nq = min(QT, S - q0), nt = (S + kt - 1) / kt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = THREADS / 32;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * dh;

  // this block's Q rows: staged as bf16 (16-byte loads), one warp per row
  for (int e = tid; e < nq * d8; e += THREADS) {
    const int r = e / d8, c = (e % d8) * 8;
    *reinterpret_cast<uint4*>(Qb + r * dh + c) =
        *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + c);
  }
  __syncthreads();
  for (int r = warp; r < QT; r += nwarps) {
    if (r < nq) {
      const float s = quant_row(Qb + r * dh, Qp, QT, r, dh, lane);
      if (lane == 0) rq[r] = s;
    } else {
      for (int c = lane; c < dh; c += 32) Qp[((c / 16) * QT + r) * 16 + c % 16] = 0;
      if (lane == 0) rq[r] = 0.0f;
    }
  }

  // keys [k0, k0 + nk) staged (V too with `with_v`) and quantized per row;
  // rows up to nk16 get zero codes
  auto stage = [&](int k0, int nk, int nk16, bool with_v) {
    __syncthreads();
    for (int e = tid; e < nk * d8; e += THREADS) {
      const int r = e / d8, c = (e % d8) * 8;
      const __nv_bfloat16* row = base + (size_t)(k0 + r) * row_stride + c;
      *reinterpret_cast<uint4*>(Kb + r * dh + c) = *reinterpret_cast<const uint4*>(row + D);
      if (with_v) *reinterpret_cast<uint4*>(Vb + r * dh + c) = *reinterpret_cast<const uint4*>(row + 2 * D);
    }
    __syncthreads();
    for (int r = warp; r < nk16; r += nwarps) {
      if (r < nk) {
        const float s = quant_row(Kb + r * dh, Kp, kt, r, dh, lane);
        if (lane == 0) rk[r] = s;
      } else {
        for (int c = lane; c < dh; c += 32) Kp[((size_t)(c / 16) * kt + r) * 16 + c % 16] = 0;
        if (lane == 0) rk[r] = 0.0f;
      }
    }
  };
  // V's per-column scale over all S rows: from the staged tile when it holds
  // every key, else read in place (one thread per column)
  auto v_scales = [&](bool staged) {
    for (int c = tid; c < dh; c += THREADS) {
      float vmax = 0.0f;
      for (int r = 0; r < S; ++r)
        vmax = fmaxf(vmax, fabsf(__bfloat162float(staged ? Vb[r * dh + c] : base[(size_t)r * row_stride + 2 * D + c])));
      vmax = fmaxf(vmax, 1e-12f);
      vinv[c] = __fdiv_rn(127.0f, vmax);
      vscale[c] = __fdiv_rn(vmax, 16129.0f);
    }
  };
  // V codes of the staged tile (one thread per column)
  auto v_codes = [&](int nk, int nk16) {
    for (int c = tid; c < dh; c += THREADS) {
      int8_t* col = Vp + (size_t)(c / 16) * kt * 16 + c % 16;
      for (int r = 0; r < nk16; ++r) col[r * 16] = r < nk ? code(__bfloat162float(Vb[r * dh + c]), vinv[c]) : 0;
    }
  };
  // int32 scores [QT, nk16] = Q K^T, one 16x16 tile per warp at a time
  auto scores = [&](int nk16) {
    __syncthreads();
    for (int t = warp; t < (QT / 16) * (nk16 / 16); t += nwarps) {
      const int i = t / (nk16 / 16), j = t % (nk16 / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
      for (int kh = 0; kh < dh / 16; ++kh) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bk;
        wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(Qp + (kh * QT + i * 16) * 16), 16);
        wmma::load_matrix_sync(
            bk, reinterpret_cast<const signed char*>(Kp + ((size_t)kh * kt + j * 16) * 16), 16);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Sc + i * 16 * lds + j * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();
  };
  auto score = [&](int r, int c) { return __fmul_rn(__fmul_rn((float)Sc[r * lds + c], rq[r]), rk[c]); };

  if (nt == 1) {
    stage(0, S, kt, true);
    v_scales(true);
    __syncthreads();
    v_codes(S, kt);
    scores(kt);
    for (int r = warp; r < QT; r += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < S; c += 32) mx = fmaxf(mx, score(r, c));
      mx = rohm::warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < S; c += 32) sum += expf(score(r, c) - mx);
      sum = rohm::warp_sum(sum);
      if (lane == 0) rmax[r] = mx, rsum[r] = sum;
    }
  } else {
    v_scales(false);
    if (tid < QT) rmax[tid] = -INFINITY, rsum[tid] = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < S; k0 += kt) {
        const int nk = min(kt, S - k0), nk16 = (nk + 15) / 16 * 16;
        stage(k0, nk, nk16, false);
        scores(nk16);
        for (int r = warp; r < QT; r += nwarps) {
          if (pass == 0) {
            float mx = -INFINITY;
            for (int c = lane; c < nk; c += 32) mx = fmaxf(mx, score(r, c));
            mx = rohm::warp_max(mx);
            if (lane == 0) rmax[r] = fmaxf(rmax[r], mx);
          } else {
            const float mx = rmax[r];
            float sum = 0.0f;
            for (int c = lane; c < nk; c += 32) sum += expf(score(r, c) - mx);
            sum = rohm::warp_sum(sum);
            if (lane == 0) rsum[r] += sum;
          }
        }
      }
    }
  }

  for (int k0 = 0; k0 < S; k0 += kt) {
    const int nk = min(kt, S - k0), nk16 = (nk + 15) / 16 * 16;
    if (nt > 1) {
      stage(k0, nk, nk16, true);
      __syncthreads();
      v_codes(nk, nk16);
      scores(nk16);
    } else {
      __syncthreads();
    }
    // f32 softmax over the S real keys, probs -> int8 codes (padded keys 0)
    for (int r = warp; r < QT; r += nwarps) {
      const float mx = rmax[r], sum = rsum[r];
      for (int c = lane; c < nk16; c += 32) {
        int8_t p = 0;
        if (c < nk && r < nq) {
          const float e = expf(score(r, c) - mx);
          p = static_cast<int8_t>(rintf(__fmul_rn(__fdiv_rn(e, sum), 127.0f)));
        }
        Pp[((c / 16) * QT + r) * 16 + c % 16] = p;
      }
    }
    __syncthreads();

    // int32 out [QT, dh] += P V over this tile's keys
    for (int t = warp; t < (QT / 16) * (dh / 16); t += nwarps) {
      const int i = t / (dh / 16), n = t % (dh / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      if (k0 == 0) wmma::fill_fragment(acc, 0);
      else wmma::load_matrix_sync(acc, Oc + i * 16 * ldo + n * 16, ldo, wmma::mem_row_major);
      for (int kh = 0; kh < nk16 / 16; ++kh) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bv;
        wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(Pp + (kh * QT + i * 16) * 16), 16);
        wmma::load_matrix_sync(
            bv, reinterpret_cast<const signed char*>(Vp + ((size_t)n * kt + kh * 16) * 16), 16);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Oc + i * 16 * ldo + n * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int e = tid; e < nq * dh; e += THREADS) {
    const int r = e / dh, c = e % dh;
    out[((size_t)b * S + q0 + r) * D + h * dh + c] =
        __float2bfloat16_rn(__fmul_rn((float)Oc[r * ldo + c], vscale[c]));
  }
}

}  // namespace

// Any S; dh a multiple of 16 whose tile of 16 keys or more fits in shared
// memory (dh <= 256 keeps at least 64 keys a tile).
extern "C" int rt_attention_int8(const void* qkv, void* out, int B, int S, int H, int dh,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  // the tile: every key (S padded to 16) up to KT, fewer where dh leaves less room
  int kt = (S + 15) / 16 * 16;
  if (kt > KT) kt = KT;
  while (kt > 16 && layout(kt, dh).total > SMEM_MAX) kt -= 16;
  const size_t smem = layout(kt, dh).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + QT - 1) / QT, B * H);
  attention_int8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), S, H, dh, kt);
  return (int)cudaGetLastError();
}
