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
// Design, up to S = HEAD_KEYS (192; the shipped 144 included): one block
// of 9 warps per (sequence, head), 128 blocks at B = 32, H = 4, one wave on
// 132 SMs. The block quantizes K and V once: K's rows by warps (a warp a
// row: amax, __fdiv_rn(127, amax), rintf, clip) into shared memory, V's
// per-column max as a parallel reduction (warps over slices of the rows,
// then across the warps), then V's codes, transposed. Each warp then owns
// 16 query rows at a time (9 tiles at S = 144): it quantizes them, forms
// the int32 scores with mma.sync m16n8k32 s8 in registers (16 x S rounded
// up to 32, exact), takes each row's max and sum with quad shuffles (f32,
// expf), makes the prob codes rint(e / sum * 127) and runs P.V with the
// same mma. The s8 accumulator layout is not the s8 A fragment's, but the
// int32 P.V sums are exact in any order of the keys: V's codes sit in
// shared memory with the keys of each block of 32 permuted so that each
// thread's own prob codes are its A fragment (A slot 4 t + i, i < 4, holds
// key 8 (i / 2) + 2 t + i % 2, slot 16 + 4 t + i key 16 + 8 (i / 2) + 2 t
// + i % 2, t = lane % 4), keys padded to a multiple of 32 with zero codes.
// The limit is the registers, not shared memory: 9 warps on an SM hold at
// most 168 registers a thread (3 warps on each quarter of the SM's 64 K),
// and a warp's 16 x S int32 scores take S / 2 of them; past 192 keys the
// kernel spills (on an H100: 68 bytes at 224 keys, 556 at 256). The codes
// of all of K and V at S = 192 and dh = 128 take 53 KB of shared memory.
//
// Past HEAD_KEYS (or a head width that is not a multiple of 32 up to 128):
// one block per (48 query rows, sequence, head). The block stages its Q
// rows as bf16 in shared memory with 16-byte loads and quantizes them
// there; K and V come in tiles of up to 176 keys, staged and quantized the
// same way. Both products run on the int8 tensor cores (WMMA 16x16x16 s8,
// exact int32 sums) over 8 warps, and the int32 P.V sums stay in shared
// memory across the key tiles (exact in any order). Up to S = 176 one tile
// holds every key: V's per-column vmax is then an in-block reduction of
// the staged V, and the scores are computed once. A longer sequence first
// reads V's columns in place for their vmax, then sweeps the key tiles for
// the rows' max, again for their sum (never rescaled: each prob code comes
// from the row's final max and sum, as in the JAX package), and a last
// time for the prob codes and P.V; a tile's int32 scores are the same in
// every sweep. Keys pad to a multiple of 16 with zero codes. Fragments sit
// in shared memory as 16-byte-wide panels, the layout of gemm_int8.cu,
// because WMMA wants 256-bit aligned fragment pointers: K and Q as
// [dh/16][rows][16] (K read as K^T, column-major), V as [dh/16][keys][16],
// the probs as [keys/16][48][16].
// Bound: latency of the quantize passes and the tensor-core products
// (10.6 MOP of int8 products per head at S = 144).
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


// ---------------------------------------------------------------------------
// one block per (sequence, head), S <= HEAD_KEYS
// ---------------------------------------------------------------------------
constexpr int HEAD_WARPS = 9, HEAD_THREADS = 32 * HEAD_WARPS;
constexpr int HEAD_KEYS = 192;  // 6 blocks of 32 keys

// Shared memory at s32 keys (S rounded up to 32), in bytes: K's codes
// [s32][dh + 16], V's codes transposed [dh][s32 + 16] (16 bytes of skew
// each: the fragments' 32-bit loads without bank conflicts), K's row
// scales [s32], the warps' partial column max [HEAD_WARPS][dh], V's
// column scales and inverses [dh] each, and each warp's rows [16][2 dh +
// 16]: its Q codes, then its bf16 output.
struct HeadLayout {
  int ldk, ldv, ldw;
  size_t k, vt, rk, vpart, vs, vi, w, total;
};

__host__ __device__ inline HeadLayout head_layout(int s32, int dh) {
  HeadLayout l;
  l.ldk = dh + 16, l.ldv = s32 + 16, l.ldw = 2 * dh + 16;
  size_t o = 0;
  l.k = o; o = align128(o + (size_t)s32 * l.ldk);
  l.vt = o; o = align128(o + (size_t)dh * l.ldv);
  l.rk = o; o = align128(o + sizeof(float) * s32);
  l.vpart = o; o = align128(o + sizeof(float) * HEAD_WARPS * dh);
  l.vs = o; o = align128(o + sizeof(float) * dh);
  l.vi = o; o = align128(o + sizeof(float) * dh);
  l.w = o; o = align128(o + (size_t)HEAD_WARPS * 16 * l.ldw);
  l.total = o;
  return l;
}

// d[16x8] += a[16x32] . b[32x8], s8 in, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_s8(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xff) | ((uint32_t)(b1 & 0xff) << 8) | ((uint32_t)(b2 & 0xff) << 16) |
         ((uint32_t)(b3 & 0xff) << 24);
}

// four bf16 values (one 8-byte load) as f32, or zeros where !valid
__device__ __forceinline__ void load4(const __nv_bfloat16* src, bool valid, float (&v)[4]) {
  uint2 u = make_uint2(0, 0);
  if (valid) u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi), v[3] = __high2float(hi);
}

// one row of dh values (4 a lane, zeros on the lanes past dh, dh <= 128)
// -> codes (4 a lane, packed) and its scale, by one warp; a row past S
// (`valid` false, its values zeros) gives zero codes and scale 0
__device__ __forceinline__ uint32_t quant4(const float (&v)[4], bool valid, float& scale) {
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
  amax = fmaxf(rohm::warp_max(amax), 1e-12f);
  const float inv = __fdiv_rn(127.0f, amax);
  scale = valid ? __fmul_rn(amax, (float)(1.0 / 127.0)) : 0.0f;
  return pack_s8(code(v[0], inv), code(v[1], inv), code(v[2], inv), code(v[3], inv));
}

// NKB: blocks of 32 keys, S <= 32 NKB (the scores' registers)
template <int NKB>
__global__ void __launch_bounds__(HEAD_THREADS, 1) attention_int8_head_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int S, int H, int dh) {
  constexpr int S32 = 32 * NKB, NT = 4 * NKB;  // keys, 8-key score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadLayout L = head_layout(S32, dh);
  int8_t* Ks = reinterpret_cast<int8_t*>(smem + L.k);   // [S32][ldk] K codes, rows past S zero
  int8_t* Vt = reinterpret_cast<int8_t*>(smem + L.vt);  // [dh][ldv] V codes, keys permuted per 32
  float* rk = reinterpret_cast<float*>(smem + L.rk);
  float* vpart = reinterpret_cast<float*>(smem + L.vpart);
  float* vscale = reinterpret_cast<float*>(smem + L.vs);  // vmax / 16129 per column
  float* vinv = reinterpret_cast<float*>(smem + L.vi);    // 127 / vmax per column
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  unsigned char* W = smem + L.w + (size_t)warp * 16 * L.ldw;  // this warp's rows
  const int D = H * dh, stride = 3 * D, b = blockIdx.x / H, h = blockIdx.x % H;
  const bool mine = 4 * lane < dh;  // this lane's four columns 4 lane .. 4 lane + 3
  const __nv_bfloat16* base = qkv + (size_t)b * S * stride + h * dh + 4 * lane;

  // K's rows -> codes (a warp a row, four of its rows loaded at once);
  // V's column max over this warp's rows
  float vmax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = warp; r0 < S32; r0 += 4 * HEAD_WARPS) {
    float kv[4][4], vv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * HEAD_WARPS;
      load4(base + (size_t)r * stride + D, r < S && mine, kv[i]);
      load4(base + (size_t)r * stride + 2 * D, r < S && mine, vv[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * HEAD_WARPS;
      if (r >= S32) break;
      float sc;
      const uint32_t kc = quant4(kv[i], r < S, sc);
      if (mine) *reinterpret_cast<uint32_t*>(Ks + r * L.ldk + 4 * lane) = kc;
      if (lane == 0) rk[r] = sc;
#pragma unroll
      for (int j = 0; j < 4; ++j) vmax[j] = fmaxf(vmax[j], fabsf(vv[i][j]));
    }
  }
  if (mine)
#pragma unroll
    for (int i = 0; i < 4; ++i) vpart[warp * dh + 4 * lane + i] = vmax[i];
  __syncthreads();
  for (int c = tid; c < dh; c += HEAD_THREADS) {
    float m = 0.0f;
    for (int w = 0; w < HEAD_WARPS; ++w) m = fmaxf(m, vpart[w * dh + c]);
    m = fmaxf(m, 1e-12f);
    vinv[c] = __fdiv_rn(127.0f, m);
    vscale[c] = __fdiv_rn(m, 16129.0f);
  }
  __syncthreads();

  // V's codes, column-major: group (kb, u, tp) is keys 32 kb + 16 u +
  // {2 tp, 2 tp + 1, 8 + 2 tp, 9 + 2 tp}, which land in slots
  // 32 kb + 16 u + 4 tp .. + 3 of every column (one 32-bit store)
  for (int grp = warp; grp < S32 / 4; grp += HEAD_WARPS) {
    const int k0 = 32 * (grp / 8) + 16 * ((grp / 4) % 2), tp = grp % 4;
    const int keys[4] = {k0 + 2 * tp, k0 + 2 * tp + 1, k0 + 8 + 2 * tp, k0 + 9 + 2 * tp};
    if (!mine) continue;
    int cv[4][4];  // [key][column]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
      load4(base + (size_t)keys[i] * stride + 2 * D, keys[i] < S, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[i][j] = code(v[j], vinv[4 * lane + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Vt + (4 * lane + j) * L.ldv + k0 + 4 * tp) =
          pack_s8(cv[0][j], cv[1][j], cv[2][j], cv[3][j]);
  }
  __syncthreads();

  for (int q0 = 16 * warp; q0 < S; q0 += 16 * HEAD_WARPS) {
    // this tile's Q rows (all 16 loaded at once) -> codes in W; rq[e] the
    // scale of row g + 8 e
    float qv[16][4], rq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 16; ++r) load4(base + (size_t)(q0 + r) * stride, q0 + r < S && mine, qv[r]);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float sc;
      const uint32_t qc = quant4(qv[r], q0 + r < S, sc);
      if (mine) *reinterpret_cast<uint32_t*>(W + r * L.ldw + 4 * lane) = qc;
      if (r == g) rq[0] = sc;
      if (r == g + 8) rq[1] = sc;
    }
    __syncwarp();
    uint32_t qa[4][4];  // A fragments of Q, 32 columns each (dh <= 128)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (32 * kk >= dh) break;
      const unsigned char* row = W + g * L.ldw + 32 * kk + 4 * t;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(row);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(row + 8 * L.ldw);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(row + 16);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(row + 8 * L.ldw + 16);
    }
    // int32 scores [16 x S32]: acc[j][e] is row g + 8 (e / 2), key 8 j + 2 t + e % 2
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (32 * kk >= dh) break;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* kr = Ks + (8 * j + g) * L.ldk + 32 * kk + 4 * t;
        mma_s8(acc[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 16));
      }
    }
    // f32 softmax over the S real keys: (acc * rq) * rk, the rows' max and
    // sum over the quad, the prob codes
    float s[NT][4], mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 kscale = *reinterpret_cast<const float2*>(rk + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fmul_rn(__fmul_rn((float)acc[j][e], rq[e / 2]), e % 2 ? kscale.y : kscale.x);
        if (8 * j + 2 * t + e % 2 < S) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    mx[0] = rohm::quad_max(mx[0]);
    mx[1] = rohm::quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 8 * j + 2 * t + e % 2 < S ? expf(s[j][e] - mx[e / 2]) : 0.0f;
        sum[e / 2] += s[j][e];
      }
    sum[0] = rohm::quad_sum(sum[0]);
    sum[1] = rohm::quad_sum(sum[1]);
    // the prob codes as the A fragments of P.V (keys of block kb in the
    // permuted order of Vt): tiles 4 kb .. 4 kb + 3
    uint32_t pa[NKB][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int pc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[e] = (int)rintf(__fmul_rn(__fdiv_rn(s[j][e], sum[e / 2]), 127.0f));
      const int kb = j / 4, hi = (j % 4) / 2;  // registers 0, 1 (keys < 16) or 2, 3
      if (j % 2 == 0) {
        pa[kb][2 * hi] = pack_s8(pc[0], pc[1], 0, 0);
        pa[kb][2 * hi + 1] = pack_s8(pc[2], pc[3], 0, 0);
      } else {
        pa[kb][2 * hi] |= pack_s8(0, 0, pc[0], pc[1]);
        pa[kb][2 * hi + 1] |= pack_s8(0, 0, pc[2], pc[3]);
      }
    }

    // out [16 x dh] = P.V, 64 columns at a time, into W as bf16 (Q's codes
    // are in registers by now)
    __syncwarp();
    for (int n0 = 0; n0 < dh; n0 += 64) {
      int o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n0 + 8 * n >= dh) break;
          const int8_t* vr = Vt + (n0 + 8 * n + g) * L.ldv + 32 * kb + 4 * t;
          mma_s8(o[n], pa[kb], *reinterpret_cast<const uint32_t*>(vr), *reinterpret_cast<const uint32_t*>(vr + 16));
        }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n0 + 8 * n >= dh) break;
        const int col = n0 + 8 * n + 2 * t;
        const float2 vs = *reinterpret_cast<const float2*>(vscale + col);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint32_t*>(W + (g + 8 * e) * L.ldw + 2 * col) =
              rohm::pack_bf16(__fmul_rn((float)o[n][2 * e], vs.x), __fmul_rn((float)o[n][2 * e + 1], vs.y));
      }
    }
    __syncwarp();
    for (int e = lane; e < 16 * (dh / 8); e += 32) {
      const int r = e / (dh / 8), c = (e % (dh / 8)) * 8;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(out + ((size_t)b * S + q0 + r) * D + h * dh + c) =
            *reinterpret_cast<const uint4*>(W + r * L.ldw + 2 * c);
    }
    __syncwarp();
  }
}

// the one-block kernel for S up to 32 (i + 1)
const void* const HEAD_KERNELS[HEAD_KEYS / 32] = {
    (const void*)attention_int8_head_kernel<1>, (const void*)attention_int8_head_kernel<2>,
    (const void*)attention_int8_head_kernel<3>, (const void*)attention_int8_head_kernel<4>,
    (const void*)attention_int8_head_kernel<5>, (const void*)attention_int8_head_kernel<6>};

}  // namespace

// Any S; dh a multiple of 16 whose tile of 16 keys or more fits in shared
// memory (dh <= 256 keeps at least 64 keys a tile). One block per
// (sequence, head) for S <= HEAD_KEYS and dh a multiple of 32 up to 128.
extern "C" int rt_attention_int8(const void* qkv, void* out, int B, int S, int H, int dh,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh % 16 != 0) return (int)cudaErrorInvalidValue;
  if (S <= HEAD_KEYS && dh % 32 == 0 && dh <= 128) {
    const int nkb = (S + 31) / 32;
    const void* kernel = HEAD_KERNELS[nkb - 1];
    const size_t smem = head_layout(32 * nkb, dh).total;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&qkv, (void*)&out, &S, &H, &dh};
    err = cudaLaunchKernel(kernel, dim3(B * H), dim3(HEAD_THREADS), args, smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
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
