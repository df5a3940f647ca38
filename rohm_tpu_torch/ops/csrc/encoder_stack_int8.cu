// encoder_stack_int8: all L int8 encoder layers in one launch.
//
// Replaces rohm_tpu/ops/transformer_layer_int8.py::_mega_kernel_int8, which
// runs the whole stack as one Pallas program with the activations of a
// group of sequences kept in VMEM across the layers. An H100 SM has 227 KB
// of shared memory and one [4608, 512] bf16 activation is 4.7 MB, so here
// "one program" is one persistent cooperative kernel: the grid is as large
// as the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// for 256 threads and the attention item's shared memory: 2 blocks per SM
// at S=144, dh=128), every phase hands out its work items in a grid-stride
// loop, and `grid.sync()` separates the phases. Per layer:
//   [QKV GEMM] [attention] [quant attn] [out GEMM] [LN1 + quant y]
//   [FF1 GEMM + gelu] [quant h1] [FF2 GEMM] [LN2 + quant of the next x]
// (LN and the quantization that follows it share one row pass: 9 syncs per
// layer.) The intermediates live in a workspace the wrapper allocates per
// call (~66 MB at B=32, S=144), which stays largely in the 50 MB L2: the
// H100's counterpart of keeping them on chip. LN2 writes the next layer's
// input into a second buffer (ping-pong), since LN1 of the layer reads the
// layer's input as its residual; the last layer writes `out`.
//
// Every item is a routine of layer_routines.cuh that the per-layer kernels
// (gemm_int8, attention_bf16, quant_rows_int8, residual_layernorm) run too:
// a GEMM tile or a row by one 128-thread half of the block on its own named
// barrier, an attention item by the whole block. So the output is
// bit-identical to L launches of the K3 chain. Activations are written and
// read inside the launch, so they are never read through the read-only
// path (no __restrict__ on them, no __ldg).
//
// Bound: the int8 tensor cores (2 x 4608 x 2.1 M MAC per layer at B=32;
// 78 us for 8 layers at 1979 TOP/s) in principle; this first version runs
// the per-layer kernels' WMMA tiles, whose GEMMs reach ~3.6% of that peak,
// plus ~73 grid-wide barriers per forward. A grid the card cannot hold at
// once is refused by cudaLaunchCooperativeKernel
// (cudaErrorCooperativeLaunchTooLarge), which the wrapper raises.
#include <cooperative_groups.h>

#include "layer_routines.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 2 * rohm::GROUP;  // two 128-thread halves

// The stacked weights, each with a leading [L] dim (the order of
// prepare_layer_int8's tuple).
struct StackWeights {
  const int8_t* wqkv;  // [L, D, 3D]
  const float* sqkv;   // [L, 3D]
  const float* bqkv;   // [L, 3D]
  const int8_t* wo;    // [L, D, D]
  const float* so;
  const float* bo;
  const float* ln1_s;
  const float* ln1_b;
  const int8_t* w1;  // [L, D, F]
  const float* s1;   // [L, F]
  const float* b1;
  const int8_t* w2;  // [L, F, D]
  const float* s2;   // [L, D]
  const float* b2;
  const float* ln2_s;
  const float* ln2_b;
};

struct StackArgs {
  const __nv_bfloat16* x;  // [R, D] input
  __nv_bfloat16* out;      // [R, D] output
  StackWeights w;
  // workspace
  __nv_bfloat16* xbuf;  // [R, D] the other ping-pong buffer
  int8_t* q;            // [R, F] codes of the next GEMM's input
  float* qscale;        // [R]
  __nv_bfloat16* qkv;   // [R, 3D]
  __nv_bfloat16* attn;  // [R, D]
  float* a;             // [R, D] out-proj, then FF2
  float* y;             // [R, D] LN1
  float* h1;            // [R, F]
  unsigned long long* phase_ns;  // null, or 2 + 9L global-timer stamps
  int B, S, D, F, H, L;
  float eps;
};

// With p.phase_ns set, block 0 stamps the global timer at the start and
// after every phase's grid-wide barrier: the stamps bound each phase of
// the whole grid (a last barrier closes the last phase).
__device__ __forceinline__ void stamp(const StackArgs& p, int& k) {
  if (p.phase_ns && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.phase_ns[k] = t;
  }
  ++k;
}

// One GEMM phase: 64 x 64 tiles handed out to the 128-thread halves.
template <int MODE>
__device__ __forceinline__ void gemm_phase(const int8_t* A, const float* rs, const int8_t* W,
                                           const float* cs, const float* bias, void* C, int M, int N,
                                           int K, int g, int ng, int t, int bar, unsigned char* smem) {
  using rohm::gemm_i8::BM;
  using rohm::gemm_i8::BN;
  const int tiles_n = N / BN, tiles = tiles_n * ((M + BM - 1) / BM);
  for (int i = g; i < tiles; i += ng)
    rohm::gemm_int8_tile<MODE>(A, rs, W, cs, bias, C, M, N, K, (i / tiles_n) * BM, (i % tiles_n) * BN, t,
                               bar, smem);
}

// at most 128 registers a thread, so that two blocks fit on an SM
__global__ void __launch_bounds__(THREADS, 2) encoder_stack_int8_kernel(StackArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  const int half = threadIdx.x / rohm::GROUP, t = threadIdx.x % rohm::GROUP, bar = 1 + half;
  const int g = blockIdx.x * 2 + half, ng = gridDim.x * 2;  // this half's index, all halves
  const int R = p.B * p.S, D = p.D, F = p.F, dh = D / p.H;
  const int s_pad = (p.S + 15) / 16 * 16, chunks = s_pad / rohm::attn_bf16::QC;
  const int attn_items = chunks * p.B * p.H;
  unsigned char* gsmem = smem + half * rohm::gemm_i8::SMEM;
  float* scratch = reinterpret_cast<float*>(smem) + half * 32;
  constexpr int T = rohm::GROUP;
  int k = 0;
  stamp(p, k);

  // layer 0's input rows -> int8
  for (int r = g; r < R; r += ng)
    rohm::quant_row(p.x + (size_t)r * D, p.q + (size_t)r * D, p.qscale + r, D, 0.0f, t, T, bar, scratch);
  grid.sync();
  stamp(p, k);

  const __nv_bfloat16* xin = p.x;
  for (int l = 0; l < p.L; ++l) {
    // the last layer writes `out`, the one before it `xbuf`, and so on
    __nv_bfloat16* xout = (p.L - 1 - l) % 2 == 0 ? p.out : p.xbuf;
    const StackWeights& w = p.w;
    const size_t ld3 = (size_t)l * 3 * D, ld1 = (size_t)l * D, ldf = (size_t)l * F;

    gemm_phase<0>(p.q, p.qscale, w.wqkv + ld3 * D, w.sqkv + ld3, w.bqkv + ld3, p.qkv, R, 3 * D, D, g, ng,
                  t, bar, gsmem);
    grid.sync();
    stamp(p, k);

    for (int i = blockIdx.x; i < attn_items; i += gridDim.x) {
      const int bh = i / chunks;
      rohm::attention_bf16_item<false>(p.qkv, p.attn, p.S, p.H, dh, s_pad, bh / p.H, bh % p.H,
                                       (i % chunks) * rohm::attn_bf16::QC, smem);
    }
    grid.sync();
    stamp(p, k);

    for (int r = g; r < R; r += ng)
      rohm::quant_row(p.attn + (size_t)r * D, p.q + (size_t)r * D, p.qscale + r, D, 0.0f, t, T, bar,
                      scratch);
    grid.sync();
    stamp(p, k);

    gemm_phase<1>(p.q, p.qscale, w.wo + ld1 * D, w.so + ld1, w.bo + ld1, p.a, R, D, D, g, ng, t, bar,
                  gsmem);
    grid.sync();
    stamp(p, k);

    for (int r = g; r < R; r += ng) {
      const size_t o = (size_t)r * D;
      rohm::residual_layernorm_row<__nv_bfloat16, false>(xin + o, p.a + o, w.ln1_s + ld1, w.ln1_b + ld1,
                                                         p.y + o, nullptr, D, p.eps, t, T, bar, scratch);
      rohm::quant_row(p.y + o, p.q + o, p.qscale + r, D, 0.0f, t, T, bar, scratch);
    }
    grid.sync();
    stamp(p, k);

    gemm_phase<2>(p.q, p.qscale, w.w1 + ld1 * F, w.s1 + ldf, w.b1 + ldf, p.h1, R, F, D, g, ng, t, bar,
                  gsmem);
    grid.sync();
    stamp(p, k);

    for (int r = g; r < R; r += ng)
      rohm::quant_row(p.h1 + (size_t)r * F, p.q + (size_t)r * F, p.qscale + r, F, 0.0f, t, T, bar,
                      scratch);
    grid.sync();
    stamp(p, k);

    gemm_phase<1>(p.q, p.qscale, w.w2 + ldf * D, w.s2 + ld1, w.b2 + ld1, p.a, R, D, F, g, ng, t, bar,
                  gsmem);
    grid.sync();
    stamp(p, k);

    const bool last = l + 1 == p.L;
    for (int r = g; r < R; r += ng) {
      const size_t o = (size_t)r * D;
      rohm::residual_layernorm_row<float, false>(p.y + o, p.a + o, w.ln2_s + ld1, w.ln2_b + ld1, nullptr,
                                                 xout + o, D, p.eps, t, T, bar, scratch);
      if (!last) rohm::quant_row(xout + o, p.q + o, p.qscale + r, D, 0.0f, t, T, bar, scratch);
    }
    if (!last || p.phase_ns) {
      grid.sync();
      stamp(p, k);
    }
    xin = xout;
  }
}

size_t smem_bytes(int S, int dh) {
  const size_t attn = rohm::attn_bf16::smem_bytes((S + 15) / 16 * 16, dh);
  const size_t gemm = 2 * (size_t)rohm::gemm_i8::SMEM;
  return attn > gemm ? attn : gemm;
}

// Blocks per SM the card holds at once for this S and dh, and the SM count.
cudaError_t grid_size(int S, int dh, int* per_sm, int* sms) {
  const size_t smem = smem_bytes(S, dh);
  cudaError_t err = cudaFuncSetAttribute(encoder_stack_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, encoder_stack_int8_kernel, THREADS, smem);
  return err;
}

}  // namespace

// blocks_sms: two host ints, set to the blocks per SM of the launch and the SM count.
extern "C" int rt_encoder_stack_int8_grid(int S, int dh, void* blocks_sms) {
  int* out = static_cast<int*>(blocks_sms);
  return (int)grid_size(S, dh, &out[0], &out[1]);
}

// weights: 16 device pointers (host array) in prepare_layer_int8's order,
// each tensor with a leading [L] dim; work: 8 device pointers (host array)
// xbuf [R, D] bf16, q [R, F] i8, qscale [R] f32, qkv [R, 3D] bf16,
// attn [R, D] bf16, a [R, D] f32, y [R, D] f32, h1 [R, F] f32 (R = B*S).
// phase_ns: null, or 2 + 9L u64 (see `stamp`).
// D and F multiples of 64, D/H a multiple of 16; pointers 16-byte aligned.
extern "C" int rt_encoder_stack_int8(const void* x, void* out, const void* const* weights,
                                     void* const* work, void* phase_ns, int B, int S, int D, int F,
                                     int H, int L, float eps, void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || H <= 0 || D % 64 != 0 || F % 64 != 0 || D % H != 0 ||
      (D / H) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = grid_size(S, D / H, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;

  StackArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.w = StackWeights{
      static_cast<const int8_t*>(weights[0]), static_cast<const float*>(weights[1]),
      static_cast<const float*>(weights[2]),  static_cast<const int8_t*>(weights[3]),
      static_cast<const float*>(weights[4]),  static_cast<const float*>(weights[5]),
      static_cast<const float*>(weights[6]),  static_cast<const float*>(weights[7]),
      static_cast<const int8_t*>(weights[8]), static_cast<const float*>(weights[9]),
      static_cast<const float*>(weights[10]), static_cast<const int8_t*>(weights[11]),
      static_cast<const float*>(weights[12]), static_cast<const float*>(weights[13]),
      static_cast<const float*>(weights[14]), static_cast<const float*>(weights[15]),
  };
  p.xbuf = static_cast<__nv_bfloat16*>(work[0]);
  p.q = static_cast<int8_t*>(work[1]);
  p.qscale = static_cast<float*>(work[2]);
  p.qkv = static_cast<__nv_bfloat16*>(work[3]);
  p.attn = static_cast<__nv_bfloat16*>(work[4]);
  p.a = static_cast<float*>(work[5]);
  p.y = static_cast<float*>(work[6]);
  p.h1 = static_cast<float*>(work[7]);
  p.phase_ns = static_cast<unsigned long long*>(phase_ns);
  p.B = B, p.S = S, p.D = D, p.F = F, p.H = H, p.L = L, p.eps = eps;

  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)encoder_stack_int8_kernel, dim3(per_sm * sms),
                                    dim3(THREADS), args, smem_bytes(S, D / H),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
