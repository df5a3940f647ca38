// encoder_stack_int8: all L int8 encoder layers in one launch.
//
// Replaces rohm_tpu/ops/transformer_layer_int8.py::_mega_kernel_int8, which
// runs the whole stack as one Pallas program with the activations of a
// group of sequences kept in VMEM across the layers. An H100 SM has 227 KB
// of shared memory and one [4608, 512] bf16 activation is 4.7 MB, so here
// "one program" is one persistent cooperative kernel: the grid is as large
// as the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// for 288 threads: one block per SM, 168 registers a thread), every phase
// hands out its work items in a grid-stride loop, and `grid.sync()`
// separates the phases. Per layer:
//   [QKV GEMM] [attention] [quant attn] [out GEMM] [LN1 + quant y]
//   [FF1 GEMM + gelu] [quant h1] [FF2 GEMM] [LN2 + quant of the next x]
// (LN and the quantization that follows it share one row pass: 9 syncs per
// layer.) The intermediates live in a workspace the wrapper allocates per
// call (~66 MB at B=32, S=144), which stays largely in the 50 MB L2: the
// H100's counterpart of keeping them on chip. LN2 writes the next layer's
// input into a second buffer (ping-pong), since LN1 of the layer reads the
// layer's input as its residual; the last layer writes `out`.
//
// Every item is a routine that the per-layer kernels run too, so the
// output is bit-identical to L launches of the K3 chain:
//  - a GEMM tile is wgmma_gemm.cuh's gemm_tile, gemm_int8.cu's main loop
//    (TMA ring of 3 stages, the producer warp, two consumer warpgroups,
//    wgmma s8 into exact int32 sums), ended by rohm::Int8Epilogue. Its
//    operands come through tensor maps: the workspace's codes q as [R, D]
//    or [R, F], and each stacked weight stored K-major as [L, N, K] (3-D,
//    the layer a coordinate). The ring and its stage index and mbarrier
//    parities carry over from tile to tile and phase to phase; the
//    mbarriers sit in the first bytes of shared memory, which no other
//    phase touches;
//  - a row (quant_row, residual_layernorm_row) is one 128-thread half of
//    warps 0-7 on its own named barrier; the producer warp sits it out;
//  - an attention item is the whole 288-thread block (any warp count
//    gives the same bits).
// A GEMM tile's epilogue stages its sums apart from the ring (112 KB of
// shared memory in all), so the producer loads the next tile's k-steps
// while the consumers finish the last one. Every GEMM phase runs 128 x 64
// tiles: 128-wide ones need 169 KB, which leaves the row phases less L1
// for their rows' second and third reads (on an H100 the LayerNorm phases
// then took 10% longer). One block per SM: two blocks of 288 threads cap
// a thread at 96 registers (5 of their 18 warps on a quarter of the SM),
// where the attention item and the GEMM tile spill. The A/B of
// rohm_tpu_torch/scripts/ab_train_kernels.py times those choices.
// The phases hand shared memory and q between the generic proxy (plain
// stores) and the async proxy (TMA): every thread fences
// (fence.proxy.async) before each grid-wide barrier that opens a GEMM
// phase. Activations are written and read inside the launch, so they are
// never read through the read-only path (no __restrict__, no __ldg).
//
// Bound: the int8 tensor cores (2 x 4608 x 2.1 M MAC per layer at B=32;
// 78 us for 8 layers at 1979 TOP/s); besides its GEMM tiles the launch
// runs ~73 grid-wide barriers and the row and attention phases. A grid the
// card cannot hold at once is refused by cudaLaunchCooperativeKernel
// (cudaErrorCooperativeLaunchTooLarge), which the wrapper raises.
#include <cooperative_groups.h>

#include "layer_routines.cuh"
#include "wgmma_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// two 128-thread halves (the rows; the GEMMs' consumer warpgroups) and the
// GEMMs' producer warp
constexpr int HALVES = 2, THREADS = wg::THREADS;
static_assert(HALVES * rohm::GROUP == wg::CONSUMERS, "the halves are the consumer warpgroups");
// the tile width of each GEMM phase
constexpr int BN_QKV = 64, BN_OUT = 64, BN_FF1 = 64, BN_FF2 = 64;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int BN_MAX = cmax(cmax(BN_QKV, BN_OUT), cmax(BN_FF1, BN_FF2));
constexpr int BLOCKS_PER_SM = 1;
// shared memory: the ring's mbarriers, then the phases' working space (the
// ring with room to align it to 1024 bytes and the epilogue's staging
// tile after it, or an attention item's, or the rows' reduction scratch)
constexpr size_t BARS = 128;
constexpr size_t RING_STAGES_BYTES = (size_t)wg::STAGES * wg::Tile<BN_MAX>::STAGE_BYTES;
constexpr size_t RING_BYTES = 1023 + RING_STAGES_BYTES + (size_t)wg::TB_M * wg::Tile<BN_MAX>::LD * 4;

// The stacked f32 parameters, each with a leading [L] dim (the order of
// prepare_layer_int8's tuple, less the four weights, which the tensor maps
// read).
struct StackParams {
  const float* sqkv;  // [L, 3D]
  const float* bqkv;  // [L, 3D]
  const float* so;    // [L, D]
  const float* bo;
  const float* ln1_s;
  const float* ln1_b;
  const float* s1;  // [L, F]
  const float* b1;
  const float* s2;  // [L, D]
  const float* b2;
  const float* ln2_s;
  const float* ln2_b;
};

struct StackArgs {
  // TMA maps: the codes q as [R, D] and as [R, F]; the weights, each
  // stored [L, N, K]
  CUtensorMap q_d, q_f, wqkv, wo, w1, w2;
  const __nv_bfloat16* x;  // [R, D] input
  __nv_bfloat16* out;      // [R, D] output
  StackParams w;
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

// The grid-wide barrier between two phases. Before a GEMM phase the fence
// first: what this thread wrote or read with plain accesses since the last
// one (q, the shared memory the ring reuses) is then ordered before the
// GEMM phase's TMA loads.
template <bool GEMM_NEXT>
__device__ __forceinline__ void phase_end(cg::grid_group& grid, const StackArgs& p, int& k) {
  if (GEMM_NEXT) asm volatile("fence.proxy.async;" ::: "memory");
  grid.sync();
  stamp(p, k);
}

// One GEMM phase: C [M, N] from the codes of `ta` (q) and layer `layer` of
// `tw`, in 128 x BN tiles handed out to the blocks.
template <int MODE, int BN>
__device__ __forceinline__ void gemm_phase(wg::Ring& ring, const CUtensorMap* ta, const CUtensorMap* tw, int layer,
                                           const float* rs, const float* cs, const float* bias, void* C, int M,
                                           int N, int K) {
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + wg::TB_M - 1) / wg::TB_M);
  const rohm::Int8Epilogue<MODE, false> epi{rs, cs, bias, C, N};
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int m0 = (i / tiles_n) * wg::TB_M, n0 = (i % tiles_n) * BN;
    auto load = [&](uint32_t a, uint32_t b, uint32_t full, int k) {
      wg::tma_load(a, ta, full, k, m0);
      wg::tma_load3(b, tw, full, k, n0, layer);
    };
    wg::gemm_tile<false, true, BN, wg::S8>(ring, m0, n0, M, N, 0, K, load, epi);
  }
}

// TILED: S past one attention tile (attn_bf16::tiled); its own instantiation,
// so that the shipped lengths run the row-item attention code alone
template <bool TILED>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) encoder_stack_int8_kernel(
    __grid_constant__ const StackArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* work = smem + BARS;
  wg::Ring ring = wg::ring_init(work, rohm::smem_u32(smem));
  // the epilogue's staging tile after the ring's stages
  ring.tile = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ring.tile) + RING_STAGES_BYTES);
  const int R = p.B * p.S, D = p.D, F = p.F, dh = D / p.H;
  // this half's first row (none for the producer warp), all halves
  const int half = threadIdx.x / rohm::GROUP, t = threadIdx.x % rohm::GROUP, bar = 1 + half;
  const int g = half < HALVES ? blockIdx.x * HALVES + half : R, ng = gridDim.x * HALVES;
  const int s_pad = (p.S + 15) / 16 * 16, chunks = s_pad / rohm::attn_bf16::QC;
  // attention items per (sequence, head): its row items, or (TILED) its
  // 16-query chunks
  const int per_head = TILED ? chunks : rohm::attn_bf16::row_items(s_pad);
  const int item_chunks = rohm::attn_bf16::item_chunks(s_pad);
  float* scratch = reinterpret_cast<float*>(work) + half * 32;
  constexpr int T = rohm::GROUP;
  int k = 0;
  stamp(p, k);

  // layer 0's input rows -> int8
  for (int r = g; r < R; r += ng)
    rohm::quant_row(p.x + (size_t)r * D, p.q + (size_t)r * D, p.qscale + r, D, 0.0f, t, T, bar, scratch);
  phase_end<true>(grid, p, k);

  const __nv_bfloat16* xin = p.x;
  for (int l = 0; l < p.L; ++l) {
    // the last layer writes `out`, the one before it `xbuf`, and so on
    __nv_bfloat16* xout = (p.L - 1 - l) % 2 == 0 ? p.out : p.xbuf;
    const StackParams& w = p.w;
    const size_t ld3 = (size_t)l * 3 * D, ld1 = (size_t)l * D, ldf = (size_t)l * F;

    gemm_phase<0, BN_QKV>(ring, &p.q_d, &p.wqkv, l, p.qscale, w.sqkv + ld3, w.bqkv + ld3, p.qkv, R, 3 * D, D);
    phase_end<false>(grid, p, k);

    for (int i = blockIdx.x; i < per_head * p.B * p.H; i += gridDim.x) {
      const int bh = i / per_head, c = i % per_head;
      if (TILED) {
        rohm::attention_bf16_tiled_item<false>(p.qkv, p.attn, p.S, p.H, dh, bh / p.H, bh % p.H,
                                               c * rohm::attn_bf16::QC, work);
      } else {
        const int c0 = c * item_chunks;
        rohm::attention_bf16_rows<false, 0>(p.qkv, p.attn, p.S, p.H, dh, s_pad, bh / p.H, bh % p.H,
                                            c0 * rohm::attn_bf16::QC, min(item_chunks, chunks - c0), work);
      }
    }
    phase_end<false>(grid, p, k);

    for (int r = g; r < R; r += ng)
      rohm::quant_row(p.attn + (size_t)r * D, p.q + (size_t)r * D, p.qscale + r, D, 0.0f, t, T, bar,
                      scratch);
    phase_end<true>(grid, p, k);

    gemm_phase<1, BN_OUT>(ring, &p.q_d, &p.wo, l, p.qscale, w.so + ld1, w.bo + ld1, p.a, R, D, D);
    phase_end<false>(grid, p, k);

    for (int r = g; r < R; r += ng) {
      const size_t o = (size_t)r * D;
      rohm::residual_layernorm_row<__nv_bfloat16, false>(xin + o, p.a + o, w.ln1_s + ld1, w.ln1_b + ld1,
                                                         p.y + o, nullptr, D, p.eps, t, T, bar, scratch);
      rohm::quant_row(p.y + o, p.q + o, p.qscale + r, D, 0.0f, t, T, bar, scratch);
    }
    phase_end<true>(grid, p, k);

    gemm_phase<2, BN_FF1>(ring, &p.q_d, &p.w1, l, p.qscale, w.s1 + ldf, w.b1 + ldf, p.h1, R, F, D);
    phase_end<false>(grid, p, k);

    for (int r = g; r < R; r += ng)
      rohm::quant_row(p.h1 + (size_t)r * F, p.q + (size_t)r * F, p.qscale + r, F, 0.0f, t, T, bar,
                      scratch);
    phase_end<true>(grid, p, k);

    gemm_phase<1, BN_FF2>(ring, &p.q_f, &p.w2, l, p.qscale, w.s2 + ld1, w.b2 + ld1, p.a, R, D, F);
    phase_end<false>(grid, p, k);

    const bool last = l + 1 == p.L;
    for (int r = g; r < R; r += ng) {
      const size_t o = (size_t)r * D;
      rohm::residual_layernorm_row<float, false>(p.y + o, p.a + o, w.ln2_s + ld1, w.ln2_b + ld1, nullptr,
                                                 xout + o, D, p.eps, t, T, bar, scratch);
      if (!last) rohm::quant_row(xout + o, p.q + o, p.qscale + r, D, 0.0f, t, T, bar, scratch);
    }
    if (!last || p.phase_ns) phase_end<true>(grid, p, k);
    xin = xout;
  }
}

size_t smem_bytes(int S, int dh) {
  const size_t attn = rohm::attn_bf16::smem_bytes((S + 15) / 16 * 16, dh);
  return BARS + (attn > RING_BYTES ? attn : RING_BYTES);
}

const void* stack_kernel(int S) {
  return rohm::attn_bf16::tiled((S + 15) / 16 * 16) ? (const void*)encoder_stack_int8_kernel<true>
                                                     : (const void*)encoder_stack_int8_kernel<false>;
}

// Blocks per SM the card holds at once for this S and dh, and the SM count.
cudaError_t grid_size(int S, int dh, int* per_sm, int* sms) {
  const size_t smem = smem_bytes(S, dh);
  cudaError_t err = cudaFuncSetAttribute(stack_kernel(S), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stack_kernel(S), THREADS, smem);
  return err;
}

}  // namespace

// grid: three host ints, set to the blocks per SM of the launch, the SM
// count and the threads of a block.
extern "C" int rt_encoder_stack_int8_grid(int S, int dh, void* grid) {
  int* out = static_cast<int*>(grid);
  out[2] = THREADS;
  return (int)grid_size(S, dh, &out[0], &out[1]);
}

// weights: 16 device pointers (host array) in prepare_layer_int8's order,
// each tensor with a leading [L] dim, the four int8 weights stored
// [L, N, K] (K-major); work: 8 device pointers (host array)
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
  const int R = B * S;
  if (!wg::encode<wg::S8>(&p.q_d, work[1], R, D, wg::TB_M) || !wg::encode<wg::S8>(&p.q_f, work[1], R, F, wg::TB_M) ||
      !wg::encode_stacked<wg::S8>(&p.wqkv, weights[0], L, 3 * D, D, BN_QKV) ||
      !wg::encode_stacked<wg::S8>(&p.wo, weights[3], L, D, D, BN_OUT) ||
      !wg::encode_stacked<wg::S8>(&p.w1, weights[8], L, F, D, BN_FF1) ||
      !wg::encode_stacked<wg::S8>(&p.w2, weights[11], L, D, F, BN_FF2))
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  auto f = [&](int i) { return static_cast<const float*>(weights[i]); };
  p.w = StackParams{f(1), f(2), f(4), f(5), f(6), f(7), f(9), f(10), f(12), f(13), f(14), f(15)};
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
  err = cudaLaunchCooperativeKernel(stack_kernel(S), dim3(per_sm * sms), dim3(THREADS), args,
                                    smem_bytes(S, D / H), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
