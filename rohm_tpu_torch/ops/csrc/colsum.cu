// colsum: column sums over all rows, deterministic, in one launch.
//   out_a[n]  = sum_r a[r, n]             (the bias gradients, dbeta)
//   out_ab[n] = sum_r a[r, n] * b[r, n]   (dgamma = sum dy * norm; optional)
// a, b [R, N] f32, N a multiple of 4.
//
// Replaces the parameter-gradient reductions of rohm_tpu/ops/
// transformer_layer_train.py::_bwd_kernel (:227, :239, :254, :307, :316-318):
// the TPU kernel sums them per group and across its sequential grid; Hopper
// blocks run in no order, so the sums become these column reductions.
//
// Bound: memory traffic (R x N x 4 bytes read, once per operand). A
// thread-block cluster of CLUSTER blocks takes 32 columns; block k of it
// takes the k-th of CLUSTER contiguous row ranges. Each thread owns four
// columns (one 16-byte load per row: eight lanes cover a row's 128 bytes,
// a warp four rows) and every 64th row of its block's range, with UNROLL
// rows' loads in flight, summed in row order. The block's 64 partial rows
// are added in shared memory by a fixed tree, then block 0 of the cluster
// adds the CLUSTER blocks' sums in rank order through distributed shared
// memory. Every sum's order depends on R and N alone: the same bits from
// run to run, with no atomics and no workspace. N = 512 gives 128 blocks of
// 512 threads, about one per SM of an H100.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int QUADS = 8;                 // four-column groups of a block: 32 columns
constexpr int SLOTS = THREADS / QUADS;   // rows a block reads at once
constexpr int CLUSTER = 8;               // blocks (row ranges) per 32 columns
constexpr int UNROLL = 4;

__device__ __forceinline__ float4 add4(float4 s, float4 v) {
  return make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

template <bool AB>
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(THREADS) colsum_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out_a,
    float* __restrict__ out_ab, int R, int N) {
  __shared__ float4 part[AB ? 2 : 1][SLOTS][QUADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int quad = threadIdx.x % QUADS, slot = threadIdx.x / QUADS;
  const int n = blockIdx.x * 4 * QUADS + 4 * quad;
  const int per = (R + CLUSTER - 1) / CLUSTER, r1 = min(R, (rank + 1) * per);
  float4 sa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sab = sa;
  if (n < N) {
    int r = rank * per + slot;
    for (; r + (UNROLL - 1) * SLOTS < r1; r += UNROLL * SLOTS) {
      float4 va[UNROLL], vb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t o = (size_t)(r + u * SLOTS) * N + n;
        va[u] = __ldg(reinterpret_cast<const float4*>(a + o));
        if constexpr (AB) vb[u] = __ldg(reinterpret_cast<const float4*>(b + o));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sa = add4(sa, va[u]);
        if constexpr (AB) sab = add4(sab, mul4(va[u], vb[u]));
      }
    }
    for (; r < r1; r += SLOTS) {
      const size_t o = (size_t)r * N + n;
      const float4 va = __ldg(reinterpret_cast<const float4*>(a + o));
      sa = add4(sa, va);
      if constexpr (AB) sab = add4(sab, mul4(va, __ldg(reinterpret_cast<const float4*>(b + o))));
    }
  }
  part[0][slot][quad] = sa;
  if constexpr (AB) part[1][slot][quad] = sab;
  __syncthreads();
  for (int half = SLOTS / 2; half > 0; half /= 2) {
    if (slot < half) {
      part[0][slot][quad] = add4(part[0][slot][quad], part[0][slot + half][quad]);
      if constexpr (AB) part[1][slot][quad] = add4(part[1][slot][quad], part[1][slot + half][quad]);
    }
    __syncthreads();
  }
  cluster.sync();  // every block's sums are in its shared memory
  if (rank == 0 && slot < (AB ? 2 : 1) && n < N) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < CLUSTER; ++k) s = add4(s, cluster.map_shared_rank(&part[slot][0][0], k)[quad]);
    *reinterpret_cast<float4*>((slot ? out_ab : out_a) + n) = s;
  }
  cluster.sync();  // block 0 is done reading the others' shared memory
}

}  // namespace

// b and out_ab: both null or both given. N a multiple of 4; every pointer
// 16-byte aligned.
extern "C" int rt_colsum(const void* a, const void* b, void* out_a, void* out_ab, int R, int N,
                         void* stream) {
  if (R <= 0 || N <= 0 || N % 4 || (!b) != (!out_ab)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 4 * QUADS - 1) / (4 * QUADS), CLUSTER);
  const auto* aa = static_cast<const float*>(a);
  const auto* bb = static_cast<const float*>(b);
  auto* oa = static_cast<float*>(out_a);
  auto* oab = static_cast<float*>(out_ab);
  if (b)
    colsum_kernel<true><<<grid, THREADS, 0, s>>>(aa, bb, oa, oab, R, N);
  else
    colsum_kernel<false><<<grid, THREADS, 0, s>>>(aa, bb, oa, oab, R, N);
  return (int)cudaGetLastError();
}
