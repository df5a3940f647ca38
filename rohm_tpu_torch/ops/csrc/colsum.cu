// colsum: column sums over all rows, deterministic.
//   out_a[n]  = sum_r a[r, n]             (the bias gradients, dbeta)
//   out_ab[n] = sum_r a[r, n] * b[r, n]   (dgamma = sum dy * norm; optional)
// a, b [R, N] f32. Stage 1: one block per (128 columns, chunk of rows), each
// thread sums its column over the chunk into a workspace [2, chunks, N];
// stage 2 adds the chunks in order. The sums are the same from run to run
// (no atomics).
//
// Replaces the parameter-gradient reductions of rohm_tpu/ops/
// transformer_layer_train.py::_bwd_kernel (:227, :239, :254, :307, :316-318):
// the TPU kernel sums them per group and across its sequential grid; Hopper
// blocks run in no order, so the sums become these column reductions.
// Bound: memory traffic (R x N x 4 bytes read, once per operand).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) colsum_partial_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ part_a,
    float* __restrict__ part_ab, int R, int N, int rows_per_chunk) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
  float sa = 0.0f, sab = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const float v = a[(size_t)r * N + n];
    sa = __fadd_rn(sa, v);
    if (b) sab = __fadd_rn(sab, __fmul_rn(v, b[(size_t)r * N + n]));
  }
  part_a[(size_t)blockIdx.y * N + n] = sa;
  if (b) part_ab[(size_t)blockIdx.y * N + n] = sab;
}

__global__ void __launch_bounds__(THREADS) colsum_final_kernel(
    const float* __restrict__ part_a, const float* __restrict__ part_ab, float* __restrict__ out_a,
    float* __restrict__ out_ab, int N, int chunks) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float sa = 0.0f, sab = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    sa = __fadd_rn(sa, part_a[(size_t)c * N + n]);
    if (out_ab) sab = __fadd_rn(sab, part_ab[(size_t)c * N + n]);
  }
  out_a[n] = sa;
  if (out_ab) out_ab[n] = sab;
}

}  // namespace

// b and out_ab: both null or both given. workspace: [2, chunks, N] f32 with
// chunks = ceil(R / rows_per_chunk).
extern "C" int rt_colsum(const void* a, const void* b, void* out_a, void* out_ab, void* workspace,
                         int R, int N, int rows_per_chunk, void* stream) {
  if (R <= 0 || N <= 0 || rows_per_chunk <= 0 || (!b) != (!out_ab)) return (int)cudaErrorInvalidValue;
  const int chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part_a = static_cast<float*>(workspace);
  float* part_ab = part_a + (size_t)chunks * N;
  const int col_blocks = (N + THREADS - 1) / THREADS;
  colsum_partial_kernel<<<dim3(col_blocks, chunks), THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), part_a, part_ab, R, N,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  colsum_final_kernel<<<col_blocks, THREADS, 0, s>>>(part_a, part_ab, static_cast<float*>(out_a),
                                                    static_cast<float*>(out_ab), N, chunks);
  return (int)cudaGetLastError();
}
