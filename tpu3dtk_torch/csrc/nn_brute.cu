// Exact brute-force nearest neighbour for ICP correspondence search.
//
// Replaces the TPU kernel tpu3dtk/ops/nn_pallas.py::_nn_mxu_kernel
// (launched by _nn_mxu_call, wrapped by nn_brute_mxu).  That kernel ranks
// |m|^2 - 2 q.m on the MXU from bf16 hi/lo splits and carries a running
// (min, argmin) across model tiles in VMEM.  Here the score is the exact
// f32 direct difference (q - m).(q - m): with K = 3 coordinates the CUDA
// cores compute it without any split, and a bf16/TF32 product would
// mis-rank neighbours at centimetre scale.
//
// What bounds it on an H100: the instruction rate of the FP32 pipes, about
// 12 instructions per (query, model) pair (3 subtracts, 3 multiplies, 3
// adds, one of them the mask word, a compare and two selects) plus one
// shared-memory broadcast load per warp; the bytes are negligible (16 B
// per model point per block).  So it is compute-bound, and the design is
// about keeping every SM busy:
//
//   * one thread owns one query and keeps its best (d2, idx) in
//     registers; a block of BQ threads stages the model through shared
//     memory in tiles of TILE points (float4: xyz plus a mask word);
//   * the model axis is split into S slices (blockIdx.y), so that a
//     16k-query match launches many more blocks than the card has SMs;
//     each slice writes a partial (d2, idx) to an [S, Q] scratch and a
//     second, tiny pass merges the slices.
//
// Semantics kept from the TPU kernel and its wrapper:
//   * masked model points carry w = +inf and can never win;
//   * ties keep the lowest model index (strict < within a slice, and the
//     merge prefers the lower slice on equal d2); a query whose every
//     candidate is masked gets index 0, as the TPU kernel's sentinel
//     columns give;
//   * the wrapper (ops/nn_cuda.py) centres both clouds on the masked model
//     mean, recomputes the winner's d2 from the uncentred coordinates and
//     applies the strict d2 < max_dist2 gate.
// The products and sums are rounded one by one (no FMA contraction), in
// the order of the plain PyTorch version (ops/nn.py::nn_brute), so the
// two rank identically on identical inputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 128;     // queries per block, one per thread
constexpr int TILE = 1024;  // model points staged per pass (16 KB)

__global__ void __launch_bounds__(BQ)
nn_partial_kernel(const float4* __restrict__ query,
                  const float4* __restrict__ model, int Q, int M, int chunk,
                  float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float4 tile[TILE];
  const int qi = blockIdx.x * BQ + threadIdx.x;
  const int lo = blockIdx.y * chunk;
  const int hi = min(M, lo + chunk);
  const float4 q = qi < Q ? query[qi] : make_float4(0.f, 0.f, 0.f, 0.f);
  float best = CUDART_INF_F;
  int best_idx = 0;
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < n; k += BQ) tile[k] = model[t0 + k];
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float4 p = tile[k];
      const float dx = __fsub_rn(q.x, p.x);
      const float dy = __fsub_rn(q.y, p.y);
      const float dz = __fsub_rn(q.z, p.z);
      float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      d2 = __fadd_rn(__fadd_rn(d2, __fmul_rn(dz, dz)), p.w);
      if (d2 < best) {
        best = d2;
        best_idx = t0 + k;
      }
    }
  }
  if (qi < Q) {
    part_d2[blockIdx.y * Q + qi] = best;
    part_idx[blockIdx.y * Q + qi] = best_idx;
  }
}

__global__ void nn_merge_kernel(const float* __restrict__ part_d2,
                                const int* __restrict__ part_idx, int Q,
                                int S, int* __restrict__ out_idx) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  float best = part_d2[qi];
  int best_idx = part_idx[qi];
  for (int s = 1; s < S; ++s) {
    const float d = part_d2[s * Q + qi];
    if (d < best) {  // equal d2: the lower slice (lower index) stays
      best = d;
      best_idx = part_idx[s * Q + qi];
    }
  }
  out_idx[qi] = best_idx;
}

}  // namespace

// query: [Q] float4 (centred xyz, w unused); model: [M] float4 (centred
// xyz, w = 0 for a valid point, +inf for a masked one).  part_d2/part_idx:
// [S, Q] scratch; out_idx: [Q] winner per query (the wrapper recomputes
// its d2 from the uncentred points).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches.
extern "C" int tpu3dtk_nn_brute_f32(const void* query, const void* model,
                                    int Q, int M, int S, void* part_d2,
                                    void* part_idx, void* out_idx,
                                    void* stream) {
  if (Q <= 0 || M <= 0 || S <= 0 || S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = (M + S - 1) / S;
  dim3 grid((Q + BQ - 1) / BQ, S);
  nn_partial_kernel<<<grid, BQ, 0, st>>>(
      static_cast<const float4*>(query), static_cast<const float4*>(model),
      Q, M, chunk, static_cast<float*>(part_d2), static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_merge_kernel<<<(Q + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_d2), static_cast<const int*>(part_idx),
      Q, S, static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
