// Cell-list nearest neighbour for city-scale ICP and LUM correspondence
// search.
//
// Replaces the TPU kernel tpu3dtk/ops/nn_pallas.py::_run_kernel (its inner
// `kernel`): per chunk of T cell-sorted queries, the argmin over 9
// contiguous ranges of the cell-sorted model (one per (dx, dy) neighbour
// column) of a ranking score, length-masked, with a running (min, row)
// across the ranges.  The TPU kernel copies every range, padded to a
// static width RB, into VMEM and ranks |c|^2 - 2 q.c on the MXU from bf16
// hi/lo splits of chunk-centred coordinates.  None of that carries over:
// with 3 coordinates the CUDA cores rank the exact f32 direct difference
// (q - c).(q - c), no centring and no split, and a block streams a range
// of any length, so it reads exactly `length` rows per range.
//
// What bounds it on an H100: the instruction rate of the FP32 pipes, about
// 13 instruction slots per (query, candidate) pair (3 subtracts, 3
// multiplies, 2 adds, a compare, two selects, the loop, and a share of the
// shared-memory broadcast load), the same inner loop as nn_brute.cu.  The
// bytes are small: each chunk reads its candidates once (16 B per row),
// against T = 256 queries that each rank every row.  So it is
// compute-bound, and the work is set by the table: sum over chunks of
// T x (candidate rows).
//
// Design:
//   * one block per chunk, one query per thread, (best score, best row) in
//     registers; the block loads its own table row into shared memory (the
//     TPU's scalar prefetch has no counterpart here);
//   * each range is staged through shared memory in tiles of TILE float4
//     rows (x, y, z, pad) with coalesced 16-byte loads, and every thread
//     ranks the whole tile;
//   * strict < across tiles and ranges: the lowest row of the earliest
//     range wins a tie; a query with no candidate keeps row 0 and +inf.
// The chunks' candidate counts are heavy-tailed, so blocks finish at
// different times; at city scale there are ~10 blocks per SM to even that
// out.  Asynchronous double buffering and splitting long ranges across
// blocks are left for later.
//
// The products and sums are rounded one by one (no FMA contraction), in
// the order of the plain PyTorch version
// (ops/nn_cell_list.py::cell_list_rows), so the two choose identical rows
// on identical inputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 1024;      // model rows staged per pass (16 KB)
constexpr int TABLE_COLS = 29;  // query start, count, 9 x (start, shift, len)

__global__ void __launch_bounds__(256)
cell_list_kernel(const int* __restrict__ table,
                 const float4* __restrict__ query,
                 const float4* __restrict__ model, int model_rows,
                 int* __restrict__ out_rows, float* __restrict__ out_score) {
  __shared__ float4 tile[TILE];
  __shared__ int tab[TABLE_COLS];
  const int T = blockDim.x;
  const int w = blockIdx.x;
  if (threadIdx.x < TABLE_COLS) {
    tab[threadIdx.x] = table[w * TABLE_COLS + threadIdx.x];
  }
  __syncthreads();
  const float4 q = query[w * T + threadIdx.x];
  float best = CUDART_INF_F;
  int best_row = 0;
  for (int r = 0; r < 9; ++r) {
    // the same for every thread of the block: no divergence at the barriers
    int start = tab[2 + 3 * r] + tab[3 + 3 * r];
    start = max(0, min(start, model_rows));
    const int len = min(tab[4 + 3 * r], model_rows - start);
    for (int t0 = 0; t0 < len; t0 += TILE) {
      const int n = min(TILE, len - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int k = threadIdx.x; k < n; k += T) tile[k] = model[start + t0 + k];
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float4 p = tile[k];
        const float dx = __fsub_rn(q.x, p.x);
        const float dy = __fsub_rn(q.y, p.y);
        const float dz = __fsub_rn(q.z, p.z);
        float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
        if (d2 < best) {
          best = d2;
          best_row = start + t0 + k;
        }
      }
    }
  }
  out_rows[w * T + threadIdx.x] = best_row;
  out_score[w * T + threadIdx.x] = best;
}

}  // namespace

// table: [W, 29] int32 (per range r: columns 2+3r aligned start, 3+3r
// shift, 4+3r length; a range is rows [start+shift, start+shift+length) of
// `model`).  query: [W*T] float4 cell-sorted queries; model: [model_rows]
// float4 cell-sorted model; out_rows / out_score: [W*T].  T (threads per
// block, one query each) is 128 or 256.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int tpu3dtk_nn_cell_list_f32(const void* table, const void* query,
                                        const void* model, int W, int T,
                                        int model_rows, void* out_rows,
                                        void* out_score, void* stream) {
  if (W <= 0 || model_rows <= 0 || T < 32 || T > 256 || T % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cell_list_kernel<<<W, T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const float4*>(query),
      static_cast<const float4*>(model), model_rows,
      static_cast<int*>(out_rows), static_cast<float*>(out_score));
  return static_cast<int>(cudaGetLastError());
}
