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
// of any length, so it reads exactly `length` rows per range and needs no
// static width.
//
// What bounds it on an H100: the instruction rate of the SM's schedulers.  The
// work is set by the table, sum over chunks of T x (candidate rows); the
// bytes are small (each chunk's candidates once, 16 B a row, against T
// queries that each rank every row), and only 8 of the instruction slots of a
// (query, candidate) pair are f32 arithmetic (3 subtracts, 3 multiplies, 2
// adds; no FMA, see below).  Two things kept the kernel off that bound
// when one block took one chunk, and the design is about them:
//
//   * the chunks' candidate counts are heavy-tailed (a city scan: mean
//     ~2k rows, longest 20-40k), so the kernel ran as long as its longest
//     block.  Now the unit of work is an ITEM: at most R consecutive rows
//     of a chunk's concatenated ranges.  The init kernel computes the
//     exclusive prefix of the chunks' item counts on the device (the
//     number of items is data; its plain version is ops/nn_cell_list.py::
//     cell_list_work_items).  A persistent grid (a fixed number of blocks
//     per SM) pulls
//     item numbers from an atomic counter, finds the item's chunk by
//     binary search in the prefix, walks its rows through shared memory in
//     tiles, and merges into a per-query packed 64-bit key, (bits of the
//     score) << 32 | position in the chunk's concatenated ranges, by
//     atomicMin: the score is >= 0, so its bits order like its value, and
//     equal scores keep the earliest position, that is the earliest range
//     and then the lowest row, whatever the order in which items finish;
//   * the inner loop, as in nn_brute.cu: a thread owns QPT = 2 queries
//     and ranks both against each float4 it reads from shared memory (1/2
//     slot a pair for the broadcast load); the running best is a bare
//     fminf (1 slot a pair); per group of G = 16 candidates one compare
//     and selects record where the best last improved (strict <, ~1/4 slot
//     a pair), and after the item the thread re-ranks that one group from
//     global memory and takes the first candidate whose score equals the
//     best.  The compiled loop has 319 instructions for a group's 32
//     pairs, 10.0 instruction slots a pair, against 13 for one query per thread
//     with a compare and two selects per pair, and no branch on the data
//     inside the loop.
//
// An epilogue kernel unpacks the key: the position is mapped back to a
// model row through the chunk's table row; a query with no candidate keeps
// row 0 and +inf.  One C call = three launches (init with the item
// prefix, items, unpack).
// Loads are plain coalesced 16-byte loads into a single shared tile: with
// 8 blocks resident on an SM, other blocks rank while one loads.  A
// two-stage cp.async ring over two half tiles was tried and measured no
// faster beyond the spread between runs (PERF.md), so it is not kept.
//
// The products and sums are rounded one by one (no FMA contraction), in
// the order of the plain PyTorch version
// (ops/nn_cell_list.py::cell_list_rows), so the two choose identical rows
// on identical inputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int QPT = 2;          // queries per thread
constexpr int G = 16;           // candidates per group (one position bookkeeping)
constexpr int TILE = 1024;      // model rows staged per pass (16 KB)
constexpr int TABLE_COLS = 29;  // query start, count, 9 x (start, shift, len)
constexpr int MAX_THREADS = 128;
constexpr int INIT_THREADS = 256;
constexpr unsigned long long KEY_NONE = 0x7F80000000000000ull;  // +inf, position 0

static_assert(TILE % G == 0, "a tile holds whole groups");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         const float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// first row and length of range r of a table row, clipped to the model
// (the clipping of cell_list_rows and cell_list_work_items)
__device__ __forceinline__ void range_of(const int* tab, int r, int model_rows,
                                         int* start, int* len) {
  const int s = max(0, min(tab[2 + 3 * r] + tab[3 + 3 * r], model_rows));
  *start = s;
  *len = max(0, min(tab[4 + 3 * r], model_rows - s));
}

// items of chunk w: its clipped candidate rows over R, rounded up
__device__ __forceinline__ long long items_of(const int* table, int w,
                                              int model_rows, int R) {
  const int* tab = table + w * TABLE_COLS;
  int total = 0;
  for (int r = 0; r < 9; ++r) {
    int start, len;
    range_of(tab, r, model_rows, &start, &len);
    total += len;
  }
  return (total + R - 1) / R;
}

// Every thread resets one key; block 0 also resets the item counter and
// writes prefix[0..W], the exclusive prefix of the chunks' item counts:
// each thread sums a run of consecutive chunks, the block scans the sums.
__global__ void __launch_bounds__(INIT_THREADS)
cell_list_init_kernel(const int* __restrict__ table, int model_rows, int W,
                      int R, unsigned long long* __restrict__ key, int n,
                      unsigned long long* counter,
                      long long* __restrict__ prefix) {
  const int i = blockIdx.x * INIT_THREADS + threadIdx.x;
  if (i < n) key[i] = KEY_NONE;
  if (blockIdx.x != 0) return;
  __shared__ long long part[INIT_THREADS];
  const int per = (W + INIT_THREADS - 1) / INIT_THREADS;
  const int lo = min(W, threadIdx.x * per);
  const int hi = min(W, lo + per);
  long long sum = 0;
  for (int w = lo; w < hi; ++w) sum += items_of(table, w, model_rows, R);
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int step = 1; step < INIT_THREADS; step <<= 1) {  // inclusive scan
    const long long add = threadIdx.x >= step ? part[threadIdx.x - step] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  long long run = part[threadIdx.x] - sum;  // exclusive
  for (int w = lo; w < hi; ++w) {
    prefix[w] = run;
    run += items_of(table, w, model_rows, R);
  }
  if (threadIdx.x == INIT_THREADS - 1) {
    prefix[W] = part[threadIdx.x];
    *counter = 0ull;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
cell_list_items_kernel(const int* __restrict__ table,
                       const long long* __restrict__ prefix,
                       const float4* __restrict__ query,
                       const float4* __restrict__ model, int model_rows, int W,
                       int R, unsigned long long* __restrict__ key,
                       unsigned long long* counter) {
  __shared__ float4 tile[TILE];
  __shared__ int tab[TABLE_COLS];
  __shared__ long long s_item;
  __shared__ int s_chunk;
  const int NT = blockDim.x;  // T / QPT
  const int T = NT * QPT;
  const long long n_items = prefix[W];
  const float4 pad = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  for (;;) {
    __syncthreads();  // the previous item's shared state is no longer read
    if (threadIdx.x == 0) {
      const long long item = static_cast<long long>(atomicAdd(counter, 1ull));
      int lo = 0;
      if (item < n_items) {
        // the chunk w with prefix[w] <= item < prefix[w + 1]
        int hi = W;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (prefix[mid] <= item) lo = mid; else hi = mid;
        }
      }
      s_item = item;
      s_chunk = lo;
    }
    __syncthreads();
    const long long item = s_item;
    if (item >= n_items) break;  // the same for every thread of the block
    const int w = s_chunk;
    if (threadIdx.x < TABLE_COLS) {
      tab[threadIdx.x] = table[w * TABLE_COLS + threadIdx.x];
    }
    __syncthreads();
    // the item's span of the chunk's concatenated ranges
    const int s0 = static_cast<int>(item - prefix[w]) * R;
    const int s1 = s0 + R;
    float qx[QPT], qy[QPT], qz[QPT], best[QPT];
    int grp_row[QPT], grp_pos[QPT];  // where the best last improved
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const float4 q = query[w * T + k * NT + threadIdx.x];
      qx[k] = q.x;
      qy[k] = q.y;
      qz[k] = q.z;
      best[k] = CUDART_INF_F;
      grp_row[k] = -1;
      grp_pos[k] = 0;
    }
    int off = 0;  // position of the range's first row
    for (int r = 0; r < 9; ++r) {
      // all of this is the same for every thread: no divergence at the barriers
      int start, len;
      range_of(tab, r, model_rows, &start, &len);
      const int a = max(s0, off);
      const int b = min(s1, off + len);
      for (int p0 = a; p0 < b; p0 += TILE) {
        const int n = min(TILE, b - p0);
        const int npad = (n + G - 1) / G * G;
        const int row0 = start + (p0 - off);
        __syncthreads();  // the previous tile is no longer read
        for (int j = threadIdx.x; j < npad; j += NT) {
          tile[j] = j < n ? model[row0 + j] : pad;
        }
        __syncthreads();
        for (int g0 = 0; g0 < npad; g0 += G) {
          float gmin[QPT];
#pragma unroll
          for (int k = 0; k < QPT; ++k) gmin[k] = CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float4 p = tile[g0 + j];
#pragma unroll
            for (int k = 0; k < QPT; ++k) {
              gmin[k] = fminf(gmin[k], sq_dist(qx[k], qy[k], qz[k], p));
            }
          }
#pragma unroll
          for (int k = 0; k < QPT; ++k) {
            if (gmin[k] < best[k]) {
              best[k] = gmin[k];
              grp_row[k] = row0 + g0;
              grp_pos[k] = p0 + g0;
            }
          }
        }
      }
      off += len;
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      if (grp_row[k] < 0) continue;
      // the first candidate of that group whose score equals the best; rows
      // past the group's valid part come after it and cannot displace it
      int hit = 0;
      for (int j = G - 1; j >= 0; --j) {
        const int row = grp_row[k] + j;
        if (row < model_rows &&
            sq_dist(qx[k], qy[k], qz[k], model[row]) == best[k]) {
          hit = j;
        }
      }
      atomicMin(&key[w * T + k * NT + threadIdx.x],
                (static_cast<unsigned long long>(__float_as_uint(best[k])) << 32) |
                    static_cast<unsigned int>(grp_pos[k] + hit));
    }
  }
}

__global__ void cell_list_unpack_kernel(const unsigned long long* __restrict__ key,
                                        const int* __restrict__ table,
                                        int model_rows, int n, int T,
                                        int* __restrict__ out_rows,
                                        float* __restrict__ out_score) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = key[i];
  const float score = __uint_as_float(static_cast<unsigned int>(k >> 32));
  int row = 0;
  if (k != KEY_NONE) {
    const int* tab = table + (i / T) * TABLE_COLS;
    int pos = static_cast<int>(k & 0xFFFFFFFFull);
    for (int r = 0; r < 9; ++r) {
      int start, len;
      range_of(tab, r, model_rows, &start, &len);
      if (pos < len) {
        row = start + pos;
        break;
      }
      pos -= len;
    }
  }
  out_rows[i] = row;
  out_score[i] = score;
}

}  // namespace

// table: [W, 29] int32 (per range r: columns 2+3r aligned start, 3+3r
// shift, 4+3r length; a range is rows [start+shift, start+shift+length) of
// `model`).  query: [W*T] float4 cell-sorted queries; model: [model_rows]
// float4 cell-sorted model, 9 * model_rows + R < 2^31; a work item is at
// most R rows of a chunk's concatenated ranges.  scratch: [W*T + W + 2]
// 64-bit words (the keys, the item counter, then the [W+1] exclusive
// prefix of the chunks' item counts).  out_rows / out_score: [W*T].  T
// (queries per chunk) is 128 or 256; `blocks` is the size of the
// persistent grid.  Launches init, items and unpack on `stream`, does not
// synchronise, and returns the first launch error (0: none).
extern "C" int tpu3dtk_nn_cell_list_f32(const void* table,
                                        const void* query, const void* model,
                                        int W, int T, int model_rows, int R,
                                        int blocks, void* scratch,
                                        void* out_rows, void* out_score,
                                        void* stream) {
  if (W <= 0 || model_rows <= 0 || R <= 0 || blocks <= 0 ||
      (T != 128 && T != 256) || 9LL * model_rows + R > 0x7FFFFFFF ||
      static_cast<long long>(W) * T > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = W * T;
  unsigned long long* key = static_cast<unsigned long long*>(scratch);
  unsigned long long* counter = key + n;
  long long* prefix = reinterpret_cast<long long*>(counter + 1);
  cell_list_init_kernel<<<(n + INIT_THREADS - 1) / INIT_THREADS, INIT_THREADS,
                          0, st>>>(static_cast<const int*>(table), model_rows,
                                   W, R, key, n, counter, prefix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_list_items_kernel<<<blocks, T / QPT, 0, st>>>(
      static_cast<const int*>(table), prefix,
      static_cast<const float4*>(query), static_cast<const float4*>(model),
      model_rows, W, R, key, counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_list_unpack_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      key, static_cast<const int*>(table), model_rows, n, T,
      static_cast<int*>(out_rows), static_cast<float*>(out_score));
  return static_cast<int>(cudaGetLastError());
}
