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
// What bounds it on an H100: the instruction rate of the SM's schedulers (one
// warp instruction per scheduler per clock), not bytes (16 B per model
// point per block) and not the f32 peak, because only 8 of the slots of
// a (query, model) pair are f32 arithmetic (3 subtracts, 3 multiplies, 2
// adds; no FMA, see below).  The design is about the slots beside those
// 8, and about what a call costs around the ranking:
//
//   * register tiling: a thread owns QPT = 4 queries and ranks all of
//     them against each float4 it reads from shared memory, so the
//     broadcast load and the loop overhead are shared: 1/4 slot a pair;
//   * min first, index later: the running best of a query is a bare
//     fminf (1 slot a pair).  Per group of G = 16 candidates one compare
//     and two selects record the group in which the best last improved
//     (3/16 slot a pair); after the slice the thread re-ranks that one
//     group from global memory with the same arithmetic and takes the
//     first candidate whose score equals the best.  "Improved" is a strict
//     <, so that group holds the lowest index among equal scores.  No
//     branch depends on the data inside the loop, so warps do not diverge.
//     The compiled loop has 613 instructions for a group's 64 pairs, 9.6
//     instruction slots a pair (5 FADD, 3 FMUL, 1 FMNMX, 0.25 LDS, 0.33 others),
//     against 13 for one query per thread with a compare and two selects
//     per pair;
//   * masked model points are stored with +inf coordinates by the wrapper
//     (ops/nn.py::prepare_brute_model), so their score is +inf and the
//     loop carries no mask word;
//   * the model axis is split into slices (blockIdx.y) so that a
//     16k-query match fills the card; the slices of one query meet in a
//     packed 64-bit key, (bits of d2) << 32 | index, by atomicMin: d2 >= 0,
//     so its bits order like its value, and equal d2 keeps the lowest
//     index whatever the order of arrival.  No [S, Q] scratch, no merge
//     pass;
//   * prologue and epilogue are in the kernels: the rank kernel reads the
//     raw [Q, 3] query and subtracts the model centre itself; the accept
//     kernel unpacks the key and writes what ops/nn.py::accept returns
//     (int64 index, d2 recomputed from the uncentred points, the strict
//     gate).  One C call = three launches: fill, rank, accept.
//
// Semantics kept from the TPU kernel and its wrapper:
//   * ties keep the lowest model index; a query whose every candidate is
//     masked gets index 0 (the key's initial value);
//   * both clouds are centred on the masked model mean for the ranking,
//     the winner's d2 is recomputed from the uncentred coordinates, and
//     found = qmask & mmask[idx] & (d2 < max_dist2), strict.
// The products and sums are rounded one by one (no FMA contraction), in
// the order of the plain PyTorch version (ops/nn.py::nn_brute), so the
// two rank identically on identical inputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BT = 128;     // threads per block
constexpr int QPT = 4;      // queries per thread
constexpr int G = 16;       // candidates per group (one index bookkeeping)
constexpr int TILE = 1024;  // model points staged per pass (16 KB)
constexpr unsigned long long KEY_NONE = 0x7F80000000000000ull;  // +inf, index 0
constexpr float BIG = 3.4e38f;  // d2 reported for a masked winner

static_assert(TILE % G == 0, "a tile holds whole groups");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         const float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void nn_fill_kernel(unsigned long long* __restrict__ key, int Q) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi < Q) key[qi] = KEY_NONE;
}

__global__ void __launch_bounds__(BT)
nn_rank_kernel(const float* __restrict__ query,
               const float* __restrict__ center,
               const float4* __restrict__ model, int Q, int M, int chunk,
               unsigned long long* __restrict__ key) {
  __shared__ float4 tile[TILE];
  const int lo = blockIdx.y * chunk;
  const int hi = min(M, lo + chunk);
  const float cx = center[0], cy = center[1], cz = center[2];
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int grp[QPT];  // first model index of the group where best last improved
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int qi = (blockIdx.x * QPT + k) * BT + threadIdx.x;
    const bool live = qi < Q;
    qx[k] = live ? __fsub_rn(query[3 * qi + 0], cx) : 0.f;
    qy[k] = live ? __fsub_rn(query[3 * qi + 1], cy) : 0.f;
    qz[k] = live ? __fsub_rn(query[3 * qi + 2], cz) : 0.f;
    best[k] = CUDART_INF_F;
    grp[k] = -1;
  }
  const float4 pad = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    const int npad = (n + G - 1) / G * G;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < npad; j += BT) {
      tile[j] = j < n ? model[t0 + j] : pad;
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
          grp[k] = t0 + g0;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int qi = (blockIdx.x * QPT + k) * BT + threadIdx.x;
    if (qi >= Q || grp[k] < 0) continue;
    // the first candidate of that group whose score equals the best; rows
    // past the slice's end come after it and cannot displace it
    int idx = grp[k];
    for (int j = G - 1; j >= 0; --j) {
      const int i = grp[k] + j;
      if (i < M && sq_dist(qx[k], qy[k], qz[k], model[i]) == best[k]) idx = i;
    }
    atomicMin(&key[qi],
              (static_cast<unsigned long long>(__float_as_uint(best[k])) << 32) |
                  static_cast<unsigned int>(idx));
  }
}

__global__ void nn_accept_kernel(const unsigned long long* __restrict__ key,
                                 const float* __restrict__ query,
                                 const unsigned char* __restrict__ qmask,
                                 const float* __restrict__ model,
                                 const unsigned char* __restrict__ mmask,
                                 int Q, float max_dist2,
                                 long long* __restrict__ out_idx,
                                 float* __restrict__ out_d2,
                                 unsigned char* __restrict__ out_found) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  const unsigned int idx = static_cast<unsigned int>(key[qi] & 0xFFFFFFFFull);
  const float dx = __fsub_rn(query[3 * qi + 0], model[3 * idx + 0]);
  const float dy = __fsub_rn(query[3 * qi + 1], model[3 * idx + 1]);
  const float dz = __fsub_rn(query[3 * qi + 2], model[3 * idx + 2]);
  float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
  const bool valid = mmask[idx] != 0;
  d2 = valid ? d2 : BIG;
  out_idx[qi] = static_cast<long long>(idx);
  out_d2[qi] = d2;
  out_found[qi] = (qmask[qi] != 0 && valid && d2 < max_dist2) ? 1 : 0;
}

}  // namespace

// query: [Q, 3] f32 raw (uncentred) queries; qmask: [Q] bytes (0 / 1);
// center: [3] f32; packed: [M] float4, the model minus `center`, masked
// points at +inf; model: [M, 3] f32 uncentred; mmask: [M] bytes.  The model
// axis is cut into S slices of `chunk` points (chunk a multiple of 16,
// S * chunk >= M).  key: [Q] 64-bit scratch.  out_idx [Q] int64, out_d2 [Q]
// f32, out_found [Q] bytes.  Launches fill, rank and accept on `stream`,
// does not synchronise, and returns the first launch error (0: none).
extern "C" int tpu3dtk_nn_brute_f32(const void* query, const void* qmask,
                                    const void* center, const void* packed,
                                    const void* model, const void* mmask,
                                    int Q, int M, int S, int chunk,
                                    float max_dist2, void* key, void* out_idx,
                                    void* out_d2, void* out_found,
                                    void* stream) {
  if (Q <= 0 || M <= 0 || S <= 0 || S > 65535 || chunk <= 0 ||
      chunk % G != 0 || static_cast<long long>(S) * chunk < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* k = static_cast<unsigned long long*>(key);
  nn_fill_kernel<<<(Q + 255) / 256, 256, 0, st>>>(k, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + BT * QPT - 1) / (BT * QPT), S);
  nn_rank_kernel<<<grid, BT, 0, st>>>(
      static_cast<const float*>(query), static_cast<const float*>(center),
      static_cast<const float4*>(packed), Q, M, chunk, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_accept_kernel<<<(Q + 255) / 256, 256, 0, st>>>(
      k, static_cast<const float*>(query),
      static_cast<const unsigned char*>(qmask),
      static_cast<const float*>(model),
      static_cast<const unsigned char*>(mmask), Q, max_dist2,
      static_cast<long long*>(out_idx), static_cast<float*>(out_d2),
      static_cast<unsigned char*>(out_found));
  return static_cast<int>(cudaGetLastError());
}
