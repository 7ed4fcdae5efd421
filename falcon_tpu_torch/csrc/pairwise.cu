// Three launchers of the pair-matching routine (matching.cuh), with a
// plain C interface for ctypes (falcon_tpu_torch/ops/_build.py).  Each
// function launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of its launch.
//
// K1, falcon_panel_scores, replaces the Pallas kernel
// falcon_tpu/ops/pairwise.py::_pair_panel_kernel (launched by
// panel_scores_pallas): the score of every (row, column) spectrum pair of a
// panel, or with upper_only only of the pairs above the global diagonal.
// It is bound by the compares and maxima of matching.cuh, not by bytes: a
// pair reads 1 KB and writes 8 bytes.  Design: a block takes one row
// spectrum and K1_COLS consecutive columns, each of its warps scores one
// pair at a time; blocks wholly at or below the diagonal return at once.
//
// K4, falcon_grouped_scores, replaces falcon_tpu/ops/pairwise.py::
// batched_block_scores (XLA, no Pallas): every upper-triangle pair of many
// small intervals in one launch.  Intervals are ragged (spectrum offsets
// `starts`) instead of padded to a common size, and the output is their
// condensed distance order, interval after interval.  Same bound as K1.
// Design: a grid-stride loop of warps over the pair index; a warp finds its
// interval by binary search over `pair_starts` and its (i, j) by inverting
// the condensed index.
//
// falcon_pair_list_scores replaces the exact scoring inside
// falcon_tpu/ops/rerank.py::rerank_scan_body (XLA, no Pallas), as the
// pruned linkage calls it (falcon_tpu/ops/pairwise.py::_rerank_pool): each
// query row against its own list of K pool ids, -1 = none.  Same bound as
// K1.  Design: K4's grid-stride loop of warps over the (query, slot)
// entries in row-major order, so the warps of a block share one query row;
// a warp whose id is -1 writes PL_MISSING and takes the next entry.  The
// later rerank adds a top-k over each row's slots around this launcher.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "matching.cuh"

namespace falcon {

constexpr int K1_WARPS = 2;   // 2 x 17 KB of shared memory per block
constexpr int K1_COLS = 32;   // columns per block
constexpr int K4_WARPS = 2;
constexpr int K4_MAX_BLOCKS = 8192;
constexpr int PL_WARPS = 2;
constexpr int PL_MAX_BLOCKS = 8192;
constexpr float PL_MISSING = -2.f;  // ops/knn.py NEG: below any score

__global__ void __launch_bounds__(K1_WARPS * 32) panel_kernel(
    const float* __restrict__ mz_rows, const float* __restrict__ int_rows,
    const float* __restrict__ mz_cols, const float* __restrict__ int_cols,
    int n_cols, long long row_offset, float tol, int rounds, int upper_only,
    float* __restrict__ scores, int* __restrict__ matches) {
  __shared__ WarpScratch scratch[K1_WARPS];
  const int i = blockIdx.y;
  const long long gi = row_offset + i;
  const int j0 = blockIdx.x * K1_COLS;
  const int j_end = min(j0 + K1_COLS, n_cols);
  if (upper_only && (long long)(j_end - 1) <= gi) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* mz_i = mz_rows + (size_t)i * P;
  const float* int_i = int_rows + (size_t)i * P;
  for (int j = j0 + warp; j < j_end; j += K1_WARPS) {
    if (upper_only && (long long)j <= gi) continue;
    float score;
    int n_match;
    match_pair(mz_i, int_i, mz_cols + (size_t)j * P,
               int_cols + (size_t)j * P, tol, rounds, scratch[warp], score,
               n_match);
    if (lane == 0) {
      const size_t o = (size_t)i * n_cols + j;
      scores[o] = score;
      if (matches != nullptr) matches[o] = n_match;
    }
  }
}

// First condensed index of row i in an m x m upper triangle.
__device__ __forceinline__ long long row_start(long long i, long long m) {
  return i * m - i * (i + 1) / 2;
}

__global__ void __launch_bounds__(K4_WARPS * 32) grouped_kernel(
    const float* __restrict__ mz, const float* __restrict__ intensity,
    const long long* __restrict__ starts,
    const long long* __restrict__ pair_starts, int n_groups,
    long long n_pairs, float tol, int rounds, float* __restrict__ scores,
    int* __restrict__ matches) {
  __shared__ WarpScratch scratch[K4_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * K4_WARPS;
  for (long long t = (long long)blockIdx.x * K4_WARPS + warp; t < n_pairs;
       t += stride) {
    // Last interval whose first pair is <= t (empty intervals share
    // their successor's start, so this lands on a non-empty one).
    int lo = 0, hi = n_groups - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pair_starts[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    const long long k = t - pair_starts[lo];
    const long long base = starts[lo];
    const long long m = starts[lo + 1] - base;
    const double mm = (double)m - 0.5;
    long long i = (long long)(mm - sqrt(fmax(mm * mm - 2.0 * (double)k, 0.0)));
    if (i < 0) i = 0;
    if (i > m - 2) i = m - 2;
    while (i > 0 && row_start(i, m) > k) --i;
    while (row_start(i + 1, m) <= k) ++i;
    const long long j = k - row_start(i, m) + i + 1;
    float score;
    int n_match;
    match_pair(mz + (base + i) * P, intensity + (base + i) * P,
               mz + (base + j) * P, intensity + (base + j) * P, tol, rounds,
               scratch[warp], score, n_match);
    if (lane == 0) {
      scores[t] = score;
      if (matches != nullptr) matches[t] = n_match;
    }
  }
}

__global__ void __launch_bounds__(PL_WARPS * 32) pair_list_kernel(
    const float* __restrict__ mz_q, const float* __restrict__ int_q,
    const float* __restrict__ mz_pool, const float* __restrict__ int_pool,
    const long long* __restrict__ ids, long long n_entries, int k,
    float tol, int rounds, float* __restrict__ scores,
    int* __restrict__ matches) {
  __shared__ WarpScratch scratch[PL_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * PL_WARPS;
  for (long long t = (long long)blockIdx.x * PL_WARPS + warp; t < n_entries;
       t += stride) {
    const long long id = ids[t];  // the same for every lane of the warp
    float score = PL_MISSING;
    int n_match = 0;
    if (id >= 0) {
      const long long q = t / k;
      match_pair(mz_q + q * P, int_q + q * P, mz_pool + id * P,
                 int_pool + id * P, tol, rounds, scratch[warp], score,
                 n_match);
    }
    if (lane == 0) {
      scores[t] = score;
      if (matches != nullptr) matches[t] = n_match;
    }
  }
}

}  // namespace falcon

extern "C" {

// K1.  Rows (n_rows, 64) and columns (n_cols, 64) f32, row-major.  Writes
// scores (and matches, if not null) (n_rows, n_cols); with upper_only only
// the pairs j > row_offset + i, leaving the rest as the caller set them.
int falcon_panel_scores(const float* mz_rows, const float* int_rows,
                        int n_rows, const float* mz_cols,
                        const float* int_cols, int n_cols,
                        long long row_offset, float tol, int rounds,
                        int upper_only, float* scores, int* matches,
                        void* stream) {
  if (n_rows > 0 && n_cols > 0) {
    const dim3 grid((n_cols + falcon::K1_COLS - 1) / falcon::K1_COLS,
                    n_rows);
    falcon::panel_kernel<<<grid, falcon::K1_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
        mz_rows, int_rows, mz_cols, int_cols, n_cols, row_offset, tol,
        rounds, upper_only, scores, matches);
  }
  return (int)cudaGetLastError();
}

// K4.  Spectra (n, 64) f32 with interval g = rows starts[g]..starts[g+1];
// pair_starts[g] = first condensed pair of interval g, pair_starts[n_groups]
// = n_pairs.  Writes scores (and matches, if not null) (n_pairs,).
int falcon_grouped_scores(const float* mz, const float* intensity,
                          const long long* starts,
                          const long long* pair_starts, int n_groups,
                          long long n_pairs, float tol, int rounds,
                          float* scores, int* matches, void* stream) {
  if (n_pairs > 0) {
    long long blocks = (n_pairs + falcon::K4_WARPS - 1) / falcon::K4_WARPS;
    if (blocks > falcon::K4_MAX_BLOCKS) blocks = falcon::K4_MAX_BLOCKS;
    falcon::grouped_kernel<<<(unsigned)blocks, falcon::K4_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(
        mz, intensity, starts, pair_starts, n_groups, n_pairs, tol, rounds,
        scores, matches);
  }
  return (int)cudaGetLastError();
}

// Pair lists.  Queries (n_q, 64) and pool (n_pool, 64) f32; ids (n_q, k)
// int64 pool rows, -1 = none, n_entries = n_q * k; every id < n_pool.
// Writes scores (and matches, if not null) (n_q, k): PL_MISSING and 0 for
// id -1.
int falcon_pair_list_scores(const float* mz_q, const float* int_q,
                            const float* mz_pool, const float* int_pool,
                            const long long* ids, long long n_entries,
                            int k, float tol, int rounds, float* scores,
                            int* matches, void* stream) {
  if (n_entries > 0) {
    long long blocks =
        (n_entries + falcon::PL_WARPS - 1) / falcon::PL_WARPS;
    if (blocks > falcon::PL_MAX_BLOCKS) blocks = falcon::PL_MAX_BLOCKS;
    falcon::pair_list_kernel<<<(unsigned)blocks, falcon::PL_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        mz_q, int_q, mz_pool, int_pool, ids, n_entries, k, tol, rounds,
        scores, matches);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
