// K2, falcon_banded_scores: the banded launcher of the pair-matching
// routine (matching.cuh), with a plain C interface for ctypes
// (falcon_tpu_torch/ops/_build.py).  It launches on the given stream, does
// not synchronise, allocates nothing and returns cudaGetLastError() of its
// launch.
//
// Replaces the Pallas kernel falcon_tpu/ops/exact_knn.py::
// _banded_panel_pallas: the K1 body with 128-column tiles, where row i
// reads the column tiles starts[i] + j through a scalar-prefetched index
// map.  Here a block finds its own columns: row i of the block is scored
// against pool spectra starts[i] * 128 + pass_offset + c, c < window.
//
// Bound: as K1, the compares and maxima of matching.cuh on the 64 x 64
// tile, not bytes (a pair reads 1 KB and writes 8 bytes).  Design: K1's
// grid, one row spectrum and K2_COLS consecutive window columns per block,
// each of its warps scoring one pair at a time; consecutive columns of one
// row share the row's spectrum in L1 and their own in L2, since the
// windows of neighbouring rows overlap.  The score is summed in K1's fixed
// order, so K2 and its plain version agree bit for bit.

#include <cuda_runtime.h>

#include "matching.cuh"

namespace falcon {

constexpr int K2_WARPS = 2;   // 2 x 17 KB of shared memory per block
constexpr int K2_COLS = 32;   // window columns per block
constexpr int COL_TILE = 128; // columns per start tile

__global__ void __launch_bounds__(K2_WARPS * 32) banded_kernel(
    const float* __restrict__ mz_rows, const float* __restrict__ int_rows,
    const float* __restrict__ mz_pool, const float* __restrict__ int_pool,
    const int* __restrict__ starts, long long pass_offset, int window,
    float tol, int rounds, float* __restrict__ scores,
    int* __restrict__ matches) {
  __shared__ WarpScratch scratch[K2_WARPS];
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * K2_COLS;
  const int j_end = min(j0 + K2_COLS, window);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long col0 = (long long)starts[i] * COL_TILE + pass_offset;
  const float* mz_i = mz_rows + (size_t)i * P;
  const float* int_i = int_rows + (size_t)i * P;
  for (int j = j0 + warp; j < j_end; j += K2_WARPS) {
    const size_t c = (size_t)(col0 + j) * P;
    float score;
    int n_match;
    match_pair(mz_i, int_i, mz_pool + c, int_pool + c, tol, rounds,
               scratch[warp], score, n_match);
    if (lane == 0) {
      const size_t o = (size_t)i * window + j;
      scores[o] = score;
      if (matches != nullptr) matches[o] = n_match;
    }
  }
}

}  // namespace falcon

extern "C" {

// K2.  Rows (n_rows, 64) and pool (n_pool, 64) f32, row-major; starts
// (n_rows,) int32 in 128-column tiles.  The caller guarantees every
// starts[i] * 128 + pass_offset + window <= n_pool.  Writes scores (and
// matches, if not null) (n_rows, window), every entry.
int falcon_banded_scores(const float* mz_rows, const float* int_rows,
                         int n_rows, const float* mz_pool,
                         const float* int_pool, const int* starts,
                         long long pass_offset, int window, float tol,
                         int rounds, float* scores, int* matches,
                         void* stream) {
  if (n_rows > 0 && window > 0) {
    const dim3 grid((window + falcon::K2_COLS - 1) / falcon::K2_COLS,
                    n_rows);
    falcon::banded_kernel<<<grid, falcon::K2_WARPS * 32, 0,
                            (cudaStream_t)stream>>>(
        mz_rows, int_rows, mz_pool, int_pool, starts, pass_offset, window,
        tol, rounds, scores, matches);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
