// Three launchers of the pair-matching routines (matching.cuh), with a
// plain C interface for ctypes (falcon_tpu_torch/ops/_build.py).  Each
// function launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of its launch.
//
// K1, falcon_panel_scores, replaces the Pallas kernel
// falcon_tpu/ops/pairwise.py::_pair_panel_kernel (launched by
// panel_scores_pallas): the score of every (row, column) spectrum pair of a
// panel, or with upper_only only of the pairs above the global diagonal.
// It is bound by operations, not bytes: a pair reads 512 bytes of its
// column (the row is shared by the block) and writes 8, against a binary
// search per column peak and the rounds' work per edge (matching.cuh,
// match_sorted).  Design: a block takes one row spectrum, sorts it once
// (sort_row), and scores it against K1_COLS consecutive columns, 32 per
// warp, one pair at a time; lane t keeps the score of the warp's t-th
// column, so the warp writes its 32 scores with one coalesced store.
// Blocks wholly at or below the diagonal return at once.
//
// K4, falcon_grouped_scores, replaces falcon_tpu/ops/pairwise.py::
// batched_block_scores (XLA, no Pallas): every upper-triangle pair of many
// small intervals in one launch.  Intervals are ragged (spectrum offsets)
// instead of padded to a common size, and the output is their condensed
// distance order, interval after interval.  Same bound as K1.  Design: a
// pre-pass (sort_kernel) sorts every spectrum of the launch by m/z once,
// into a scratch buffer the caller allocates; then a warp takes one work
// item, (row i, up to 32 consecutive columns j > i of its interval).  Items
// are numbered in the condensed order, and a warp finds its own from the
// first item of each interval (ops/pairwise.py::_grouped_layout) and a
// closed form of the items per row (tail_items), so no work list is built
// or read.  The warp copies the row's sorted peaks into shared memory,
// scores the columns one pair at a time (match_sparse: a pair with no edge
// costs one search and one vote), and writes the item's scores, which are
// contiguous in the condensed order, with one coalesced store.
//
// falcon_pair_list_scores replaces the exact scoring inside
// falcon_tpu/ops/rerank.py::rerank_scan_body (XLA, no Pallas), as the
// pruned linkage calls it (falcon_tpu/ops/pairwise.py::_rerank_pool): each
// query row against its own list of K pool ids, -1 = none.  Same bound as
// K1.  Design: a block takes one query row and sorts it once; each warp
// takes chunks of 32 slots, lane t holding slot t of the chunk, and walks
// only the valid ones (match_sparse).  The lists of the pruned linkage have
// many edges per pair (tens), so the rounds are the cost: while a pair's
// rounds run, cp.async brings the next valid candidate's 512 bytes into
// shared memory.  A chunk's scores stay in the warp until its coalesced
// store, so a top-k (the later rerank, K3) can be added as an epilogue that
// reads no score back from device memory.

#include <cuda_runtime.h>

#include "matching.cuh"

namespace falcon {

constexpr int K1_WARPS = 4;
constexpr int K1_COLS = 32 * K1_WARPS;  // columns per block, 32 per warp
constexpr int K4_WARPS = 4;
constexpr int PL_WARPS = 2;
constexpr float PL_MISSING = -2.f;  // ops/knn.py NEG: below any score

__global__ void __launch_bounds__(K1_WARPS * 32) panel_kernel(
    const float* __restrict__ mz_rows, const float* __restrict__ int_rows,
    const float* __restrict__ mz_cols, const float* __restrict__ int_cols,
    int n_cols, long long row_offset, float tol, int rounds, int upper_only,
    float* __restrict__ scores, int* __restrict__ matches) {
  __shared__ SortedRow row;
  __shared__ EdgeScratch scratch[K1_WARPS];
  const int i = blockIdx.y;
  const long long gi = row_offset + i;
  const int j0 = blockIdx.x * K1_COLS;
  const int j_end = min(j0 + K1_COLS, n_cols);
  if (upper_only && (long long)(j_end - 1) <= gi) return;
  sort_row(mz_rows + (size_t)i * P, int_rows + (size_t)i * P, row);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jw = j0 + 32 * warp;  // the warp's first column
  float my_score = 0.f;
  int my_match = 0;
  for (int t = 0; t < 32 && jw + t < j_end; ++t) {
    const int j = jw + t;
    if (upper_only && (long long)j <= gi) continue;
    float score;
    int n_match;
    match_sorted(row, mz_cols + (size_t)j * P, int_cols + (size_t)j * P,
                 tol, rounds, scratch[warp], score, n_match);
    if (lane == t) {
      my_score = score;
      my_match = n_match;
    }
  }
  const int j = jw + lane;
  if (j < j_end && !(upper_only && (long long)j <= gi)) {
    const size_t o = (size_t)i * n_cols + j;
    scores[o] = my_score;
    if (matches != nullptr) matches[o] = my_match;
  }
}

// A spectrum sorted by m/z, as sort_kernel leaves it in the scratch buffer
// (ops/pairwise.py::SORTED_BYTES per spectrum).
struct SortedPeaks {
  float mz[P];
  float inten[P];
  int idx[P];
};

// K4's pre-pass: block b sorts spectrum b (sort_row) into sorted[b].
__global__ void __launch_bounds__(P) sort_kernel(
    const float* __restrict__ mz, const float* __restrict__ intensity,
    SortedPeaks* __restrict__ sorted) {
  __shared__ SortedRow row;
  const size_t b = blockIdx.x;
  sort_row(mz + b * P, intensity + b * P, row);
  const int a = threadIdx.x;
  sorted[b].mz[a] = row.mz[a];
  sorted[b].inten[a] = row.inten[a];
  sorted[b].idx[a] = row.idx[a];
}

// Work items of the last k rows of an interval, row r of m having
// ceil((m - 1 - r) / 32) (one per 32 of its columns j > r): the sum of
// ceil(c / 32) over c < k.  ops/pairwise.py::_grouped_layout is the same sum.
// In int: an interval holds at most 65,536 spectra (the wrapper checks).
__device__ __forceinline__ int tail_items(int k) {
  if (k <= 1) return 0;
  const int a = (k - 1) >> 5, b = (k - 1) & 31;
  return 16 * a * (a + 1) + b * (a + 1);
}

// At most 40 registers a thread (12 blocks an SM): left to itself, nvcc
// gives the item search 56, and fewer warps hide less latency.
__global__ void __launch_bounds__(K4_WARPS * 32, 12) grouped_kernel(
    const float* __restrict__ mz, const float* __restrict__ intensity,
    const SortedPeaks* __restrict__ sorted,
    const long long* __restrict__ starts,
    const long long* __restrict__ item_starts,
    const long long* __restrict__ pair_starts, int n_groups,
    long long n_items, float tol, int rounds, float* __restrict__ scores,
    int* __restrict__ matches) {
  __shared__ SortedRow rows[K4_WARPS];
  __shared__ EdgeScratch scratch[K4_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * K4_WARPS + warp;
  if (t >= n_items) return;
  // The warp's item: its interval g (item_starts[g] <= t < item_starts[g +
  // 1]), then its row r, whose items follow those of rows 0..r-1, and its
  // chunk of 32 columns.  Every lane finds the same, by binary search.
  int g = 0, g_hi = n_groups;
  while (g_hi - g > 1) {
    const int mid = (g + g_hi) >> 1;
    if (item_starts[mid] <= t) g = mid; else g_hi = mid;
  }
  const int first = (int)starts[g], m = (int)starts[g + 1] - first;
  const int u = (int)(t - item_starts[g]), total = tail_items(m);
  int r = 0, r_hi = m - 1;  // items before row r: total - tail(m - r)
  while (r_hi - r > 1) {
    const int mid = (r + r_hi) >> 1;
    if (total - tail_items(m - mid) <= u) r = mid; else r_hi = mid;
  }
  const int chunk = u - (total - tail_items(m - r));
  const int i = first + r, j0 = i + 1 + 32 * chunk;
  const long long out = pair_starts[g] + (long long)r * (m - 1) -
                        (long long)r * (r - 1) / 2 + 32 * chunk;
  const int n_cols = min(j0 + 32, first + m) - j0;  // 1..32
  SortedRow& row = rows[warp];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int a = lane + 32 * k;
    row.mz[a] = sorted[i].mz[a];
    row.inten[a] = sorted[i].inten[a];
    row.idx[a] = sorted[i].idx[a];
  }
  __syncwarp();
  float my_score = 0.f;
  int my_match = 0;
  for (int c = 0; c < n_cols; ++c) {
    const size_t j = (size_t)(j0 + c) * P;
    float score;
    int n_match;
    match_sparse(row, mz + j, intensity + j, tol, rounds, scratch[warp],
                 score, n_match);
    if (lane == c) {
      my_score = score;
      my_match = n_match;
    }
  }
  if (lane < n_cols) {
    scores[out + lane] = my_score;
    if (matches != nullptr) matches[out + lane] = my_match;
  }
}

// A pool spectrum in shared memory, filled by cp.async.
struct __align__(16) Column {
  float mz[P];
  float inten[P];
};

// Starts copying pool spectrum `id` into `col` with the calling warp (16
// bytes a lane: lanes 0-15 the m/z, 16-31 the intensities) as one cp.async
// group.  The caller guarantees 16-byte aligned pool rows.
__device__ __forceinline__ void fetch_column(
    Column& col, const float* __restrict__ mz_pool,
    const float* __restrict__ int_pool, long long id) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane is done reading what `col` held
  const int h = lane >> 4, q = (lane & 15) * 4;
  const float* src = (h ? int_pool : mz_pool) + id * P + q;
  float* dst = (h ? col.inten : col.mz) + q;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_columns() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  __syncwarp();  // every lane's part has landed
}

__global__ void __launch_bounds__(PL_WARPS * 32) pair_list_kernel(
    const float* __restrict__ mz_q, const float* __restrict__ int_q,
    const float* __restrict__ mz_pool, const float* __restrict__ int_pool,
    const long long* __restrict__ ids, int k, float tol, int rounds,
    float* __restrict__ scores, int* __restrict__ matches) {
  __shared__ SortedRow row;
  __shared__ EdgeScratch scratch[PL_WARPS];
  __shared__ Column cols[PL_WARPS][2];
  const size_t q = blockIdx.x;
  sort_row(mz_q + q * P, int_q + q * P, row);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Column* buf = cols[warp];
  int cur = 0;  // the buffer that holds, or is to hold, the next candidate
  for (int c = warp; c * 32 < k; c += PL_WARPS) {
    const int slot = c * 32 + lane;
    const size_t o = q * (size_t)k + slot;
    const long long id = slot < k ? ids[o] : -1;
    unsigned todo = __ballot_sync(FULL, id >= 0);
    float my_score = PL_MISSING;
    int my_match = 0;
    bool ready = false;  // buf[cur] holds the next candidate already
    while (todo) {
      const int t = __ffs(todo) - 1;
      todo &= todo - 1;
      if (!ready) {
        fetch_column(buf[cur], mz_pool, int_pool, __shfl_sync(FULL, id, t));
      }
      if (todo) {
        fetch_column(buf[cur ^ 1], mz_pool, int_pool,
                     __shfl_sync(FULL, id, __ffs(todo) - 1));
        wait_columns<1>();
      } else {
        wait_columns<0>();
      }
      float score;
      int n_match;
      match_sparse(row, buf[cur].mz, buf[cur].inten, tol, rounds,
                   scratch[warp], score, n_match);
      if (lane == t) {
        my_score = score;
        my_match = n_match;
      }
      ready = todo != 0;
      if (ready) cur ^= 1;
    }
    if (slot < k) {
      scores[o] = my_score;
      if (matches != nullptr) matches[o] = my_match;
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

// K4.  Spectra (n, 64) f32, interval g being rows starts[g]..starts[g + 1]
// (int64, n_groups + 1 offsets from 0 to n, each interval at most 65,536
// spectra); sorted: scratch of
// n * sizeof(SortedPeaks) bytes; layout (2, n_groups + 1) int64: the first
// work item of each interval (tail_items of its size, summed), then its
// first condensed pair, each row ending in the total; n_items = layout[0]
// [n_groups].  Writes scores (and matches, if not null) of every condensed
// pair, interval after interval.
int falcon_grouped_scores(const float* mz, const float* intensity, int n,
                          void* sorted, const long long* starts,
                          const long long* layout, int n_groups,
                          long long n_items, float tol, int rounds,
                          float* scores, int* matches, void* stream) {
  if (n_items > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    auto* peaks = (falcon::SortedPeaks*)sorted;
    falcon::sort_kernel<<<n, falcon::P, 0, s>>>(mz, intensity, peaks);
    const long long blocks =
        (n_items + falcon::K4_WARPS - 1) / falcon::K4_WARPS;
    falcon::grouped_kernel<<<(unsigned)blocks, falcon::K4_WARPS * 32, 0,
                             s>>>(mz, intensity, peaks, starts, layout,
                                  layout + n_groups + 1, n_groups, n_items,
                                  tol, rounds, scores, matches);
  }
  return (int)cudaGetLastError();
}

// Pair lists.  Queries (n_q, 64) and pool (n_pool, 64) f32, the pool rows
// 16-byte aligned; ids (n_q, k) int64 pool rows, -1 = none; every id <
// n_pool.  Writes scores (and matches, if not null) (n_q, k): PL_MISSING
// and 0 for id -1.
int falcon_pair_list_scores(const float* mz_q, const float* int_q, int n_q,
                            const float* mz_pool, const float* int_pool,
                            const long long* ids, int k, float tol,
                            int rounds, float* scores, int* matches,
                            void* stream) {
  if (n_q > 0 && k > 0) {
    falcon::pair_list_kernel<<<n_q, falcon::PL_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        mz_q, int_q, mz_pool, int_pool, ids, k, tol, rounds, scores,
        matches);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
