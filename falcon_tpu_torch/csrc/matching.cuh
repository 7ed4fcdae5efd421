// Locally-dominant peak matching of one spectrum pair, by one warp.
//
// The device routines shared by the launchers in pairwise.cu and
// exact_knn.cu.  Both compute what falcon_tpu/ops/matching.py
// (match_rounds_body, pair_weights, match_score) computes, and what the
// Pallas kernel falcon_tpu/ops/pairwise.py::_pair_panel_kernel runs for
// every pair:
//
//   w[p][q] = int_a[p] * int_b[q]  if |mz_a[p] - mz_b[q]| <= tol  else 0
//
// then up to `rounds` rounds, stopping once every weight is 0.  A round
// selects each entry that equals its row maximum and its column maximum
// and is > 0, keeping the lowest column in each row and then the lowest row
// in each column; selected weights are added to the score and their rows
// and columns removed.  The score is clipped to [0, 1] once, at the end.
//
// The score is summed in the order XLA's CPU backend gives the JAX
// package's match_score, which the plain version (ops/matching.py::
// match_score) spells out: each round's selection is cut into four 32 x 32
// blocks (stored row position p / 32, column q / 32), each block is summed
// from 0 in ascending row position, the round adds (B00 + B01) + (B10 +
// B11) to the score, and the score is clipped once, at the end.  No
// atomics take part in it, so two runs give the same bits.
//
// The routines work on the edges only: the (row, column) peak pairs within
// tolerance whose weight is > 0.  With peaks spread over ~1,400 m/z and a
// tolerance of 0.05, two spectra share a few edges, not 4,096 weights, so
// no routine builds the 64 x 64 weight tile.  The row spectrum is sorted by
// m/z once (sort_row) and shared by every pair it takes part in; a lane
// owns columns `lane` and `lane + 32` and finds each one's edges as a
// contiguous run of the sorted row (find_runs); the rounds then walk those
// runs (match_runs).  What bounds it is one binary search per column peak
// and the per-edge work of the rounds.
//
// match_sorted (K1, K2) runs both steps for every pair.  match_sparse (K4,
// the pair lists) skips the rounds of a pair whose runs are all empty:
// nearly every pair of a precursor interval has no edge at all.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace falcon {

constexpr int P = 64;          // padded peaks per spectrum
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool bit(uint64_t mask, int i) {
  return (mask >> i) & 1ull;
}

// One row spectrum sorted by m/z: shared by every warp of a block (K1, K2,
// the pair lists) or copied from the sort pre-pass for one warp (K4).
struct SortedRow {
  float key[P];    // unsorted sort keys (sort_row's scratch)
  float mz[P];     // the keys in ascending order
  float inten[P];  // the intensity of each sorted peak
  int idx[P];      // its index in the row spectrum
};

// Per-warp state of the rounds.
struct EdgeScratch {
  unsigned rowmax[P];  // per row: its maximum this round, as float bits
  int rowsel[P];       // per row: the lowest column it chose, P if none
  float hitw[P];       // per matched row: the weight selected this round
};

// A lane's two column peaks (lane, lane + 32): their intensities and their
// runs [lo, hi) of the sorted row.
struct Runs {
  float ib[2];
  int lo[2], hi[2];
};

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= FLT_MAX;  // false for inf and NaN
}

// Sorts the row spectrum (P m/z and intensities in device memory) into
// `row`; the whole block must call it, and it ends in __syncthreads().  A
// rank sort: each of P threads counts the keys below its own (ties by
// index), which makes the ranks a permutation.  A peak whose m/z is not
// finite is within tolerance of nothing (|m - c| <= tol is false for it), so
// it gets key -inf and intensity 0: it sorts first and never makes an edge.
__device__ __forceinline__ void sort_row(const float* __restrict__ mz,
                                         const float* __restrict__ inten,
                                         SortedRow& row) {
  for (int a = threadIdx.x; a < P; a += blockDim.x) {
    const float m = mz[a];
    row.key[a] = is_finite(m) ? m : -INFINITY;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < P; a += blockDim.x) {
    const float m = row.key[a];
    int r = 0;
    for (int b = 0; b < P; ++b) {
      const float mb = row.key[b];
      r += (mb < m) || (mb == m && b < a);
    }
    row.mz[r] = m;
    row.inten[r] = is_finite(mz[a]) ? inten[a] : 0.f;
    row.idx[r] = a;
  }
  __syncthreads();
}

// The runs of the calling lane's column peaks of spectrum b (P m/z and P
// intensities, in global or shared memory) in the sorted row.
//
// For a column peak c, d = fl(m - c) is monotone in m, so the row peaks
// with |m - c| <= tol (the predicate of pair_weights, bit for bit) are a
// contiguous run of the sorted row: lo = the count of peaks with d < -tol,
// by binary search, then every following peak until d > tol.  Both tests
// are that predicate's halves, so run edges agree with the plain version
// exactly.  A column peak with intensity 0 (padding) or a non-finite m/z
// has an empty run.
__device__ __forceinline__ Runs find_runs(const SortedRow& row,
                                          const float* __restrict__ mz_b,
                                          const float* __restrict__ int_b,
                                          float tol) {
  const int lane = threadIdx.x & 31;
  Runs e;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float c = mz_b[lane + 32 * k];
    e.ib[k] = int_b[lane + 32 * k];
    int l = 0, h = 0;
    if (e.ib[k] != 0.f && is_finite(c) && tol == tol) {  // NaN tol: none
#pragma unroll
      for (int step = P; step > 0; step >>= 1) {
        if (l + step <= P && row.mz[l + step - 1] - c < -tol) l += step;
      }
      h = l;
      while (h < P && !(row.mz[h] - c > tol)) ++h;
    }
    e.lo[k] = l;
    e.hi[k] = h;
  }
  return e;
}

// Up to `rounds` matching rounds on the edges of the runs `e`, with the
// calling warp; every lane must call it.  The result is valid in every lane.
//
// An edge's weight is the same f32 product x * ib as pair_weights',
// recomputed where it is needed; only w > 0 is an edge (a weight <= 0 is
// never selected and never raises a maximum above 0).  A round walks each
// lane's runs three times:
//   1. column maxima (lane-local) and row maxima (atomicMax on the float
//      bits: weights are > 0, so integer order is float order and the
//      result does not depend on the order of the atomics);
//   2. each row keeps the lowest column whose edge equals both maxima
//      (atomicMin), as _first_true along the row;
//   3. each column takes the lowest row that chose it (lane-local), as
//      _first_true along the column.  Every row that chose a column holds
//      the column's maximum, so the selected weight is that maximum.
// A round matches each row and each column at most once, so a matched row
// leaves its weight in its own slot of s.hitw, and the round's hits are
// four warp-wide bit masks, one per 32 x 32 block (row half, column half =
// the lane's k).  Every lane then walks each mask's bits in ascending row
// position and adds the slots from 0: the block sums of XLA's order.
__device__ __forceinline__ void match_runs(const SortedRow& row,
                                           const Runs& e, int rounds,
                                           EdgeScratch& s, float& score_out,
                                           int& matches_out) {
  const int lane = threadIdx.x & 31;
  float score = 0.f;
  int nmatch = 0;
  uint64_t alive_r = ~0ull, alive_c = ~0ull;
  for (int round = 0; round < rounds; ++round) {
    __syncwarp();  // the warp's previous round or pair is done with s
    s.rowmax[lane] = 0u;
    s.rowmax[lane + 32] = 0u;
    s.rowsel[lane] = P;
    s.rowsel[lane + 32] = P;
    __syncwarp();

    float cm[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float c = 0.f;
      if (bit(alive_c, lane + 32 * k)) {
        for (int t = e.lo[k]; t < e.hi[k]; ++t) {
          const int p = row.idx[t];
          const float w = row.inten[t] * e.ib[k];
          if (w > 0.f && bit(alive_r, p)) {
            c = fmaxf(c, w);
            atomicMax(&s.rowmax[p], __float_as_uint(w));
          }
        }
      }
      cm[k] = c;
    }
    if (!__any_sync(FULL, cm[0] > 0.f || cm[1] > 0.f)) break;
    __syncwarp();

#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (cm[k] > 0.f) {
        const unsigned cb = __float_as_uint(cm[k]);
        for (int t = e.lo[k]; t < e.hi[k]; ++t) {
          const int p = row.idx[t];
          const unsigned wb = __float_as_uint(row.inten[t] * e.ib[k]);
          if (wb == cb && bit(alive_r, p) && wb == s.rowmax[p]) {
            atomicMin(&s.rowsel[p], lane + 32 * k);
          }
        }
      }
    }
    __syncwarp();

    unsigned hits[2][2] = {{0u, 0u}, {0u, 0u}};  // [row half][column half]
    bool hit[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int best = P;
      if (cm[k] > 0.f) {
        for (int t = e.lo[k]; t < e.hi[k]; ++t) {
          const int p = row.idx[t];
          if (s.rowsel[p] == lane + 32 * k) best = min(best, p);
        }
      }
      hit[k] = best < P;
      if (hit[k]) {
        s.hitw[best] = cm[k];
        ++nmatch;
        if (best < 32) hits[0][k] = 1u << best;
        else hits[1][k] = 1u << (best - 32);
      }
    }
    float block[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        hits[h][k] = __reduce_or_sync(FULL, hits[h][k]);
      }
    }
    __syncwarp();  // every hit's weight is in s.hitw
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float sum = 0.f;
        for (unsigned m = hits[h][k]; m; m &= m - 1) {
          sum = __fadd_rn(sum, s.hitw[32 * h + __ffs(m) - 1]);
        }
        block[h][k] = sum;
      }
    }
    score = __fadd_rn(score,
                      __fadd_rn(__fadd_rn(block[0][0], block[0][1]),
                                __fadd_rn(block[1][0], block[1][1])));
    const unsigned cols_lo = __ballot_sync(FULL, hit[0]);
    const unsigned cols_hi = __ballot_sync(FULL, hit[1]);
    const unsigned rows_lo = hits[0][0] | hits[0][1];
    const unsigned rows_hi = hits[1][0] | hits[1][1];
    alive_r &= ~((uint64_t(rows_hi) << 32) | rows_lo);
    alive_c &= ~((uint64_t(cols_hi) << 32) | cols_lo);
  }
  score_out = fminf(fmaxf(score, 0.f), 1.f);
  matches_out = __reduce_add_sync(FULL, nmatch);
}

// Scores the sorted row against spectrum b with the calling warp: the runs,
// then the rounds.  Every lane must call it; the result is valid in every
// lane.
__device__ __forceinline__ void match_sorted(
    const SortedRow& row, const float* __restrict__ mz_b,
    const float* __restrict__ int_b, float tol, int rounds, EdgeScratch& s,
    float& score_out, int& matches_out) {
  const Runs e = find_runs(row, mz_b, int_b, tol);
  match_runs(row, e, rounds, s, score_out, matches_out);
}

// As match_sorted, but a pair whose runs are all empty scores 0 with 0
// matches after one vote, as the rounds would give it: their first round
// finds no weight > 0 and stops.
__device__ __forceinline__ void match_sparse(
    const SortedRow& row, const float* __restrict__ mz_b,
    const float* __restrict__ int_b, float tol, int rounds, EdgeScratch& s,
    float& score_out, int& matches_out) {
  const Runs e = find_runs(row, mz_b, int_b, tol);
  if (!__any_sync(FULL, e.hi[0] > e.lo[0] || e.hi[1] > e.lo[1])) {
    score_out = 0.f;
    matches_out = 0;
    return;
  }
  match_runs(row, e, rounds, s, score_out, matches_out);
}

}  // namespace falcon
