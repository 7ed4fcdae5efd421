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
// Two routines, one result.  Both sum the score in a fixed order (per
// column, then a butterfly over the warp) with no atomics, so two runs give
// the same bits, and the plain version (ops/matching.py::match_score) adds
// in that order too.
//
// match_sorted (K1 and K2) works on the edges only: the (row, column) peak
// pairs within tolerance whose weight is > 0.  With peaks spread over
// ~1,400 m/z and a tolerance of 0.05, two spectra share a few edges, not
// 4,096 tile entries, so it never builds the tile.  The block sorts its one
// row spectrum by m/z once (sort_row); a lane owns columns `lane` and
// `lane + 32` and finds each one's edges as a contiguous run of the sorted
// row.  What bounds it then is the per-edge work of the rounds and one
// binary search per column peak, not the tile.
//
// match_pair (K4 and the pair lists, not yet reworked) builds the 64 x 64
// weight tile in shared memory and scans it.

#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace falcon {

constexpr int P = 64;          // padded peaks per spectrum
constexpr int LDW = P + 1;     // row stride of the weight tile
constexpr unsigned FULL = 0xffffffffu;

struct WarpScratch {
  float w[P * LDW];  // the pair's weight tile, row p = peak p of spectrum a
  float cmax[P];     // column maxima of the current round
  int sel[P];        // per column: lowest row that chose it, P if none
};

__device__ __forceinline__ bool bit(uint64_t mask, int i) {
  return (mask >> i) & 1ull;
}

// The score of one pair from the selected weights (acc[k]: column
// lane + 32 k's), added per lane, then over the warp by a fixed
// butterfly, and clipped to [0, 1]; and the match count over the warp.
__device__ __forceinline__ void warp_total(const float (&acc)[2], int nmatch,
                                           float& score_out,
                                           int& matches_out) {
  float total = acc[0] + acc[1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(FULL, total, off);
  }
  score_out = fminf(fmaxf(total, 0.f), 1.f);
  matches_out = __reduce_add_sync(FULL, nmatch);
}

// Scores spectra a and b (P m/z and P intensities each, in device memory)
// with the calling warp; every lane must call it.  The result is valid in
// every lane.
//
// Bound by compares and maxima over the 64 x 64 tile, in shared memory, per
// pair.  The f32 tile has a padded row stride (P + 1) so that both the row
// walk (a lane per row) and the column walk (a lane per column) are free of
// bank conflicts; each lane owns rows and columns `lane` and `lane + 32`;
// removed rows and columns are kept as two 64-bit masks instead of being
// zeroed; column maxima of the first round come for free while the tile is
// built.
__device__ __forceinline__ void match_pair(
    const float* __restrict__ mz_a, const float* __restrict__ int_a,
    const float* __restrict__ mz_b, const float* __restrict__ int_b,
    float tol, int rounds, WarpScratch& s, float& score_out,
    int& matches_out) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's previous pair is done reading the tile

  float mza[2], ia[2], mzb[2], ib[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    mza[k] = mz_a[lane + 32 * k];
    ia[k] = int_a[lane + 32 * k];
    mzb[k] = mz_b[lane + 32 * k];
    ib[k] = int_b[lane + 32 * k];
  }

  // Build the tile by columns; keep the first round's column maxima.
  float cm[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int p = 32 * h + r;
      const float m = __shfl_sync(FULL, mza[h], r);
      const float x = __shfl_sync(FULL, ia[h], r);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float v = (fabsf(m - mzb[k]) <= tol) ? x * ib[k] : 0.f;
        s.w[p * LDW + lane + 32 * k] = v;
        cm[k] = fmaxf(cm[k], v);
      }
    }
  }

  float acc[2] = {0.f, 0.f};
  int nmatch = 0;
  uint64_t alive_r = ~0ull, alive_c = ~0ull;
  for (int round = 0; round < rounds; ++round) {
    if (round > 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = lane + 32 * k;
        float c = 0.f;
        if (bit(alive_c, q)) {
          for (int p = 0; p < P; ++p) {
            if (bit(alive_r, p)) c = fmaxf(c, s.w[p * LDW + q]);
          }
        }
        cm[k] = c;
      }
    }
    if (!__any_sync(FULL, cm[0] > 0.f || cm[1] > 0.f)) break;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s.cmax[lane + 32 * k] = cm[k];
      s.sel[lane + 32 * k] = P;
    }
    __syncwarp();

    // Rows: the first column that is the row maximum and its column's.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = lane + 32 * k;
      if (!bit(alive_r, p)) continue;
      float m = 0.f;
      int idx = -1;
      for (int q = 0; q < P; ++q) {
        const float v = bit(alive_c, q) ? s.w[p * LDW + q] : 0.f;
        if (v > m) {
          m = v;
          idx = (v == s.cmax[q]) ? q : -1;
        } else if (v == m && idx < 0 && v == s.cmax[q]) {
          idx = q;
        }
      }
      if (m > 0.f && idx >= 0) atomicMin(&s.sel[idx], p);
    }
    __syncwarp();

    // Columns: the lowest row that chose the column wins it.
    unsigned rows_lo = 0u, rows_hi = 0u;
    bool hit[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = s.sel[lane + 32 * k];
      hit[k] = p < P;
      if (hit[k]) {
        acc[k] += s.w[p * LDW + lane + 32 * k];
        ++nmatch;
        if (p < 32) rows_lo |= 1u << p;
        else rows_hi |= 1u << (p - 32);
      }
    }
    rows_lo = __reduce_or_sync(FULL, rows_lo);
    rows_hi = __reduce_or_sync(FULL, rows_hi);
    const unsigned cols_lo = __ballot_sync(FULL, hit[0]);
    const unsigned cols_hi = __ballot_sync(FULL, hit[1]);
    alive_r &= ~((uint64_t(rows_hi) << 32) | rows_lo);
    alive_c &= ~((uint64_t(cols_hi) << 32) | cols_lo);
    __syncwarp();
  }

  warp_total(acc, nmatch, score_out, matches_out);
}

// One row spectrum sorted by m/z, shared by every warp of a block.
struct SortedRow {
  float key[P];    // unsorted sort keys (sort_row's scratch)
  float mz[P];     // the keys in ascending order
  float inten[P];  // the intensity of each sorted peak
  int idx[P];      // its index in the row spectrum
};

// Per-warp state of match_sorted's rounds.
struct EdgeScratch {
  unsigned rowmax[P];  // per row: its maximum this round, as float bits
  int rowsel[P];       // per row: the lowest column it chose, P if none
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

// Scores the sorted row against spectrum b (P m/z and P intensities in
// device memory) with the calling warp; every lane must call it.  The
// result is valid in every lane.
//
// Edges.  For a column peak c, d = fl(m - c) is monotone in m, so the row
// peaks with |m - c| <= tol (the predicate of pair_weights, bit for bit)
// are a contiguous run of the sorted row: lo = the count of peaks with
// d < -tol, by binary search, then every following peak until d > tol.
// Both tests are that predicate's halves, so run edges agree with the
// plain version exactly.  An edge's weight is the same f32 product x * ib,
// recomputed where it is needed; only w > 0 is an edge (a weight <= 0 is
// never selected and never raises a maximum above 0).  A column peak with
// intensity 0 (padding) or a non-finite m/z has none.
//
// A round on the edges, in three passes over each lane's runs:
//   1. column maxima (lane-local) and row maxima (atomicMax on the float
//      bits: weights are > 0, so integer order is float order and the
//      result does not depend on the order of the atomics);
//   2. each row keeps the lowest column whose edge equals both maxima
//      (atomicMin), as _first_true along the row;
//   3. each column takes the lowest row that chose it (lane-local), as
//      _first_true along the column.  Every row that chose a column holds
//      the column's maximum, so the selected weight is that maximum.
__device__ __forceinline__ void match_sorted(
    const SortedRow& row, const float* __restrict__ mz_b,
    const float* __restrict__ int_b, float tol, int rounds, EdgeScratch& s,
    float& score_out, int& matches_out) {
  const int lane = threadIdx.x & 31;
  float ib[2];
  int lo[2], hi[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float c = mz_b[lane + 32 * k];
    ib[k] = int_b[lane + 32 * k];
    int l = 0, h = 0;
    if (ib[k] != 0.f && is_finite(c) && tol == tol) {  // NaN tol: none
#pragma unroll
      for (int step = P; step > 0; step >>= 1) {
        if (l + step <= P && row.mz[l + step - 1] - c < -tol) l += step;
      }
      h = l;
      while (h < P && !(row.mz[h] - c > tol)) ++h;
    }
    lo[k] = l;
    hi[k] = h;
  }

  float acc[2] = {0.f, 0.f};
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
        for (int t = lo[k]; t < hi[k]; ++t) {
          const int p = row.idx[t];
          const float w = row.inten[t] * ib[k];
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
        for (int t = lo[k]; t < hi[k]; ++t) {
          const int p = row.idx[t];
          const unsigned wb = __float_as_uint(row.inten[t] * ib[k]);
          if (wb == cb && bit(alive_r, p) && wb == s.rowmax[p]) {
            atomicMin(&s.rowsel[p], lane + 32 * k);
          }
        }
      }
    }
    __syncwarp();

    unsigned rows_lo = 0u, rows_hi = 0u;
    bool hit[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int best = P;
      if (cm[k] > 0.f) {
        for (int t = lo[k]; t < hi[k]; ++t) {
          const int p = row.idx[t];
          if (s.rowsel[p] == lane + 32 * k) best = min(best, p);
        }
      }
      hit[k] = best < P;
      if (hit[k]) {
        acc[k] += cm[k];
        ++nmatch;
        if (best < 32) rows_lo |= 1u << best;
        else rows_hi |= 1u << (best - 32);
      }
    }
    rows_lo = __reduce_or_sync(FULL, rows_lo);
    rows_hi = __reduce_or_sync(FULL, rows_hi);
    const unsigned cols_lo = __ballot_sync(FULL, hit[0]);
    const unsigned cols_hi = __ballot_sync(FULL, hit[1]);
    alive_r &= ~((uint64_t(rows_hi) << 32) | rows_lo);
    alive_c &= ~((uint64_t(cols_hi) << 32) | cols_lo);
  }
  warp_total(acc, nmatch, score_out, matches_out);
}

}  // namespace falcon
