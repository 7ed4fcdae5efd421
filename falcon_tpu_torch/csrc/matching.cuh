// Locally-dominant peak matching of one spectrum pair, by one warp.
//
// The device routine shared by the launchers in pairwise.cu.  It computes
// what falcon_tpu/ops/matching.py (match_rounds_body, pair_weights,
// match_score) computes, and what the Pallas kernel
// falcon_tpu/ops/pairwise.py::_pair_panel_kernel runs for every pair:
//
//   w[p][q] = int_a[p] * int_b[q]  if |mz_a[p] - mz_b[q]| <= tol  else 0
//
// then up to `rounds` rounds, stopping once every weight is 0.  A round
// selects each entry that equals its row maximum and its column maximum
// and is > 0, keeping the lowest column in each row and then the lowest row
// in each column; selected weights are added to the score and their rows
// and columns removed.  The score is clipped to [0, 1] once, at the end.
//
// What bounds it on an H100: compares and maxima over the 64 x 64 tile, in
// shared memory, per pair; a pair reads only 1 KB of spectra from device
// memory.  The simple design: one warp per pair, the f32 tile in shared
// memory with a padded row stride (P + 1) so that both the row walk (a
// lane per row) and the column walk (a lane per column) are free of bank
// conflicts; each lane owns rows and columns `lane` and `lane + 32`; removed
// rows and columns are kept as two 64-bit masks instead of being zeroed;
// column maxima of the first round come for free while the tile is built,
// so a pair with no peak within tolerance (most pairs of unrelated
// spectra) costs only the build.  The score is summed in a fixed order
// (per column, then a butterfly over the warp) with no atomics, so two
// runs give the same bits.

#pragma once

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

// Scores spectra a and b (P m/z and P intensities each, in device memory)
// with the calling warp; every lane must call it.  The result is valid in
// every lane.
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

  float total = acc[0] + acc[1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(FULL, total, off);
  }
  score_out = fminf(fmaxf(total, 0.f), 1.f);
  matches_out = __reduce_add_sync(FULL, nmatch);
}

}  // namespace falcon
