// The IVF index's kernels, IVF.1 and IVF.2, with a plain C interface for
// ctypes (falcon_tpu_torch/ops/_build.py).  Each entry point launches on
// the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// IVF.1, falcon_ivf_probe_topk: the whole chunk step of the probe scan.
// Replaces falcon_tpu/ops/ivf.py::_chunk_scan's step (:550, :585-620): the
// block gather, the einsum, the mask and lax.top_k.  For each list l of the
// chunk [c0, c0 + chunk) and each of its query slots i < qlb, the pairs are
// (p, b), p < n_probe, b < lb, at position p * lb + b; the pair scores
// q[l, i] . c[s, b], s = probe_ids[l, p], unless _chunk_scan masks it:
// - the query slot is padding (its m/z is not finite);
// - the slab slot is padding (its m/z is not finite);
// - the pair is out of the precursor tolerance: |qm - sm| <= tol (Da) or
//   |(qm - sm) / sm * 1e6| <= tol (ppm), in float32 with an IEEE division,
//   as XLA computes it (tol = inf admits every real pair);
// - the two slots hold the same row (the self pair).
// Each row keeps its k best pairs, by descending score, ties to the lower
// position (lax.top_k's and torch.sort(stable=True)'s order), written as
// (chunk, qlb, k) scores and slots probe_ids[l, p] * lb + b; a row with
// fewer than k pairs in band ends in NEG = -2 and slot -1 (masked pairs
// score NEG, and in-band scores lie above it: cosines, and the dots of the
// non-negative hashed vectors).  JAX does not mask a padded query slot at
// tol = inf; those rows score zero vectors and are dropped by the caller.
//
// Bound: bytes.  The chunk's query slots and the probed slabs are read, the
// (chunk, qlb, k) lists written; on real corpora a precursor band holds a
// few hundred spectra of the thousands of probed slots (0.06% of the pairs
// at 20 ppm on the bench corpus), so no per-pair buffer is written and no
// sort runs over one.
//
// Design: two kernels and a memset, no host synchronisation.
// - ivf_probe_append_kernel, the mask: one block per (list, probe) pair; a
//   thread owns a slab slot b and walks the list's query slots, 32 at a
//   time (one coalesced read of their m/z and rows, then a shuffle each),
//   so the warp shares the query and its lanes hold consecutive slab
//   slots.  Each slot first takes a window of query m/z that holds every
//   pair the exact test accepts (widened by more than float32 rounding
//   moves either side), so the IEEE division runs only for the few pairs
//   near the band, and a tile of 32 queries whose m/z range misses the
//   warp's window is skipped whole (a self-search's slots are sorted by
//   m/z within a list, so most tiles are).  An in-band pair's position is
//   appended to its row's segment of n_probe * lb entries, a warp at a
//   time: one integer atomicAdd on the row's count, each lane at its rank
//   in the ballot.  Append order does not matter: every order below is
//   the key's, and the key holds the position, so no two keys tie.
// - ivf_rank_kernel, the dots and the order: eight rows a block, one warp
//   each.  The warp's lanes compute its row's dots, one pair a lane: the
//   operands widened to float32 (bf16 widening is exact), summed in
//   dimension order with __fmaf_rn, the plain version's order
//   (falcon_tpu_torch/ops/ivf.py::probe_scan_plain), so the two agree bit
//   for bit; no tensor cores (their sums have another order).  The dots
//   run here, spread over every row of the chunk, because the pairs of a
//   chunk crowd into few (list, probe) blocks, whose threads would take
//   them a few at a time: with the dots in its blocks the bench block's
//   mask kernel took 3.21 ms, without them 0.53 ms (NVIDIA H100 80GB
//   HBM3, chip_smoke.py phase 2).
// - The key: the score's bits made order-preserving (-0 folded into +0, as
//   torch.sort ties them) above the position's complement, so descending
//   keys are descending scores, ties to the lower position.
// - A row of at most WARP_CAP pairs is sorted in shared memory by its warp
//   (a bitonic network over the next power of two, padded with 0, below
//   every key) and its first k written.  A longer row takes the whole
//   block, after the warps: its keys are written over its positions; if it
//   has more than k, an MSB radix select (8 passes of 8 bits over a
//   256-bin histogram) finds its k-th key and the k keys at or above it
//   are compacted in place; they are then sorted in runs of RUN keys in
//   shared memory, and a key's output place is its place in its run plus,
//   for each other run, the count of that run's keys above it (a binary
//   search).  So any k up to n_probe * lb is taken with no sort library,
//   no float atomics and the same bits on every launch.
//
// IVF.2, falcon_kmeans_count + falcon_kmeans_fill + falcon_kmeans_centroids:
// one Lloyd update of the spherical k-means quantizer.  Replaces the one-hot
// product of falcon_tpu/ops/ivf.py::_kmeans_step (:63) and the
// renormalisation after it: each list's sum of its assigned rows, the old
// centroid where a list is empty, then v / max(||v||, 1e-12).  The plain
// version (falcon_tpu_torch/ops/ivf.py::kmeans_update_plain) adds each
// list's rows one after another in ascending row order from 0 and takes
// the norm in ops/vectorize.py::normalize_rows' order (the squares rounded,
// summed from 0 within windows of 32 dimensions, the padding split evenly
// before and after, then the window sums from 0, the root correctly
// rounded), so no sum can be split or reordered and no float atomic used.
// - Order without a sort: the rows are cut into tiles of `tile` rows (a
//   multiple of 32), one warp each.  falcon_kmeans_count counts each
//   tile's rows per list into a (n_lists, n_tiles) table, list-major, at
//   cnt1[1 + l * n_tiles + t] (cnt1[0] = 0); the wrapper's torch.cumsum
//   makes off[l * n_tiles + t] the first slot of list l's rows of tile t,
//   and off[l * n_tiles] the start of list l.  falcon_kmeans_fill walks
//   each tile again, 32 rows at a time in order: __match_any_sync groups
//   the lanes by list, a lane's rank is the count of lower lanes of its
//   group, and the group's lowest lane reads and advances the tile's
//   running count of the list in shared memory.  So each list's rows land
//   in ascending row order, what a stable sort gives, with no sort and no
//   atomics (a warp owns its tile's counters).
// - falcon_kmeans_centroids: one block per list; each thread owns a float4
//   of dimensions and adds the list's rows in their order with __fadd_rn,
//   KM_BATCH row loads in flight (as B.2's sum kernel, csrc/medoids.cu),
//   or keeps the old centroid for an empty list; the block then takes the
//   norm from shared memory in the plain version's order and writes the
//   unit centroid with IEEE divisions.
// Bound: bytes, each row read once and each old and new centroid once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace falcon {

constexpr int IVF_THREADS = 128;  // the append block: lb is a multiple of 128
constexpr float IVF_NEG = -2.0f;

struct F32Row {
  using Word = float4;  // four dimensions
  __device__ static void widen(const Word& w, float* x) {
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  }
};

struct Bf16Row {
  using Word = uint2;  // four bfloat16 dimensions
  __device__ static void widen(const Word& w, float* x) {
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  }
};

typedef unsigned long long u64;

constexpr unsigned IVF_FULL = 0xffffffffu;
constexpr int TOPK_WARPS = 8;  // rows of a rank block, one warp each
constexpr int TOPK_THREADS = 32 * TOPK_WARPS;
constexpr int WARP_CAP = 512;  // a warp sorts a row of up to this many keys
constexpr int RUN = TOPK_WARPS * WARP_CAP;  // the block's sort run, 32 KB
constexpr int DOT_BATCH = 8;   // words of a dot's rows loaded at once

__device__ __forceinline__ u64 topk_key(float score, int pos) {
  unsigned bits = __float_as_uint(score);
  if (bits == 0x80000000u) bits = 0u;  // -0 ties +0
  const unsigned u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((u64)u << 32) | (u64)(~(unsigned)pos);
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Sorts s[0, P) descending, P a power of two, with threads t of nt; sync()
// separates the network's stages.
template <class Sync>
__device__ __forceinline__ void bitonic_desc(u64* s, int P, int t, int nt,
                                             Sync sync) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = t; c < (P >> 1); c += nt) {
        const int lo = 2 * c - (c & (stride - 1));
        const u64 a = s[lo], b = s[lo + stride];
        if ((a < b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[lo + stride] = a;
        }
      }
      sync();
    }
  }
}

// Where a rank kernel writes a row: its k scores and slots, and its list's
// probe ids.
struct RowOut {
  float* s;
  int* i;
  const int* probes;
  int lb;
  __device__ __forceinline__ void key(int j, u64 key) const {
    const float score = key_score(key);
    const int pos = (int)~(unsigned)key;
    const int p = pos / lb;
    s[j] = score;
    i[j] = score > IVF_NEG ? probes[p] * lb + (pos - p * lb) : -1;
  }
  __device__ __forceinline__ void none(int j) const {
    s[j] = IVF_NEG;
    i[j] = -1;
  }
};

// q . v over `words` words of four dimensions, widened to float32 and
// summed in dimension order, one __fmaf_rn each; eight words of each row
// are loaded before their products, so the loads overlap.
template <class Row>
__device__ __forceinline__ float row_dot(const typename Row::Word* a,
                                         const typename Row::Word* v,
                                         int words) {
  float acc = 0.f;
  int w = 0;
  for (; w + DOT_BATCH <= words; w += DOT_BATCH) {
    typename Row::Word xa[DOT_BATCH], xv[DOT_BATCH];
#pragma unroll
    for (int j = 0; j < DOT_BATCH; ++j) {
      xa[j] = a[w + j];
      xv[j] = v[w + j];
    }
#pragma unroll
    for (int j = 0; j < DOT_BATCH; ++j) {
      float x[4], y[4];
      Row::widen(xa[j], x);
      Row::widen(xv[j], y);
      acc = __fmaf_rn(x[0], y[0], acc);
      acc = __fmaf_rn(x[1], y[1], acc);
      acc = __fmaf_rn(x[2], y[2], acc);
      acc = __fmaf_rn(x[3], y[3], acc);
    }
  }
  for (; w < words; ++w) {
    float x[4], y[4];
    Row::widen(a[w], x);
    Row::widen(v[w], y);
    acc = __fmaf_rn(x[0], y[0], acc);
    acc = __fmaf_rn(x[1], y[1], acc);
    acc = __fmaf_rn(x[2], y[2], acc);
    acc = __fmaf_rn(x[3], y[3], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(IVF_THREADS) ivf_probe_append_kernel(
    const float* __restrict__ qmz, const int* __restrict__ qrow,
    const float* __restrict__ cmz, const int* __restrict__ crow,
    const int* __restrict__ probe_ids, int qlb, int lb, int n_probe, int c0,
    float tol, int tol_is_da, int* __restrict__ count, u64* __restrict__ seg) {
  const int local = blockIdx.x / n_probe;
  const int p = blockIdx.x - local * n_probe;
  const int l = c0 + local;
  const int s = probe_ids[(size_t)l * n_probe + p];
  const size_t width = (size_t)n_probe * lb;
  const float* qm_l = qmz + (size_t)l * qlb;
  const int* qr_l = qrow + (size_t)l * qlb;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int b0 = 0; b0 < lb; b0 += IVF_THREADS) {  // uniform in the block
    const int b = b0 + threadIdx.x;
    const bool on = b < lb;
    const float sm = on ? cmz[(size_t)s * lb + b] : 0.f;
    const int sr = on ? crow[(size_t)s * lb + b] : 0;
    // A window of query m/z around sm that holds every pair the exact
    // test below accepts (widened by more than float32 rounding can move
    // either side); a padded slot's window is empty.
    float lo = __int_as_float(0x7f800000), hi = -lo;
    if (on && isfinite(sm)) {
      if (tol_is_da) {
        const float w = tol * 1.000001f + fabsf(sm) * 4e-7f;
        lo = sm - w;
        hi = sm + w;
      } else if (sm > 0.f) {
        const float w = sm * (tol * 1.001e-6f + 4e-7f);
        lo = sm - w;
        hi = sm + w;
      } else {
        hi = -hi;
        lo = -lo;
      }
    }
    // The warp's window, the union of its lanes' (empty if none).
    float w_lo = lo, w_hi = hi;
    for (int d = 16; d > 0; d >>= 1) {
      w_lo = fminf(w_lo, __shfl_xor_sync(IVF_FULL, w_lo, d));
      w_hi = fmaxf(w_hi, __shfl_xor_sync(IVF_FULL, w_hi, d));
    }
    for (int i0 = 0; i0 < qlb; i0 += 32) {  // uniform: a tile of 32 queries
      const int iq = i0 + lane;
      const float qm_lane = iq < qlb ? qm_l[iq] : 0.f;
      const int qr_lane = iq < qlb ? qr_l[iq] : 0;
      // The tile's finite m/z range (NaN, never in band, if none): a tile
      // that misses the warp's window holds no pair in band.
      const float own = iq < qlb && isfinite(qm_lane)
                            ? qm_lane
                            : __int_as_float(0x7fc00000);
      float t_lo = own, t_hi = own;
      for (int d = 16; d > 0; d >>= 1) {
        t_lo = fminf(t_lo, __shfl_xor_sync(IVF_FULL, t_lo, d));
        t_hi = fmaxf(t_hi, __shfl_xor_sync(IVF_FULL, t_hi, d));
      }
      if (!(t_lo <= w_hi && t_hi >= w_lo)) continue;
      const int n_q = min(32, qlb - i0);
      for (int j = 0; j < n_q; ++j) {  // uniform: the warp shares query i
        const float qm = __shfl_sync(IVF_FULL, qm_lane, j);
        const int qr = __shfl_sync(IVF_FULL, qr_lane, j);
        bool valid = qm >= lo && qm <= hi;
        if (valid) {  // the exact test of _chunk_scan
          valid = isfinite(qm) && qr != sr;
          if (valid) {
            const float diff = __fsub_rn(qm, sm);
            const float mass =
                tol_is_da ? fabsf(diff)
                          : fabsf(__fmul_rn(__fdiv_rn(diff, sm), 1e6f));
            valid = mass <= tol;
          }
        }
        const unsigned hits = __ballot_sync(IVF_FULL, valid);
        if (hits != 0u) {
          const size_t row = (size_t)local * qlb + i0 + j;
          const int first = __ffs(hits) - 1;
          int base = 0;
          if (lane == first) base = atomicAdd(count + row, __popc(hits));
          base = __shfl_sync(IVF_FULL, base, first);
          if (valid) {
            seg[row * width + base + __popc(hits & lower)] =
                (u64)(p * lb + b);
          }
        }
      }
    }
  }
}

// The key of the pair at position pos of a row whose query row is qv.
template <class Row>
struct RowKeys {
  const typename Row::Word* qv;
  const typename Row::Word* c;
  const int* probes;
  int lb, words;
  __device__ __forceinline__ u64 operator()(u64 entry) const {
    const int pos = (int)entry;
    const int p = pos / lb;
    const typename Row::Word* v =
        c + ((size_t)probes[p] * lb + (pos - p * lb)) * words;
    return topk_key(row_dot<Row>(qv, v, words), pos);
  }
};

// A row of n <= WARP_CAP positions e, by one warp with s (WARP_CAP keys
// of shared memory): each position's key, sorted, the first k written.
template <class Keys>
__device__ __forceinline__ void warp_topk(const u64* __restrict__ e, int n,
                                          int k, const Keys& key_of, u64* s,
                                          const RowOut& out) {
  const int lane = threadIdx.x & 31;
  int P = 32;
  while (P < n) P <<= 1;
  for (int j = lane; j < P; j += 32) s[j] = j < n ? key_of(e[j]) : 0ull;
  __syncwarp();
  if (n > 1) bitonic_desc(s, P, lane, 32, [] { __syncwarp(); });
  const int m = min(n, k);
  for (int j = lane; j < k; j += 32) {
    if (j < m) {
      out.key(j, s[j]);
    } else {
      out.none(j);
    }
  }
}

// Count of the keys of run (descending, len keys) above v (v not in it).
__device__ __forceinline__ int keys_above(const u64* __restrict__ run,
                                          int len, u64 v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run[mid] > v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A row of n > WARP_CAP positions e (its segment, rewritten with their
// keys), by the whole block with buf (RUN keys of shared memory).
template <class Keys>
__device__ void block_topk(u64* __restrict__ e, int n, int k,
                           const Keys& key_of, u64* buf, int* hist,
                           int* scalars, const RowOut& out) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int x = t; x < n; x += TOPK_THREADS) e[x] = key_of(e[x]);
  __syncthreads();
  int m = n;
  if (n > k) {
    // The k-th key, 8 bits at a time from the top: want is its rank among
    // the keys that match the digits chosen so far.
    u64 prefix = 0ull, mask = 0ull;
    int want = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int d = t; d < 256; d += TOPK_THREADS) hist[d] = 0;
      __syncthreads();
      for (int x = t; x < n; x += TOPK_THREADS) {
        const u64 v = e[x];
        if ((v & mask) == prefix) {
          atomicAdd(hist + (int)((v >> shift) & 255), 1);
        }
      }
      __syncthreads();
      if (t == 0) {
        int d = 255;
        for (; d > 0 && hist[d] < want; --d) want -= hist[d];
        scalars[0] = d;
        scalars[1] = want;
      }
      __syncthreads();
      prefix |= (u64)scalars[0] << shift;
      mask |= 255ull << shift;
      want = scalars[1];
    }
    // Keys are unique, so exactly k are at or above the k-th: compact them
    // to the front, a tile at a time (a tile is read before any of it is
    // overwritten, and no write reaches past it).
    if (t == 0) scalars[2] = 0;
    __syncthreads();
    const unsigned lower = (1u << lane) - 1u;
    for (int x0 = 0; x0 < n; x0 += TOPK_THREADS) {  // uniform
      const int x = x0 + t;
      const u64 v = x < n ? e[x] : 0ull;
      const bool keep = x < n && v >= prefix;
      __syncthreads();
      const unsigned hits = __ballot_sync(IVF_FULL, keep);
      if (hits != 0u) {
        const int first = __ffs(hits) - 1;
        int base = 0;
        if (lane == first) base = atomicAdd(scalars + 2, __popc(hits));
        base = __shfl_sync(IVF_FULL, base, first);
        if (keep) e[base + __popc(hits & lower)] = v;
      }
    }
    __syncthreads();
    m = k;
  }
  const int runs = (m + RUN - 1) / RUN;
  for (int r = 0; r < runs; ++r) {
    const int len = min(RUN, m - r * RUN);
    int P = 32;
    while (P < len) P <<= 1;
    for (int j = t; j < P; j += TOPK_THREADS) {
      buf[j] = j < len ? e[(size_t)r * RUN + j] : 0ull;
    }
    __syncthreads();
    bitonic_desc(buf, P, t, TOPK_THREADS, [] { __syncthreads(); });
    if (runs == 1) {
      for (int j = t; j < k; j += TOPK_THREADS) {
        if (j < m) {
          out.key(j, buf[j]);
        } else {
          out.none(j);
        }
      }
    } else {
      for (int j = t; j < len; j += TOPK_THREADS) {
        e[(size_t)r * RUN + j] = buf[j];
      }
    }
    __syncthreads();
  }
  if (runs > 1) {
    for (int x = t; x < m; x += TOPK_THREADS) {
      const u64 v = e[x];
      const int r = x / RUN;
      int place = x - r * RUN;
      for (int o = 0; o < runs; ++o) {
        if (o != r) {
          place += keys_above(e + (size_t)o * RUN, min(RUN, m - o * RUN), v);
        }
      }
      out.key(place, v);
    }
    for (int j = m + t; j < k; j += TOPK_THREADS) out.none(j);
    __syncthreads();
  }
}

template <class Row>
__global__ void __launch_bounds__(TOPK_THREADS) ivf_rank_kernel(
    const typename Row::Word* __restrict__ q,
    const typename Row::Word* __restrict__ c, int words,
    const int* __restrict__ count, u64* __restrict__ seg, int rows,
    int width, int k, const int* __restrict__ probe_ids, int n_probe, int lb,
    int qlb, int c0, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ u64 buf[RUN];
  __shared__ int hist[256];
  __shared__ int scalars[3];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TOPK_WARPS;
  auto out_of = [&](int row) {
    return RowOut{out_s + (size_t)row * k, out_i + (size_t)row * k,
                  probe_ids + (size_t)(c0 + row / qlb) * n_probe, lb};
  };
  auto keys_of = [&](int row) {
    const int l = c0 + row / qlb;
    return RowKeys<Row>{q + ((size_t)l * qlb + row % qlb) * words, c,
                        probe_ids + (size_t)l * n_probe, lb, words};
  };
  const int row = row0 + warp;
  if (row < rows) {
    const int n = count[row];
    if (n <= WARP_CAP) {
      warp_topk(seg + (size_t)row * width, n, k, keys_of(row),
                buf + warp * WARP_CAP, out_of(row));
    }
  }
  for (int w = 0; w < TOPK_WARPS && row0 + w < rows; ++w) {  // uniform
    const int n = count[row0 + w];
    if (n > WARP_CAP) {
      __syncthreads();  // the warps are done with buf
      block_topk(seg + (size_t)(row0 + w) * width, n, k, keys_of(row0 + w),
                 buf, hist, scalars, out_of(row0 + w));
    }
  }
}

constexpr unsigned KM_FULL = 0xffffffffu;
constexpr int KM_THREADS = 128;  // the centroid kernel's block
constexpr int KM_BATCH = 32;     // rows in flight per thread

// Walks tile blockIdx.x of `assign` (rows [t * tile, min(t * tile + tile,
// n)), 32 at a time, in order) with one warp; `run` holds the tile's
// running count of each list (n_lists ints of shared memory, zeroed here).
// For each row with a list in [0, n_lists), calls visit(row, list, rank):
// rank is the count of the tile's earlier rows of the same list.
template <class Visit>
__device__ __forceinline__ void walk_tile(const int* __restrict__ assign,
                                          int n, int n_lists, int tile,
                                          int* run, Visit visit) {
  const int lane = threadIdx.x;
  for (int l = lane; l < n_lists; l += 32) run[l] = 0;
  __syncwarp();
  const int r0 = blockIdx.x * tile;
  const int r_end = min(r0 + tile, n);
  for (int r = r0; r < r_end; r += 32) {  // uniform in the warp
    const int i = r + lane;
    int l = i < r_end ? assign[i] : -1;
    if (l >= n_lists) l = -1;  // outside [0, n_lists): dropped
    const unsigned peers = __match_any_sync(KM_FULL, l);
    const unsigned lower = peers & ((1u << lane) - 1u);
    int base = 0;
    if (l >= 0 && lower == 0u) {  // the group's lowest lane
      base = run[l];
      run[l] = base + __popc(peers);
    }
    base = __shfl_sync(KM_FULL, base, __ffs(peers) - 1);
    if (l >= 0) visit(i, l, base + __popc(lower));
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32) kmeans_count_kernel(
    const int* __restrict__ assign, int n, int n_lists, int tile,
    int n_tiles, int* __restrict__ cnt1) {
  extern __shared__ int run[];
  walk_tile(assign, n, n_lists, tile, run, [](int, int, int) {});
  __syncwarp();
  const int t = blockIdx.x;
  for (int l = threadIdx.x; l < n_lists; l += 32) {
    cnt1[1 + (size_t)l * n_tiles + t] = run[l];
  }
  if (t == 0 && threadIdx.x == 0) cnt1[0] = 0;
}

__global__ void __launch_bounds__(32) kmeans_fill_kernel(
    const int* __restrict__ assign, int n, int n_lists, int tile,
    int n_tiles, const int* __restrict__ off, int* __restrict__ items) {
  extern __shared__ int run[];
  const size_t t = blockIdx.x;
  walk_tile(assign, n, n_lists, tile, run, [&](int i, int l, int rank) {
    items[off[(size_t)l * n_tiles + t] + rank] = i;
  });
}

__global__ void __launch_bounds__(KM_THREADS) kmeans_centroids_kernel(
    const float4* __restrict__ v, int dim, const int* __restrict__ items,
    const int* __restrict__ off, int n_tiles,
    const float4* __restrict__ old, float4* __restrict__ out) {
  extern __shared__ float4 sum4[];  // dim / 4, then the window sums
  const int l = blockIdx.x;
  const int n4 = dim >> 2;
  float* sum = reinterpret_cast<float*>(sum4);
  float* win = sum + dim;
  __shared__ float norm;
  const int lane = threadIdx.x & 31;
  const int beg = off[(size_t)l * n_tiles];
  const int end = off[(size_t)(l + 1) * n_tiles];
  for (int q0 = 0; q0 < n4; q0 += KM_THREADS) {  // uniform in the block
    const int q = q0 + threadIdx.x;
    const bool on = q < n4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = beg; b < end; b += KM_BATCH) {
      const int mine = b + lane < end ? items[b + lane] : 0;
      float4 r[KM_BATCH];
#pragma unroll
      for (int j = 0; j < KM_BATCH; ++j) {
        const int row = __shfl_sync(KM_FULL, mine, j);
        if (on && b + j < end) r[j] = v[(size_t)row * n4 + q];
      }
#pragma unroll
      for (int j = 0; j < KM_BATCH; ++j) {
        if (on && b + j < end) {
          acc = make_float4(__fadd_rn(acc.x, r[j].x),
                            __fadd_rn(acc.y, r[j].y),
                            __fadd_rn(acc.z, r[j].z),
                            __fadd_rn(acc.w, r[j].w));
        }
      }
    }
    if (on) sum4[q] = end > beg ? acc : old[(size_t)l * n4 + q];
  }
  __syncthreads();
  // normalize_rows' order: windows of 32 dimensions over the dimensions
  // padded by `low` zeros in front (adding a zero square changes nothing,
  // so the padding is skipped), each summed from 0, then the windows.
  const int n_win = (dim + 31) / 32;
  const int low = dim > 32 ? (n_win * 32 - dim) / 2 : 0;
  for (int w = threadIdx.x; w < n_win; w += KM_THREADS) {
    float part = 0.f;
    for (int j = 0; j < 32; ++j) {
      const int d = 32 * w + j - low;
      if (d >= 0 && d < dim) part = __fadd_rn(part, __fmul_rn(sum[d], sum[d]));
    }
    win[w] = part;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < n_win; ++w) total = __fadd_rn(total, win[w]);
    norm = fmaxf(__fsqrt_rn(total), 1e-12f);
  }
  __syncthreads();
  const float nm = norm;
  for (int q = threadIdx.x; q < n4; q += KM_THREADS) {
    const float4 a = sum4[q];
    out[(size_t)l * n4 + q] = make_float4(
        __fdiv_rn(a.x, nm), __fdiv_rn(a.y, nm), __fdiv_rn(a.z, nm),
        __fdiv_rn(a.w, nm));
  }
}

}  // namespace falcon

extern "C" {

// q (n_lists, qlb, dim) and c (n_lists, lb, dim), both float32 (bf16 = 0)
// or both bfloat16 (bf16 = 1), rows 16-byte (f32) or 8-byte (bf16) aligned,
// dim a multiple of 4; qmz, qrow (n_lists, qlb) and cmz, crow (n_lists, lb)
// float32 / int32 (padding: m/z +inf); probe_ids (n_lists, n_probe) int32;
// 1 <= k <= n_probe * lb < 2^31.  For the lists [c0, c0 + chunk), writes
// out_s (chunk, qlb, k) float32 and out_i int32; count (chunk * qlb) int32
// and seg (chunk * qlb, n_probe * lb) 64-bit keys are scratch.
int falcon_ivf_probe_topk(const void* q, const void* c, const float* qmz,
                          const int* qrow, const float* cmz, const int* crow,
                          const int* probe_ids, int qlb, int lb, int dim,
                          int n_probe, int c0, int chunk, float tol,
                          int tol_is_da, int bf16, int k, int* count,
                          void* seg, float* out_s, int* out_i, void* stream) {
  if (chunk <= 0 || qlb <= 0) return (int)cudaGetLastError();
  const long long width = (long long)n_probe * lb;
  if ((dim & 3) || dim <= 0 || n_probe <= 0 || lb <= 0 || k <= 0 ||
      k > width || width > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = chunk * qlb;
  cudaError_t err = cudaMemsetAsync(count, 0, (size_t)rows * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)chunk * (unsigned)n_probe;
  falcon::u64* keys = static_cast<falcon::u64*>(seg);
  falcon::ivf_probe_append_kernel<<<blocks, falcon::IVF_THREADS, 0, s>>>(
      qmz, qrow, cmz, crow, probe_ids, qlb, lb, n_probe, c0, tol, tol_is_da,
      count, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned rank_blocks =
      (rows + falcon::TOPK_WARPS - 1) / falcon::TOPK_WARPS;
  if (bf16) {
    falcon::ivf_rank_kernel<falcon::Bf16Row>
        <<<rank_blocks, falcon::TOPK_THREADS, 0, s>>>(
            static_cast<const uint2*>(q), static_cast<const uint2*>(c),
            dim >> 2, count, keys, rows, (int)width, k, probe_ids, n_probe,
            lb, qlb, c0, out_s, out_i);
  } else {
    falcon::ivf_rank_kernel<falcon::F32Row>
        <<<rank_blocks, falcon::TOPK_THREADS, 0, s>>>(
            static_cast<const float4*>(q), static_cast<const float4*>(c),
            dim >> 2, count, keys, rows, (int)width, k, probe_ids, n_probe,
            lb, qlb, c0, out_s, out_i);
  }
  return (int)cudaGetLastError();
}

// IVF.2, step 1.  assign (n,) int32; rows of a list outside [0, n_lists)
// are dropped.  Writes cnt1 (1 + n_lists * n_tiles) int32, n_tiles =
// ceil(n / tile), tile a positive multiple of 32, n_lists <= 12,288.
int falcon_kmeans_count(const int* assign, int n, int n_lists, int tile,
                        int* cnt1, void* stream) {
  if (n <= 0) {  // no tile: cnt1 is cnt1[0] alone
    return (int)cudaMemsetAsync(cnt1, 0, sizeof(int), (cudaStream_t)stream);
  }
  const int n_tiles = (n + tile - 1) / tile;
  falcon::kmeans_count_kernel<<<n_tiles, 32, n_lists * sizeof(int),
                                (cudaStream_t)stream>>>(
      assign, n, n_lists, tile, n_tiles, cnt1);
  return (int)cudaGetLastError();
}

// IVF.2, step 3, after off = cumsum(cnt1): items (n,) int32, each list's
// rows in off[l * n_tiles] .. off[(l + 1) * n_tiles], ascending.
int falcon_kmeans_fill(const int* assign, int n, int n_lists, int tile,
                       const int* off, int* items, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n + tile - 1) / tile;
  falcon::kmeans_fill_kernel<<<n_tiles, 32, n_lists * sizeof(int),
                               (cudaStream_t)stream>>>(
      assign, n, n_lists, tile, n_tiles, off, items);
  return (int)cudaGetLastError();
}

// IVF.2, step 4.  v (n, dim) float32 rows, 16-byte aligned, dim a multiple
// of 4 (at most 8,192); old and out (n_lists, dim) float32.
int falcon_kmeans_centroids(const float* v, int dim, const int* items,
                            const int* off, int n_lists, int n_tiles,
                            const float* old, float* out, void* stream) {
  if ((dim & 3) || dim <= 0) return (int)cudaErrorInvalidValue;
  const size_t shared = (dim + (dim + 31) / 32) * sizeof(float);
  falcon::kmeans_centroids_kernel<<<n_lists, falcon::KM_THREADS, shared,
                                    (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(v), dim, items, off, n_tiles,
      reinterpret_cast<const float4*>(old), reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
