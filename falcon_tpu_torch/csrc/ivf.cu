// The IVF index's kernels, IVF.1 and IVF.2, with a plain C interface for
// ctypes (falcon_tpu_torch/ops/_build.py).  Each entry point launches on
// the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// IVF.1, falcon_ivf_probe_scan: the probe scan.  Replaces the block gather
// and the einsum of _chunk_scan in
// falcon_tpu/ops/ivf.py (:543-630): for each list l of the chunk
// [c0, c0 + chunk), each of its query slots i < qlb and each probe p with
// slab slot b < lb, the score of the pair is q[l, i] . c[s, b], s =
// probe_ids[l, p], written to out[l - c0, i, p * lb + b], or NEG = -2 where
// _chunk_scan masks the pair:
// - the query slot is padding (its m/z is not finite);
// - the slab slot is padding (its m/z is not finite);
// - the pair is out of the precursor tolerance: |qm - sm| <= tol (Da) or
//   |(qm - sm) / sm * 1e6| <= tol (ppm), in float32 with an IEEE division,
//   as XLA computes it (tol = inf admits every real pair);
// - the two slots hold the same row (the self pair).
// JAX does not mask a padded query slot at tol = inf; those rows score
// zero vectors and are dropped by the caller, so the results do not change.
//
// Bound: bytes.  The whole (chunk, qlb, n_probe * lb) float32 buffer is
// written (the stable top-k reads it), 256 MB a chunk at the engine's
// sizes, while the probed slabs are read in place from the (n_lists, lb, D)
// layout: no (chunk, n_probe, lb, D) gathered copy is built.  On real
// corpora a precursor band holds a few hundred spectra of the thousands of
// probed slots, so nearly every pair is masked, and the mask is tested
// before the dot: a masked pair costs its metadata reads and one store.
//
// Design: one block per (list, probe) pair; its threads walk the qlb x lb
// pairs with consecutive threads on consecutive slab slots, so the m/z and
// row reads of the slab and the score stores coalesce and the query's
// metadata is one broadcast read a warp.  A valid pair's dot is one
// thread's: operands widened to float32 (bf16 widening is exact), four
// dimensions loaded at a time, summed in dimension order with __fmaf_rn,
// which is the plain version's order (falcon_tpu_torch/ops/ivf.py), so the
// two agree bit for bit.  No tensor cores: their sums have another order.
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

constexpr int IVF_THREADS = 256;
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

template <class Row>
__global__ void __launch_bounds__(IVF_THREADS) ivf_probe_scan_kernel(
    const typename Row::Word* __restrict__ q,
    const typename Row::Word* __restrict__ c, const float* __restrict__ qmz,
    const int* __restrict__ qrow, const float* __restrict__ cmz,
    const int* __restrict__ crow, const int* __restrict__ probe_ids,
    int qlb, int lb, int words, int n_probe, int c0, float tol, int tol_is_da,
    float* __restrict__ out) {
  const int local = blockIdx.x / n_probe;
  const int p = blockIdx.x - local * n_probe;
  const int l = c0 + local;
  const int s = probe_ids[(size_t)l * n_probe + p];
  const int width = n_probe * lb;
  const float* qm_l = qmz + (size_t)l * qlb;
  const int* qr_l = qrow + (size_t)l * qlb;
  const float* sm_s = cmz + (size_t)s * lb;
  const int* sr_s = crow + (size_t)s * lb;
  const int pairs = qlb * lb;
  for (int t = threadIdx.x; t < pairs; t += IVF_THREADS) {
    const int i = t / lb;
    const int b = t - i * lb;
    const float qm = qm_l[i];
    const float sm = sm_s[b];
    bool valid = isfinite(qm) && isfinite(sm) && qr_l[i] != sr_s[b];
    if (valid) {
      const float diff = __fsub_rn(qm, sm);
      const float mass = tol_is_da
                             ? fabsf(diff)
                             : fabsf(__fmul_rn(__fdiv_rn(diff, sm), 1e6f));
      valid = mass <= tol;
    }
    float acc = IVF_NEG;
    if (valid) {
      const typename Row::Word* a = q + ((size_t)l * qlb + i) * words;
      const typename Row::Word* v = c + ((size_t)s * lb + b) * words;
      acc = 0.f;
      for (int w = 0; w < words; ++w) {
        float x[4], y[4];
        Row::widen(a[w], x);
        Row::widen(v[w], y);
        acc = __fmaf_rn(x[0], y[0], acc);
        acc = __fmaf_rn(x[1], y[1], acc);
        acc = __fmaf_rn(x[2], y[2], acc);
        acc = __fmaf_rn(x[3], y[3], acc);
      }
    }
    out[((size_t)local * qlb + i) * width + (size_t)p * lb + b] = acc;
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
// float32 / int32 (padding: m/z +inf); probe_ids (n_lists, n_probe) int32.
// Writes out (chunk, qlb, n_probe * lb) for the lists [c0, c0 + chunk).
int falcon_ivf_probe_scan(const void* q, const void* c, const float* qmz,
                          const int* qrow, const float* cmz, const int* crow,
                          const int* probe_ids, int qlb, int lb, int dim,
                          int n_probe, int c0, int chunk, float tol,
                          int tol_is_da, int bf16, float* out, void* stream) {
  if (chunk <= 0 || n_probe <= 0 || qlb <= 0 || lb <= 0) {
    return (int)cudaGetLastError();
  }
  if ((dim & 3) || dim <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)chunk * (unsigned)n_probe;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    falcon::ivf_probe_scan_kernel<falcon::Bf16Row>
        <<<blocks, falcon::IVF_THREADS, 0, s>>>(
            static_cast<const uint2*>(q), static_cast<const uint2*>(c), qmz,
            qrow, cmz, crow, probe_ids, qlb, lb, dim >> 2, n_probe, c0, tol,
            tol_is_da, out);
  } else {
    falcon::ivf_probe_scan_kernel<falcon::F32Row>
        <<<blocks, falcon::IVF_THREADS, 0, s>>>(
            static_cast<const float4*>(q), static_cast<const float4*>(c), qmz,
            qrow, cmz, crow, probe_ids, qlb, lb, dim >> 2, n_probe, c0, tol,
            tol_is_da, out);
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
