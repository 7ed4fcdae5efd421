// Medoid scores of the ann engine's dbscan mode, with a plain C interface
// for ctypes (falcon_tpu_torch/ops/_build.py).  Each entry point launches
// on the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launches.
//
// Both replace XLA scatter-adds of falcon_tpu/cluster/ann_engine.py, which
// on the CPU add their updates one after another in index order.  An atomic
// scatter on the card adds in no fixed order, and the medoid is the first
// maximum of these scores by row, so one ulp can change it from run to run.
// Here every sum is taken in the order the plain versions
// (falcon_tpu_torch/ops/medoids.py) take it, which is XLA's order on the
// CPU, so kernel and plain version agree bit for bit.
//
// 1. falcon_medoid_weights + falcon_medoid_sums replace
//    _sparse_exact_medoid_scores (:180-260): per row, the sum of the exact
//    similarities max(s, 0) to same-cluster neighbours over the sparse
//    lists, each unordered pair counted once (an edge a -> b counts when
//    a < b or when b's list does not hold a), added to both ends.  XLA
//    walks 1,024-row chunks: per chunk it adds each row's own sum (a row
//    reduction that XLA splits into windows of 32) and then scatters the
//    chunk's counted weights to their targets in (row, slot) order.  So a
//    target's total is its incoming weights from earlier chunks, then its
//    own row sum, then the rest of its incoming weights.
//    - falcon_medoid_weights: one warp per row; lanes over slots find the
//      valid edges, and for each one the warp scans the neighbour's list for
//      the row (the mutual test).  It writes the counted weights, their
//      int32 targets (n_pad for none: a sink), the row sums, and counts each
//      target's in-edges (step 1 of the group-by, csrc/groupby.cuh).
//    - The wrapper scans the counts and falcon_groupby_fill (csrc/
//      groupby.cu) puts each target's flat indices f = row * k + slot in
//      its range, in no fixed order.
//    - falcon_medoid_sums orders each target's range by f, ascending,
//      which is (row, slot) order (targets of more than MED_WARP_CAP
//      in-edges in a launch of their own first, the rest inside the sums
//      kernel), and one lane per target walks it in that order, inserting
//      the row sum where the reference adds it.  No sort of the whole
//      (n_pad, k) array runs, and no float atomics.
//    Bound: bytes, the (n, k) lists read, the scores written; the mutual
//    test reads a neighbour's list per valid edge, mostly from L2.
// 2. falcon_hashed_medoid_scores replaces _medoid_scores (:138-174): the
//    per-cluster sums s_C of the normalised vectors (rows in order), then
//    v_i . s_C per row as XLA's CPU dot (a GEMV in tiles of 8) takes it:
//    the first 8 products rounded and added in order, then one fused
//    multiply-add per dimension in order.  One warp per cluster: lanes over dimensions
//    sum the member rows into shared memory, then each lane scores one
//    member.  The noise segment's sum is never read and is skipped.
//    Bound: bytes, each member row read twice (sum, dot), one score out.

#include <cuda_runtime.h>

#include "groupby.cuh"

namespace falcon {

constexpr unsigned MED_FULL = 0xffffffffu;
constexpr int MED_WARPS = 8;
constexpr int MED_WARP_CAP = 1024;  // the warp tier of the sums, 4 KB a warp

// XLA's CPU row sum: above 32 entries the reduction is split into windows
// of 32 (padding split evenly before and after), each summed in order,
// then the windows' sums in order.  k <= 1024, so one level of windows.
__device__ inline float xla_row_sum(const float* w, int k) {
  if (k <= 32) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = __fadd_rn(s, w[j]);
    return s;
  }
  const int nw = (k + 31) / 32;
  const int low = (nw * 32 - k) / 2;
  float total = 0.f;
  for (int m = 0; m < nw; ++m) {
    const int j0 = max(m * 32 - low, 0);
    const int j1 = min(m * 32 - low + 32, k);
    float part = 0.f;
    for (int j = j0; j < j1; ++j) part = __fadd_rn(part, w[j]);
    total = __fadd_rn(total, part);
  }
  return total;
}

__global__ void __launch_bounds__(MED_WARPS * 32) medoid_weights_kernel(
    const float* __restrict__ sims, const long long* __restrict__ neigh,
    const int* __restrict__ seg, int n_pad, int k, int spill,
    float* __restrict__ w, int* __restrict__ tgt,
    float* __restrict__ rowsum, int* __restrict__ cnt1) {
  extern __shared__ float wsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n_pad) return;  // warps are independent
  float* wrow = wsm + (size_t)warp * k;
  const int si = seg[i];
  const size_t base = (size_t)i * k;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < k;
    const long long nb = in ? neigh[base + j] : -1;
    const long long nbs = nb < 0 ? 0 : (nb >= n_pad ? n_pad - 1 : nb);
    const bool valid = in && nb >= 0 && si != spill && seg[nbs] == si;
    bool mutual = false;
    for (unsigned todo = __ballot_sync(MED_FULL, valid); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const long long other = __shfl_sync(MED_FULL, nbs, src);
      bool found = false;
      for (int l = lane; l < k; l += 32) {
        found |= neigh[(size_t)other * k + l] == i;
      }
      const bool any = __ballot_sync(MED_FULL, found) != 0u;
      if (lane == src) mutual = any;
    }
    const bool counted = valid && (i < nbs || !mutual);
    const float wc = counted ? fmaxf(sims[base + j], 0.f) : 0.f;
    if (in) {
      w[base + j] = wc;
      tgt[base + j] = counted ? (int)nbs : n_pad;
      if (counted) atomicAdd(&cnt1[nbs + 1], 1);
      wrow[j] = wc;
    }
  }
  __syncwarp();
  if (lane == 0) rowsum[i] = xla_row_sum(wrow, k);
}

__global__ void __launch_bounds__(MED_WARPS * 32) medoid_sums_kernel(
    const float* __restrict__ w, int* items, const int* __restrict__ off,
    const float* __restrict__ rowsum, int n_pad, int k, int chunk,
    float* __restrict__ out) {
  __shared__ int buf[MED_WARPS][MED_WARP_CAP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * MED_WARPS + warp) * 32;
  if (t0 >= n_pad) return;  // the whole warp
  const int t = t0 + lane;
  const int beg = t < n_pad ? off[t] : 0;
  const int end = t < n_pad ? off[t + 1] : 0;
  order_tiers<MED_WARP_CAP>(items, beg, end - beg, ByPosition(), buf[warp],
                            lane);
  if (t >= n_pad) return;
  const int first = (t / chunk) * chunk * k;  // the target's chunk's first f
  int e = beg;
  float acc = 0.f;
  for (; e < end; ++e) {
    const int f = items[e];
    if (f >= first) break;
    acc = __fadd_rn(acc, w[f]);
  }
  acc = __fadd_rn(acc, rowsum[t]);
  for (; e < end; ++e) acc = __fadd_rn(acc, w[items[e]]);
  out[t] = acc;
}

__global__ void __launch_bounds__(MED_WARPS * 32) hashed_medoid_kernel(
    const float* __restrict__ v, int dim, const long long* __restrict__ rows,
    const long long* __restrict__ off, int n_seg, float* __restrict__ out) {
  extern __shared__ float4 sum_sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= n_seg) return;  // warps are independent
  const int n4 = dim >> 2;
  float4* sum = sum_sm + (size_t)warp * n4;
  for (int q = lane; q < n4; q += 32) sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long beg = off[s], end = off[s + 1];
  for (long long e = beg; e < end; ++e) {
    const float4* r = reinterpret_cast<const float4*>(v + rows[e] * dim);
    for (int q = lane; q < n4; q += 32) {
      const float4 a = sum[q], b = r[q];
      sum[q] = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                           __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
    }
  }
  __syncwarp();
  for (long long e = beg + lane; e < end; e += 32) {
    const float4* r = reinterpret_cast<const float4*>(v + rows[e] * dim);
    float acc = 0.f;
    for (int q = 0; q < 2; ++q) {  // dim >= 8: the first tile, unfused
      const float4 a = r[q], b = sum[q];
      acc = q == 0 ? __fmul_rn(a.x, b.x)
                   : __fadd_rn(acc, __fmul_rn(a.x, b.x));
      acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
      acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
      acc = __fadd_rn(acc, __fmul_rn(a.w, b.w));
    }
    for (int q = 2; q < n4; ++q) {
      const float4 a = r[q], b = sum[q];
      acc = __fmaf_rn(a.x, b.x, acc);
      acc = __fmaf_rn(a.y, b.y, acc);
      acc = __fmaf_rn(a.z, b.z, acc);
      acc = __fmaf_rn(a.w, b.w, acc);
    }
    out[rows[e]] = acc;
  }
}

}  // namespace falcon

extern "C" {

// sims (n_pad, k) f32, neigh (n_pad, k) int64 (-1 = none), seg (n_pad,)
// int32 with noise and padding in segment `spill`; k <= 1024 and n_pad * k
// < 2^31.  Writes w and tgt (n_pad, k) and rowsum (n_pad,), and adds each
// counted edge to cnt1[target + 1] (n_pad + 1, zeroed by the caller).
int falcon_medoid_weights(const float* sims, const long long* neigh,
                          const int* seg, int n_pad, int k, int spill,
                          float* w, int* tgt, float* rowsum, int* cnt1,
                          void* stream) {
  if (n_pad <= 0 || k <= 0) return (int)cudaGetLastError();
  if (k > 1024) return (int)cudaErrorInvalidValue;
  const int warps = falcon::MED_WARPS;
  const size_t bytes = (size_t)warps * k * sizeof(float);
  const unsigned blocks = (unsigned)((n_pad + warps - 1) / warps);
  falcon::medoid_weights_kernel<<<blocks, warps * 32, bytes,
                                  (cudaStream_t)stream>>>(
      sims, neigh, seg, n_pad, k, spill, w, tgt, rowsum, cnt1);
  return (int)cudaGetLastError();
}

// items: each target's flat (row * k + slot) indices in its range of off
// (n_pad + 1,), in any order (falcon_groupby_fill); ordered here in place.
// Writes out (n_pad,).
int falcon_medoid_sums(const float* w, int* items, const int* off,
                       const float* rowsum, int n_pad, int k, int chunk,
                       float* out, void* stream) {
  if (n_pad <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = falcon::launch_order_long(
      off, n_pad, items, falcon::MED_WARP_CAP, falcon::ByPosition(), s);
  if (err != cudaSuccess) return (int)err;
  const int per_block = falcon::MED_WARPS * 32;
  falcon::medoid_sums_kernel<<<(n_pad + per_block - 1) / per_block,
                               per_block, 0, s>>>(w, items, off, rowsum,
                                                  n_pad, k, chunk, out);
  return (int)cudaGetLastError();
}

// v (rows, dim) f32, 16-byte aligned, dim a multiple of 4 and >= 8; rows:
// row ids
// sorted stably by segment; off (n_seg + 1,): each segment's range.  Writes
// out[row] for every row of segments 0 .. n_seg - 1.
int falcon_hashed_medoid_scores(const float* v, int dim,
                                const long long* rows, const long long* off,
                                int n_seg, float* out, void* stream) {
  if (n_seg <= 0 || dim <= 0) return (int)cudaGetLastError();
  if ((dim & 3) || dim < 8) return (int)cudaErrorInvalidValue;
  int warps = falcon::MED_WARPS;
  while (warps > 1 && (size_t)warps * dim * sizeof(float) > 48 * 1024) {
    warps >>= 1;
  }
  const size_t bytes = (size_t)warps * dim * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        falcon::hashed_medoid_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n_seg + warps - 1) / warps);
  falcon::hashed_medoid_kernel<<<blocks, warps * 32, bytes,
                                 (cudaStream_t)stream>>>(v, dim, rows, off,
                                                         n_seg, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
