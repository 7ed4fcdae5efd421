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
// 2. falcon_hashed_medoid_sums + falcon_hashed_medoid_dot replace
//    _medoid_scores (:138-174): the per-cluster sums s_C of the normalised
//    vectors (member rows in ascending order), then v_i . s_C per row as
//    XLA's CPU dot (a GEMV in tiles of 8) takes it: the first 8 products
//    rounded and added in order, then one fused multiply-add per dimension
//    in order.  That order rules out tensor cores and a split of either sum.
//    - The wrapper puts each cluster's rows in ascending order with the
//      group-by's own entry points (falcon_groupby_count, _fill, _order of
//      csrc/groupby.cu, key seg, n_groups spill: noise rows are sinks).
//    - falcon_hashed_medoid_sums: one block of HM_SUM_THREADS per
//      cluster, never a warp, each thread owning a float4 of dimensions
//      (several in turn when dim > 4 * HM_SUM_THREADS).  It adds the
//      member rows with __fadd_rn in the ids' order, HM_BATCH rows in
//      flight, each row one coalesced read of the block, and writes the
//      sums to an (n_seg, dim) table in global memory (2 KB a cluster at
//      dim 512, held in L2 for the dot).  A 3,000-member cluster gets
//      128 threads over 512 dimensions, not 32 lanes.
//    - falcon_hashed_medoid_dot: one thread per row, over every row; a warp
//      stages its 32 rows in tiles of 32 dimensions through padded
//      [32][33] shared tiles (coalesced 128-byte reads, no bank conflicts),
//      two tiles a step with the next step's rows in flight, while each
//      lane walks its own row's dimensions against its cluster's sum
//      (float4 reads from the table).  Noise rows write 0, so every
//      out[row < n] is written.
//    Bound: bytes, each member row read once and one score written.

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

constexpr int HM_SUM_THREADS = 128;  // the sum kernel's block
constexpr int HM_BATCH = 32;         // member rows in flight per thread
constexpr int HM_DOT_WARPS = 4;      // the dot kernel's block, in warps
constexpr int HM_DOT_SUB = 2;        // 32-dimension tiles per dot step

// Each cluster's sum over its member rows items[off[s] .. off[s + 1]), in
// that order, one dimension at a time: block s, threads over float4s of
// dimensions.  A batch's row ids are read one a lane and broadcast with
// shuffles, and all of its HM_BATCH row loads are issued before its first
// add: on the H100, ids read from shared memory, or a ring that refills
// each slot as it is added, kept fewer loads in flight, and batches of 16
// or 8 (fewer registers) were slower on a 3,000-member cluster than they
// were faster on clusters of ~10 (PERF.md).
__global__ void __launch_bounds__(HM_SUM_THREADS) hashed_medoid_sums_kernel(
    const float4* __restrict__ v, int n4, const int* __restrict__ items,
    const int* __restrict__ off, float4* __restrict__ sums) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int beg = off[s], end = off[s + 1];
  for (int q0 = 0; q0 < n4; q0 += HM_SUM_THREADS) {  // uniform in the block
    const int q = q0 + threadIdx.x;
    const bool on = q < n4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = beg; b < end; b += HM_BATCH) {
      const int mine =
          lane < HM_BATCH && b + lane < end ? items[b + lane] : 0;
      float4 r[HM_BATCH];
#pragma unroll
      for (int j = 0; j < HM_BATCH; ++j) {
        const int row = __shfl_sync(MED_FULL, mine, j);
        if (on && b + j < end) r[j] = v[(size_t)row * n4 + q];
      }
#pragma unroll
      for (int j = 0; j < HM_BATCH; ++j) {
        if (on && b + j < end) {
          acc = make_float4(__fadd_rn(acc.x, r[j].x),
                            __fadd_rn(acc.y, r[j].y),
                            __fadd_rn(acc.z, r[j].z),
                            __fadd_rn(acc.w, r[j].w));
        }
      }
    }
    if (on) sums[(size_t)s * n4 + q] = acc;
  }
}

// out[i] = v_i . sums[seg[i]] in XLA's order for each row i < n, 0 for
// the noise rows (seg[i] == spill).  Lane l of a warp owns row 32 w + l.
// A step takes HM_DOT_SUB tiles of 32 rows x 32 dimensions; the next
// step's rows are in flight while this step's are used.
__global__ void __launch_bounds__(HM_DOT_WARPS * 32) hashed_medoid_dot_kernel(
    const float* __restrict__ v, int dim, const int* __restrict__ seg, int n,
    int spill, const float* __restrict__ sums, float* __restrict__ out) {
  __shared__ float tile[HM_DOT_WARPS][HM_DOT_SUB][32][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * HM_DOT_WARPS + warp) * 32;
  if (i0 >= n) return;  // the whole warp
  const int i = i0 + lane;
  const int si = i < n ? seg[i] : spill;
  const unsigned live = __ballot_sync(MED_FULL, si != spill);
  if (!live) {
    if (i < n) out[i] = 0.f;
    return;
  }
  float(*t)[32][33] = tile[warp];
  // Lane l loads dimensions 4 (l % 8) .. + 3 of rows l / 8 + 4 r.
  const int sub = lane >> 3, col = (lane & 7) * 4;
  float4 cur[HM_DOT_SUB][8];
  auto load = [&](int d0) {
#pragma unroll
    for (int u = 0; u < HM_DOT_SUB; ++u) {
      const int d = d0 + 32 * u + col;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = sub + 4 * r;
        cur[u][r] = ((live >> row) & 1u) && d < dim
                        ? *reinterpret_cast<const float4*>(
                              v + (size_t)(i0 + row) * dim + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  const float* srow = sums + (size_t)(si != spill ? si : 0) * dim;
  float acc = 0.f;
  load(0);
  for (int d0 = 0; d0 < dim; d0 += 32 * HM_DOT_SUB) {
    __syncwarp();  // the last step's tiles are read
#pragma unroll
    for (int u = 0; u < HM_DOT_SUB; ++u) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* dst = &t[u][sub + 4 * r][col];
        dst[0] = cur[u][r].x;
        dst[1] = cur[u][r].y;
        dst[2] = cur[u][r].z;
        dst[3] = cur[u][r].w;
      }
    }
    __syncwarp();
    if (d0 + 32 * HM_DOT_SUB < dim) load(d0 + 32 * HM_DOT_SUB);
    if (si == spill) continue;
    float4 b[HM_DOT_SUB][8];  // this step's cluster sum, all loads at once
#pragma unroll
    for (int u = 0; u < HM_DOT_SUB; ++u) {
#pragma unroll
      for (int j4 = 0; j4 < 8; ++j4) {
        const int d = d0 + 32 * u + 4 * j4;
        if (d < dim) {
          b[u][j4] = __ldg(reinterpret_cast<const float4*>(srow + d));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < HM_DOT_SUB; ++u) {
      const float* a = t[u][lane];
#pragma unroll
      for (int j4 = 0; j4 < 8; ++j4) {
        const int d = d0 + 32 * u + 4 * j4;
        if (d >= dim) break;
        const float4 c = b[u][j4];
        const float* x = a + 4 * j4;
        if (d < 8) {  // XLA's first tile of 8 products: unfused
          acc = d == 0 ? __fmul_rn(x[0], c.x)
                       : __fadd_rn(acc, __fmul_rn(x[0], c.x));
          acc = __fadd_rn(acc, __fmul_rn(x[1], c.y));
          acc = __fadd_rn(acc, __fmul_rn(x[2], c.z));
          acc = __fadd_rn(acc, __fmul_rn(x[3], c.w));
        } else {
          acc = __fmaf_rn(x[0], c.x, acc);
          acc = __fmaf_rn(x[1], c.y, acc);
          acc = __fmaf_rn(x[2], c.z, acc);
          acc = __fmaf_rn(x[3], c.w, acc);
        }
      }
    }
  }
  if (i < n) out[i] = si == spill ? 0.f : acc;
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

// v (rows, dim) f32, 16-byte aligned, dim a multiple of 4; items: each
// cluster's row ids in ascending order in its range of off (n_seg + 1,)
// (falcon_groupby_order).  Writes sums (n_seg, dim).
int falcon_hashed_medoid_sums(const float* v, int dim, const int* items,
                              const int* off, int n_seg, float* sums,
                              void* stream) {
  if (n_seg <= 0 || dim <= 0) return (int)cudaGetLastError();
  if (dim & 3) return (int)cudaErrorInvalidValue;
  falcon::hashed_medoid_sums_kernel<<<(unsigned)n_seg,
                                      falcon::HM_SUM_THREADS, 0,
                                      (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(v), dim >> 2, items, off,
      reinterpret_cast<float4*>(sums));
  return (int)cudaGetLastError();
}

// v as above, dim >= 8; seg (n,) int32 in [0, spill], noise in spill;
// sums (spill, dim) from falcon_hashed_medoid_sums.  Writes out (n,).
int falcon_hashed_medoid_dot(const float* v, int dim, const int* seg, int n,
                             int spill, const float* sums, float* out,
                             void* stream) {
  if (n <= 0 || dim <= 0) return (int)cudaGetLastError();
  if ((dim & 3) || dim < 8) return (int)cudaErrorInvalidValue;
  const int per_block = falcon::HM_DOT_WARPS * 32;
  falcon::hashed_medoid_dot_kernel<<<(unsigned)((n + per_block - 1) /
                                                per_block),
                                     per_block, 0, (cudaStream_t)stream>>>(
      v, dim, seg, n, spill, sums, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
