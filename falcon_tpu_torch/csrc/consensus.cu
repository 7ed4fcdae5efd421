// The per-key sums of consensus spectra, with a plain C interface for
// ctypes (falcon_tpu_torch/ops/_build.py).  Each entry point launches on
// the given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launches.
//
// Replaces the XLA sort and scatter-adds of falcon_tpu/ops/consensus.py
// (_get_aggregate.aggregate, :34-67).  There the peaks of one charge are
// sorted by (cluster-bin key, member), and per key XLA adds up the
// intensities, the products m/z * intensity (each rounded to float32, no
// fused multiply-add) and the number of distinct members, one update after
// another in sorted order; its sort keeps ties in input order.  The
// weighted m/z sum is printed into the MGF, so its last bit is visible; an
// atomic scatter on the card adds in no fixed order.
//
// Design: keys are sparse (label * n_bins + bin, up to 2^31), so they are
// grouped in two levels, with no sort of the whole array.
//   1. The group-by of csrc/groupby.cuh puts the peaks into buckets of
//      high key bits (key >> shift, the wrapper's shift keeping the buckets
//      at most as many as the peaks): count, scan, fill.
//   2. Each bucket is ordered by (key, member, position), which is XLA's
//      stable order: buckets of more than CONS_WARP_CAP peaks by a launch of
//      their own in global memory, the rest inside falcon_consensus_walk
//      (one lane's insertion sort into its own array up to GB_SMALL peaks,
//      else the warp's bitonic sort in shared memory).  One lane per bucket
//      then walks its peaks in that order and takes each key's sums as the
//      reference does, writing them at the bucket's first slots, and counts
//      the bucket's keys.
//   3. falcon_consensus_compact copies each bucket's keys to their place in
//      key order, from the scan of those counts.
// Bound: bytes, 16 read per peak and 16 written per key.

#include <cuda_runtime.h>

#include "groupby.cuh"

namespace falcon {

constexpr int CONS_WARPS = 8;
constexpr int CONS_WARP_CAP = 256;  // the warp tier, 4 KB a warp

// Peaks ordered by (key, member, position); keys and members are
// non-negative int32, so (key << 31) | member orders the first two.
struct KeyMember {
  struct T {
    unsigned long long km;
    int pos;
  };
  const int* key;
  const int* member;
  __device__ T at(int p) const {
    return {((unsigned long long)(unsigned)key[p] << 31) | (unsigned)member[p],
            p};
  }
  __device__ static T top() { return {~0ull, INT_MAX}; }
  __device__ static bool less(const T& a, const T& b) {
    return a.km < b.km || (a.km == b.km && a.pos < b.pos);
  }
  __device__ static int pos(const T& a) { return a.pos; }
};

__global__ void __launch_bounds__(CONS_WARPS * 32) consensus_walk_kernel(
    const int* __restrict__ key, const int* __restrict__ member,
    const float* __restrict__ mz, const float* __restrict__ intensity,
    int* items, const int* __restrict__ off, int n_buckets,
    int* __restrict__ key_tmp, float* __restrict__ int_tmp,
    float* __restrict__ mzint_tmp, int* __restrict__ members_tmp,
    int* __restrict__ kcnt1) {
  __shared__ KeyMember::T buf[CONS_WARPS][CONS_WARP_CAP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = (blockIdx.x * CONS_WARPS + warp) * 32;
  if (b0 >= n_buckets) return;  // the whole warp
  const int b = b0 + lane;
  const int beg = b < n_buckets ? off[b] : 0;
  const int len = b < n_buckets ? off[b + 1] - beg : 0;
  const KeyMember ord{key, member};
  // A short bucket is ordered and walked in the lane's own array; longer
  // ones are ordered in items (here by the warp, or before by a block) and
  // walked from there.
  KeyMember::T small[GB_SMALL];
  if (len <= GB_SMALL) sort_small_into(small, items + beg, len, ord);
  order_tiers<CONS_WARP_CAP>(items, beg, len > GB_SMALL ? len : 0, ord,
                             buf[warp], lane);
  if (b >= n_buckets) return;
  const int end = beg + len;
  int r = beg, prev_key = 0, prev_member = 0, count = 0;
  float si = 0.f, sm = 0.f;
  for (int e = beg; e < end; ++e) {
    const KeyMember::T t =
        len <= GB_SMALL ? small[e - beg] : ord.at(items[e]);
    const int p = t.pos;
    const int kk = (int)(t.km >> 31), mm = (int)(t.km & 0x7fffffffu);
    if (e > beg && kk != prev_key) {
      key_tmp[r] = prev_key;
      int_tmp[r] = si;
      mzint_tmp[r] = sm;
      members_tmp[r] = count;
      ++r;
      si = sm = 0.f;
      count = 0;
    }
    if (e == beg || kk != prev_key || mm != prev_member) ++count;
    const float x = intensity[p];
    si = __fadd_rn(si, x);
    sm = __fadd_rn(sm, __fmul_rn(mz[p], x));
    prev_key = kk;
    prev_member = mm;
  }
  if (end > beg) {
    key_tmp[r] = prev_key;
    int_tmp[r] = si;
    mzint_tmp[r] = sm;
    members_tmp[r] = count;
    ++r;
  }
  kcnt1[b + 1] = r - beg;
  if (b == 0) kcnt1[0] = 0;
}

__global__ void consensus_compact_kernel(
    const int* __restrict__ off, const int* __restrict__ koff, int n_buckets,
    const int* __restrict__ key_tmp, const float* __restrict__ int_tmp,
    const float* __restrict__ mzint_tmp, const int* __restrict__ members_tmp,
    int* __restrict__ keys, float* __restrict__ int_sum,
    float* __restrict__ mzint_sum, int* __restrict__ members) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_buckets) return;
  const int src = off[b], dst = koff[b], n = koff[b + 1] - dst;
  for (int i = 0; i < n; ++i) {
    keys[dst + i] = key_tmp[src + i];
    int_sum[dst + i] = int_tmp[src + i];
    mzint_sum[dst + i] = mzint_tmp[src + i];
    members[dst + i] = members_tmp[src + i];
  }
}

}  // namespace falcon

extern "C" {

// key, member (n,) int32, mz, intensity (n,) f32; items (n,): each
// bucket's peak positions in its range of off (n_buckets + 1,), in any
// order (falcon_groupby_fill), ordered here in place.  Writes each
// bucket's per-key sums, in key order, at its first slots of the (n,)
// *_tmp arrays, and its key count at kcnt1[bucket + 1] (kcnt1[0] = 0).
int falcon_consensus_walk(const int* key, const int* member, const float* mz,
                          const float* intensity, int* items, const int* off,
                          int n_buckets, int* key_tmp, float* int_tmp,
                          float* mzint_tmp, int* members_tmp, int* kcnt1,
                          void* stream) {
  if (n_buckets <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = falcon::launch_order_long(
      off, n_buckets, items, falcon::CONS_WARP_CAP,
      falcon::KeyMember{key, member}, s);
  if (err != cudaSuccess) return (int)err;
  const int per_block = falcon::CONS_WARPS * 32;
  falcon::consensus_walk_kernel<<<(n_buckets + per_block - 1) / per_block,
                                  per_block, 0, s>>>(
      key, member, mz, intensity, items, off, n_buckets, key_tmp, int_tmp,
      mzint_tmp, members_tmp, kcnt1);
  return (int)cudaGetLastError();
}

// koff (n_buckets + 1,) = cumsum(kcnt1).  Writes keys_out, int_sum,
// mzint_sum, members: koff[n_buckets] entries, in key order.
int falcon_consensus_compact(const int* off, const int* koff, int n_buckets,
                             const int* key_tmp, const float* int_tmp,
                             const float* mzint_tmp, const int* members_tmp,
                             int* keys_out, float* int_sum, float* mzint_sum,
                             int* members, void* stream) {
  if (n_buckets <= 0) return (int)cudaGetLastError();
  falcon::consensus_compact_kernel<<<(n_buckets + 255) / 256, 256, 0,
                                     (cudaStream_t)stream>>>(
      off, koff, n_buckets, key_tmp, int_tmp, mzint_tmp, members_tmp,
      keys_out, int_sum, mzint_sum, members);
  return (int)cudaGetLastError();
}

}  // extern "C"
