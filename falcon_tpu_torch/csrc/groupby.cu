// The fixed-order group-by's steps as kernels with a plain C interface for
// ctypes (falcon_tpu_torch/ops/groupby.py); csrc/groupby.cuh says how it
// works.  Each entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() of its
// launches.
//
// falcon_groupby_count and falcon_groupby_fill are steps 1 and 3 of the
// medoid scores (B.1, fill only) and of the consensus table (B.3).
// falcon_groupby_order is step 4 by position on its own (the long groups'
// launch, then a warp per 32 groups for the rest), for the routine's
// standalone wrapper ops/groupby.py::group_by.  Bound: bytes, each item's
// group read twice and its position written and read back.

#include "groupby.cuh"

namespace falcon {

constexpr int GB_WARPS = 8;
constexpr int GB_WARP_CAP = 1024;  // the by-position warp tier, 4 KB a warp

__global__ void groupby_count_kernel(const int* __restrict__ key, int n,
                                     int shift, int n_groups,
                                     int* __restrict__ cnt1) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int g = key[i] >> shift;
    if (g >= 0 && g < n_groups) atomicAdd(&cnt1[g + 1], 1);
  }
}

__global__ void groupby_fill_kernel(const int* __restrict__ key, int n,
                                    int shift, int n_groups,
                                    const int* __restrict__ off,
                                    int* __restrict__ cnt1,
                                    int* __restrict__ items) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int g = key[i] >> shift;
    if (g >= 0 && g < n_groups) {
      items[off[g] + atomicSub(&cnt1[g + 1], 1) - 1] = i;
    }
  }
}

__global__ void __launch_bounds__(GB_WARPS * 32) groupby_order_kernel(
    const int* __restrict__ off, int n_groups, int* items) {
  __shared__ int buf[GB_WARPS][GB_WARP_CAP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = (blockIdx.x * GB_WARPS + warp) * 32;
  if (g0 >= n_groups) return;  // the whole warp
  const int g = g0 + lane;
  const int beg = g < n_groups ? off[g] : 0;
  const int len = g < n_groups ? off[g + 1] - beg : 0;
  order_tiers<GB_WARP_CAP>(items, beg, len, ByPosition(), buf[warp], lane);
}

unsigned item_blocks(int n) {
  const int blocks = (n + 255) / 256;
  return (unsigned)(blocks < 4096 ? blocks : 4096);
}

}  // namespace falcon

extern "C" {

// key (n,) int32; group = key >> shift, kept when in [0, n_groups).
// Adds each kept item to cnt1[group + 1] (n_groups + 1, zeroed by the
// caller, so that its cumsum is off).
int falcon_groupby_count(const int* key, int n, int shift, int n_groups,
                         int* cnt1, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  falcon::groupby_count_kernel<<<falcon::item_blocks(n), 256, 0,
                                 (cudaStream_t)stream>>>(key, n, shift,
                                                         n_groups, cnt1);
  return (int)cudaGetLastError();
}

// off (n_groups + 1,) = cumsum(cnt1); writes each kept item's position
// into items[off[group] ..] in no fixed order, taking cnt1 back to zero.
int falcon_groupby_fill(const int* key, int n, int shift, int n_groups,
                        const int* off, int* cnt1, int* items, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  falcon::groupby_fill_kernel<<<falcon::item_blocks(n), 256, 0,
                                (cudaStream_t)stream>>>(
      key, n, shift, n_groups, off, cnt1, items);
  return (int)cudaGetLastError();
}

// Orders every group of items by position, in place.
int falcon_groupby_order(const int* off, int n_groups, int* items,
                         void* stream) {
  if (n_groups <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = falcon::launch_order_long(
      off, n_groups, items, falcon::GB_WARP_CAP, falcon::ByPosition(), s);
  if (err != cudaSuccess) return (int)err;
  const int per_block = falcon::GB_WARPS * 32;
  falcon::groupby_order_kernel<<<(n_groups + per_block - 1) / per_block,
                                 per_block, 0, s>>>(off, n_groups, items);
  return (int)cudaGetLastError();
}

}  // extern "C"
