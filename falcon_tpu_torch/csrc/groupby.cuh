// A fixed-order group-by on the card, shared by the medoid-score kernels
// (csrc/medoids.cu), the consensus kernels (csrc/consensus.cu) and the
// plain C entry points of csrc/groupby.cu.
//
// Given dense int32 group ids (key >> shift, in [0, n_groups); anything
// else is a sink and is dropped), it fills off (n_groups + 1) and items
// (the items' original positions), each group's items in the order an
// Order policy defines; by position, that is exactly what a stable sort by
// group id gives.  The float sums that the consumers take over a group then
// run in that order, whatever order the atomics below landed in.
//
//   1. count: atomicAdd on int32 counts (exact in any order), one item a
//      thread (groupby_count_kernel; the medoid weights kernel counts its
//      targets itself);
//   2. scan: torch.cumsum of the counts in the wrapper gives off;
//   3. fill: each item claims a slot of its group with an atomic on the
//      group's count (consumed back to 0) and stores its position there;
//   4. order, by the group's length:
//      - up to GB_SMALL items: one thread's insertion sort (sort_small);
//      - up to the consumer's warp capacity: one warp's bitonic sort in
//        shared memory (sort_warp);
//      - longer groups (a hub target, a bin shared by a large cluster):
//        order_long_kernel, a launch of its own before the consumer, one
//        block per long group sorting it in place in global memory.
//      The first two run inside the consumer kernel (order_tiers), each
//      lane owning one group, just before the lane walks it.
//
// The bitonic sorts use the network in which every comparator puts the
// smaller value at its lower index (the first step of each merge compares
// a block's halves mirrored), so entries past a group's length behave as
// +infinity and never move: sort_warp pads with Order::top(), sort_block
// skips every comparator whose upper index is past the length.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace falcon {

constexpr unsigned GB_FULL = 0xffffffffu;
constexpr int GB_SMALL = 16;         // insertion sort by one thread
constexpr int GB_LONG_THREADS = 512;  // order_long_kernel's block

// Items ordered by their original position.
struct ByPosition {
  using T = int;
  __device__ T at(int pos) const { return pos; }
  __device__ static T top() { return INT_MAX; }
  __device__ static bool less(T a, T b) { return a < b; }
  __device__ static int pos(T a) { return a; }
};

// The c-th comparator (a < b) of one step of the network: the mirrored
// compare of blocks of k when flip, else the half-cleaner of distance j.
__device__ inline void bitonic_pair(int c, int k, int j, bool flip, int& a,
                                    int& b) {
  if (flip) {
    const int h = k >> 1, o = c & (h - 1);
    a = ((c - o) << 1) + o;
    b = ((c - o) << 1) + k - 1 - o;
  } else {
    const int o = c & (j - 1);
    a = ((c - o) << 1) + o;
    b = a + j;
  }
}

__device__ inline int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// One thread: the entries of items[0 .. len) into a[0 .. len) in order,
// len <= GB_SMALL.
template <class Order>
__device__ void sort_small_into(typename Order::T* a, const int* items,
                                int len, const Order& ord) {
  for (int i = 0; i < len; ++i) {
    const typename Order::T x = ord.at(items[i]);
    int j = i;
    for (; j > 0 && Order::less(x, a[j - 1]); --j) a[j] = a[j - 1];
    a[j] = x;
  }
}

// One thread: items[0 .. len) in order, len <= GB_SMALL.
template <class Order>
__device__ void sort_small(int* items, int len, const Order& ord) {
  typename Order::T a[GB_SMALL];
  sort_small_into(a, items, len, ord);
  for (int i = 0; i < len; ++i) items[i] = Order::pos(a[i]);
}

// One warp, all lanes: items[0 .. len) in order through buf, which holds
// at least pow2_at_least(len) entries.
template <class Order>
__device__ void sort_warp(int* items, int len, const Order& ord,
                          typename Order::T* buf, int lane) {
  using T = typename Order::T;
  const int p = pow2_at_least(len);
  for (int i = lane; i < p; i += 32) {
    buf[i] = i < len ? ord.at(items[i]) : Order::top();
  }
  __syncwarp();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = lane; c < (p >> 1); c += 32) {
        int a, b;
        bitonic_pair(c, k, j, j == (k >> 1), a, b);
        const T x = buf[a], y = buf[b];
        if (Order::less(y, x)) {
          buf[a] = y;
          buf[b] = x;
        }
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < len; i += 32) items[i] = Order::pos(buf[i]);
  __syncwarp();
}

// One block, all threads: items[0 .. len) in order, in place.
template <class Order>
__device__ void sort_block(int* items, int len, const Order& ord) {
  const int p = pow2_at_least(len);
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = threadIdx.x; c < (p >> 1); c += blockDim.x) {
        int a, b;
        bitonic_pair(c, k, j, j == (k >> 1), a, b);
        if (b >= len) continue;  // +infinity there: nothing moves
        const int x = items[a], y = items[b];
        if (Order::less(ord.at(y), ord.at(x))) {
          items[a] = y;
          items[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Step 4's long groups: one thread a group finds those longer than
// min_len; the block then sorts each of them in turn.
template <class Order>
__global__ void __launch_bounds__(GB_LONG_THREADS) order_long_kernel(
    const int* __restrict__ off, int n_groups, int* items, int min_len,
    Order ord) {
  __shared__ int list[GB_LONG_THREADS];
  __shared__ int n_list;
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_groups && off[g + 1] - off[g] > min_len) {
    list[atomicAdd(&n_list, 1)] = g;
  }
  __syncthreads();
  for (int t = 0; t < n_list; ++t) {
    const int h = list[t];
    sort_block(items + off[h], off[h + 1] - off[h], ord);
  }
}

template <class Order>
cudaError_t launch_order_long(const int* off, int n_groups, int* items,
                              int min_len, Order ord, cudaStream_t stream) {
  if (n_groups <= 0) return cudaGetLastError();
  const unsigned blocks =
      (unsigned)((n_groups + GB_LONG_THREADS - 1) / GB_LONG_THREADS);
  order_long_kernel<Order><<<blocks, GB_LONG_THREADS, 0, stream>>>(
      off, n_groups, items, min_len, ord);
  return cudaGetLastError();
}

// Step 4's short groups, inside a consumer kernel: each lane owns the
// group items[beg .. beg + len) (len 0 for none); groups of up to
// GB_SMALL items are sorted by their lane, those of up to cap items by the
// whole warp in buf (cap entries, a power of two), one after another.  All
// lanes of the warp call it; a lane that orders its short group itself
// (sort_small_into) passes len 0.
template <int cap, class Order>
__device__ void order_tiers(int* items, int beg, int len, const Order& ord,
                            typename Order::T* buf, int lane) {
  if (len > 1 && len <= GB_SMALL) sort_small(items + beg, len, ord);
  for (unsigned todo = __ballot_sync(GB_FULL, len > GB_SMALL && len <= cap);
       todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int b = __shfl_sync(GB_FULL, beg, src);
    const int l = __shfl_sync(GB_FULL, len, src);
    sort_warp(items + b, l, ord, buf, lane);
  }
  __syncwarp();
}

}  // namespace falcon
