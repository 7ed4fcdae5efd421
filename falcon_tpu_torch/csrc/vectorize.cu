// falcon_vectorize: binned, feature-hashed spectrum vectors, with a plain C
// interface for ctypes (falcon_tpu_torch/ops/_build.py).  It launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// Replaces the XLA scatter-adds of falcon_tpu/ops/vectorize.py
// (vectorize_body and _vectorize_spread): peak p of a spectrum falls in bin
// b = floor((mz - min_bound) / bin_size) (float32), and with spread also in
// b - 1 and b + 1; each bin in [0, n_bins) whose peak has intensity > 0 adds
// the intensity to dimension mapping[bin] of the spectrum's vector; norm
// divides the vector by max(||v||, 1e-12).  An atomic scatter adds in no
// fixed order, so its vectors differ in the last bit from run to run.
//
// Design: one warp per spectrum.  The warp lists its hits in the plain
// version's order (shift -1, 0, +1, each in peak order; a ballot keeps the
// order and drops misses), then every lane walks the list and adds the hits
// on the dimensions it owns (d % 32 == lane) to the row it holds in shared
// memory.  Each dimension is summed by one lane in the plain version's
// order, and the norm's squares are summed in the plain version's halving
// tree, with no contracted multiply-add, so kernel and plain version agree
// bit for bit and two launches agree.  Bound: bytes, 512 read per spectrum
// and 4 per dimension written; the hit walk is a few hundred instructions
// per warp.

#include <cuda_runtime.h>

namespace falcon {

constexpr int VEC_PEAKS = 64;
constexpr int VEC_HITS = 3 * VEC_PEAKS;  // at most three bins per peak
constexpr int VEC_WARPS = 4;

// Shared memory per warp: the row, the squares' tree, the hit list.
__host__ __device__ inline size_t vec_warp_bytes(int dim) {
  return (size_t)2 * dim * sizeof(float) + (size_t)VEC_HITS * 8;
}

__global__ void vectorize_kernel(
    const float* __restrict__ mz, const float* __restrict__ intensity, int n,
    const long long* __restrict__ mapping, int n_bins, float min_bound,
    float bin_size, int dim, int spread, int norm, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n) return;  // warps are independent: no block barrier below
  char* base = (char*)smem + warp * vec_warp_bytes(dim);
  float* acc = (float*)base;
  float* sq = acc + dim;
  int* hit_dim = (int*)(sq + dim);
  float* hit_w = (float*)(hit_dim + VEC_HITS);

  for (int d = lane; d < dim; d += 32) acc[d] = 0.f;
  long long bin[2];
  float w[2];
  for (int h = 0; h < 2; ++h) {
    const size_t p = (size_t)row * VEC_PEAKS + lane + 32 * h;
    w[h] = intensity[p];
    bin[h] = (long long)floorf(
        __fdiv_rn(__fsub_rn(mz[p], min_bound), bin_size));
  }
  int count = 0;
  for (int s = spread ? -1 : 0; s <= (spread ? 1 : 0); ++s) {
    for (int h = 0; h < 2; ++h) {
      const long long b = bin[h] + s;
      const bool hit = w[h] > 0.f && b >= 0 && b < n_bins;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int slot = count + __popc(ballot & ((1u << lane) - 1u));
        hit_dim[slot] = (int)mapping[b];
        hit_w[slot] = w[h];
      }
      count += __popc(ballot);
    }
  }
  __syncwarp();
  for (int e = 0; e < count; ++e) {
    const int d = hit_dim[e];
    if ((d & 31) == lane) acc[d] = __fadd_rn(acc[d], hit_w[e]);
  }
  float* o = out + (size_t)row * dim;
  if (!norm) {
    for (int d = lane; d < dim; d += 32) o[d] = acc[d];
    return;
  }
  for (int d = lane; d < dim; d += 32) sq[d] = __fmul_rn(acc[d], acc[d]);
  __syncwarp();
  // The plain version's halving tree: pad an odd length with a zero, then
  // add the upper half onto the lower.
  for (int len = dim; len > 1;) {
    if (len & 1) {
      if (lane == 0) sq[len] = 0.f;
      ++len;
      __syncwarp();
    }
    const int half = len >> 1;
    for (int d = lane; d < half; d += 32) sq[d] = __fadd_rn(sq[d], sq[d + half]);
    __syncwarp();
    len = half;
  }
  const float nrm = fmaxf(__fsqrt_rn(sq[0]), 1e-12f);
  for (int d = lane; d < dim; d += 32) o[d] = __fdiv_rn(acc[d], nrm);
}

}  // namespace falcon

extern "C" {

// Peaks (n, 64) f32 m/z and intensity, row-major; mapping (n_bins,) int64
// dimensions in [0, dim).  Writes out (n, dim) f32, every entry.
int falcon_vectorize(const float* mz, const float* intensity, int n,
                     const long long* mapping, int n_bins, float min_bound,
                     float bin_size, int dim, int spread, int norm,
                     float* out, void* stream) {
  if (n <= 0 || dim <= 0) return (int)cudaGetLastError();
  int warps = falcon::VEC_WARPS;
  while (warps > 1 && warps * falcon::vec_warp_bytes(dim) > 48 * 1024) {
    warps >>= 1;
  }
  const size_t bytes = warps * falcon::vec_warp_bytes(dim);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        falcon::vectorize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  falcon::vectorize_kernel<<<blocks, warps * 32, bytes,
                             (cudaStream_t)stream>>>(
      mz, intensity, n, mapping, n_bins, min_bound, bin_size, dim, spread,
      norm, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
