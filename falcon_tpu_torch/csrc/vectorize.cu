// falcon_vectorize: binned, feature-hashed spectrum vectors, with a plain C
// interface for ctypes (falcon_tpu_torch/ops/_build.py).  It launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// Replaces the XLA scatter-adds of falcon_tpu/ops/vectorize.py
// (vectorize_body and _vectorize_spread): peak p of a spectrum falls in bin
// b = floor((mz - min_bound) * inv_bin) (float32; XLA turns the JAX
// package's division by the constant bin size into this product with its
// float32 reciprocal inv_bin = 1 / bin_size), and with spread also in
// b - 1 and b + 1; each bin in [0, n_bins) whose peak has intensity > 0 adds
// the intensity to dimension mapping[bin] of the spectrum's vector; norm
// divides the vector by max(||v||, 1e-12).  An atomic scatter adds in no
// fixed order, so its vectors differ in the last bit from run to run.
//
// Bound: bytes.  512 bytes of peaks are read per spectrum and 4 bytes per
// dimension written per output (two outputs in the fused plain + spread
// call); the arithmetic is a few hundred instructions per spectrum.
//
// Design: one warp per spectrum, lane l holding peaks l and l + 32.
// - Each lane computes its two bins and loads the table entries of b - 1,
//   b and b + 1 at once, before any summing, so the six lookups overlap.
// - The hits are added in the plain version's order: shift -1, 0, +1, each
//   in peak order.  One round is one (shift, half) pair, 32 hits at most, in
//   lane order; lanes whose hits share a dimension are grouped with
//   __match_any_sync and add one after another, lowest lane first, while
//   hits on distinct dimensions add at once.  So every dimension is summed
//   in the plain version's order, and the kernel agrees with it, and with
//   itself, bit for bit.
// - The fused call writes the plain row (shift 0 only) and the spread row
//   from one read of the peaks: the plain row takes the shift-0 rounds'
//   hits in the same order.
// - Rows are staged in shared memory and written with 16-byte stores; a
//   row with no positive intensity (padding) is written as zeros without
//   the hit machinery.  Blocks hold 8 warps (fewer when a wide row needs
//   more than 48 KB of shared memory per block).
// - The norm's squares are summed in the plain version's halving tree,
//   with no contracted multiply-add.

#include <cuda_runtime.h>

namespace falcon {

constexpr int VEC_PEAKS = 64;
constexpr int VEC_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory per warp: one staged row per output, and the squares'
// tree when the rows are normalised.
__host__ __device__ inline size_t vec_warp_bytes(int dim, int n_out,
                                                 int norm) {
  return (size_t)(n_out + (norm ? 1 : 0)) * dim * sizeof(float);
}

// Writes row `acc` (or zeros when acc is null) to `o`, divided by its
// norm when `norm`; `sq` is the warp's scratch for the halving tree.
__device__ inline void write_row(const float* acc, float* sq, int dim,
                                 int norm, int lane, float* o) {
  float4* o4 = reinterpret_cast<float4*>(o);
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  const int n4 = dim >> 2;
  if (acc == nullptr) {
    for (int q = lane; q < n4; q += 32) o4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  if (!norm) {
    for (int q = lane; q < n4; q += 32) o4[q] = a4[q];
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
  __syncwarp();
  for (int q = lane; q < n4; q += 32) {
    const float4 a = a4[q];
    o4[q] = make_float4(__fdiv_rn(a.x, nrm), __fdiv_rn(a.y, nrm),
                        __fdiv_rn(a.z, nrm), __fdiv_rn(a.w, nrm));
  }
}

__global__ void __launch_bounds__(VEC_WARPS * 32) vectorize_kernel(
    const float* __restrict__ mz, const float* __restrict__ intensity, int n,
    const long long* __restrict__ mapping, int n_bins, float min_bound,
    float inv_bin, int dim, int norm, float* __restrict__ out_plain,
    float* __restrict__ out_spread) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;  // warps are independent: no block barrier below
  const bool plain = out_plain != nullptr;
  const bool spread = out_spread != nullptr;
  const int n_out = (plain ? 1 : 0) + (spread ? 1 : 0);
  float* base = reinterpret_cast<float*>(smem4) +
                (size_t)warp * (n_out + (norm ? 1 : 0)) * dim;
  float* acc_p = plain ? base : nullptr;
  float* acc_s = spread ? base + (plain ? dim : 0) : nullptr;
  float* sq = base + (size_t)n_out * dim;
  const size_t out_off = (size_t)row * dim;

  float w[2];
  long long bin[2];
  for (int h = 0; h < 2; ++h) {
    const size_t p = (size_t)row * VEC_PEAKS + lane + 32 * h;
    w[h] = intensity[p];
    bin[h] = (long long)floorf(
        __fmul_rn(__fsub_rn(mz[p], min_bound), inv_bin));
  }
  if (__ballot_sync(FULL, w[0] > 0.f || w[1] > 0.f) == 0u) {
    if (plain) write_row(nullptr, sq, dim, norm, lane, out_plain + out_off);
    if (spread) write_row(nullptr, sq, dim, norm, lane, out_spread + out_off);
    return;
  }
  // Table entries of b - 1, b and b + 1 of both peaks, all requested before
  // any is used; -1 marks no hit.
  int hit_dim[2][3];
  for (int h = 0; h < 2; ++h) {
    for (int s = -1; s <= 1; ++s) {
      const long long b = bin[h] + s;
      const bool hit = w[h] > 0.f && b >= 0 && b < n_bins && (spread || s == 0);
      hit_dim[h][s + 1] = hit ? (int)__ldg(mapping + b) : -1;
    }
  }
  const int n4 = dim >> 2;
  float4* zero = reinterpret_cast<float4*>(base);
  for (int q = lane; q < n_out * n4; q += 32) {
    zero[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  for (int s = spread ? -1 : 0; s <= (spread ? 1 : 0); ++s) {
    for (int h = 0; h < 2; ++h) {
      const int d = hit_dim[h][s + 1];
      const unsigned hits = __ballot_sync(FULL, d >= 0);
      if (hits == 0u) continue;
      // Rank among the round's earlier lanes on the same dimension.
      const unsigned peers = __match_any_sync(FULL, d) & hits;
      const int rank = __popc(peers & lower);
      const int last = __reduce_max_sync(FULL, d >= 0 ? rank : 0);
      for (int r = 0; r <= last; ++r) {
        if (d >= 0 && rank == r) {
          if (spread) acc_s[d] = __fadd_rn(acc_s[d], w[h]);
          if (plain && s == 0) acc_p[d] = __fadd_rn(acc_p[d], w[h]);
        }
        __syncwarp();
      }
    }
  }
  if (plain) write_row(acc_p, sq, dim, norm, lane, out_plain + out_off);
  if (spread) {
    __syncwarp();
    write_row(acc_s, sq, dim, norm, lane, out_spread + out_off);
  }
}

}  // namespace falcon

extern "C" {

// Peaks (n, 64) f32 m/z and intensity, row-major; mapping (n_bins,) int64
// dimensions in [0, dim); dim a multiple of 4.  Writes every entry of
// out_plain (n, dim) f32 (shift 0 only) and of out_spread (n, dim) f32
// (shifts -1, 0, +1); either may be null, not both.
int falcon_vectorize(const float* mz, const float* intensity, int n,
                     const long long* mapping, int n_bins, float min_bound,
                     float inv_bin, int dim, int norm, float* out_plain,
                     float* out_spread, void* stream) {
  if (n <= 0 || dim <= 0) return (int)cudaGetLastError();
  if ((dim & 3) || (out_plain == nullptr && out_spread == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_out = (out_plain ? 1 : 0) + (out_spread ? 1 : 0);
  int warps = falcon::VEC_WARPS;
  while (warps > 1 &&
         warps * falcon::vec_warp_bytes(dim, n_out, norm) > 48 * 1024) {
    warps >>= 1;
  }
  const size_t bytes = warps * falcon::vec_warp_bytes(dim, n_out, norm);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        falcon::vectorize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((n + warps - 1) / warps);
  falcon::vectorize_kernel<<<blocks, warps * 32, bytes,
                             (cudaStream_t)stream>>>(
      mz, intensity, n, mapping, n_bins, min_bound, inv_bin, dim, norm,
      out_plain, out_spread);
  return (int)cudaGetLastError();
}

}  // extern "C"
