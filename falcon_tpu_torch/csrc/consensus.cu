// falcon_consensus_segments: the per-key sums of consensus spectra, with a
// plain C interface for ctypes (falcon_tpu_torch/ops/_build.py).  It
// launches on the given stream, does not synchronise, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// Replaces the XLA scatter-adds of falcon_tpu/ops/consensus.py
// (_get_aggregate.aggregate, :34-67).  There the peaks of one charge are
// sorted by (cluster-bin key, member), and per key XLA adds up the
// intensities, the products m/z * intensity (each rounded to float32, no
// fused multiply-add) and the number of distinct members, one update after
// another in sorted order.  The weighted m/z sum is printed into the MGF,
// so its last bit is visible; an atomic scatter on the card adds in no
// fixed order.
//
// Design: the wrapper (falcon_tpu_torch/ops/consensus.py) sorts stably
// (torch.sort: peaks of one member in one bin keep their input order) and
// finds where each key's run starts; here one thread per key walks its run
// in sorted order, as the plain version does.  Bound: bytes, 16 read per
// peak and 16 written per key.

#include <cuda_runtime.h>

namespace falcon {

__global__ void consensus_segments_kernel(
    const int* __restrict__ key, const int* __restrict__ member,
    const float* __restrict__ mz, const float* __restrict__ intensity,
    const long long* __restrict__ off, int n_keys,
    int* __restrict__ keys_out, float* __restrict__ int_sum,
    float* __restrict__ mzint_sum, int* __restrict__ members) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_keys) return;
  const long long beg = off[s], end = off[s + 1];
  float si = 0.f, sm = 0.f;
  int count = 0;
  for (long long e = beg; e < end; ++e) {
    const float x = intensity[e];
    si = __fadd_rn(si, x);
    sm = __fadd_rn(sm, __fmul_rn(mz[e], x));
    if (e == beg || member[e] != member[e - 1]) ++count;
  }
  keys_out[s] = key[beg];
  int_sum[s] = si;
  mzint_sum[s] = sm;
  members[s] = count;
}

}  // namespace falcon

extern "C" {

// key, member (n,) int32, mz, intensity (n,) f32, all sorted by (key,
// member); off (n_keys + 1,) int64: where each key's run starts, then n.
// Writes keys_out, int_sum, mzint_sum, members (n_keys,).
int falcon_consensus_segments(const int* key, const int* member,
                              const float* mz, const float* intensity,
                              const long long* off, int n_keys,
                              int* keys_out, float* int_sum,
                              float* mzint_sum, int* members, void* stream) {
  if (n_keys <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n_keys + 255) / 256);
  falcon::consensus_segments_kernel<<<blocks, 256, 0,
                                      (cudaStream_t)stream>>>(
      key, member, mz, intensity, off, n_keys, keys_out, int_sum, mzint_sum,
      members);
  return (int)cudaGetLastError();
}

}  // extern "C"
