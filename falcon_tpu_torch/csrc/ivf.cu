// falcon_ivf_probe_scan: the IVF index's probe scan, with a plain C
// interface for ctypes (falcon_tpu_torch/ops/_build.py).  It launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// Replaces the block gather and the einsum of _chunk_scan in
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

}  // extern "C"
