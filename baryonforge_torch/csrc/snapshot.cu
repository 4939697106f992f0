// K17: the snapshot displacement (BaryonifySnapshot).
//
// Replaces make_run / one_halo / body of
// baryonforge_tpu/Runners/SnapshotRunner.py:175-227. For every (halo,
// particle) pair of the neighbour search, grouped per halo (CSR), with T
// the offsets' type and the JAX x64 promotions written out:
//   dx_c = p_c - h_c in float64, minus L where > L/2, plus L where < -L/2
//     (one wrap, :179-182); d = |dx| in float64 (x, y, z summed in order);
//   r = T(d > 0 ? d : 1e-30) * rscale_h in T, and the halo's curve read at
//     r by BaryonificationClass.curve_lookup in T (x = (log max(r, 1e-30) -
//     ln_r0) / dlnr with ln_r0 and dlnr rounded to T, the bracket floor(x)
//     clamped to [0, n_r - 2], the lerp c_i (1 - t) + c_{i+1} t, zero where
//     x < 0 or x > n_r - 1; BaryonCorrection.py:303-318);
//   off = that value where T(d) < eps_edge_h (:192), zeroed where not
//     finite (:198);
//   vec_c = off * T(dx_c / d_safe), d_safe = d > 0 ? d : 1 (:199), added
//     atomically into acc[c, particle] ((ndim, n_part) in T).
// The JAX version pads each count bucket's halos to its largest count,
// scans halo batches and scatters one component at a time into a flat
// accumulator with a dummy row; the counts are exact, so none of that
// changes a sum, and none of it is here.
//
// Bound: bytes. A pair reads a particle index and the particle's position
// (float64, 16 or 24 bytes, gathered) and adds ndim values atomically into
// an accumulator that fits in L2 (12 MB at 10^6 particles in float32);
// ~40 operations a pair, a third of them float64. Design: one block per
// halo with pairs, its curve staged in shared memory, the threads striding
// over its pair range; compiled with --fmad=false, as the plain version
// computes each product and sum as its own rounded operation. Sums by
// atomics change order from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T bf_log(T x);
template <>
__device__ __forceinline__ float bf_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double bf_log<double>(double x) { return log(x); }

template <typename T>
__global__ void snapshot_kernel(int ndim, int n_part, double L,
                                const double* __restrict__ coords,
                                const double* __restrict__ hpos,
                                const int* __restrict__ halos,
                                const int* __restrict__ offsets,
                                const int* __restrict__ parts,
                                const T* __restrict__ curves, int n_r,
                                T ln_r0, T dlnr, const T* __restrict__ rscale,
                                const T* __restrict__ eps_edge,
                                T* __restrict__ acc) {
  extern __shared__ unsigned char smem_raw[];
  T* curve = reinterpret_cast<T*>(smem_raw);
  const int h = halos[blockIdx.x];
  for (int i = threadIdx.x; i < n_r; i += blockDim.x)
    curve[i] = curves[(long long)h * n_r + i];
  double hp[3] = {0.0, 0.0, 0.0};
  for (int c = 0; c < ndim; ++c) hp[c] = hpos[h * ndim + c];
  const T rs = rscale[h], edge = eps_edge[h];
  __syncthreads();

  const double half = L / 2;
  const int k1 = offsets[blockIdx.x + 1];
  for (int k = offsets[blockIdx.x] + threadIdx.x; k < k1; k += blockDim.x) {
    const int p = parts[k];
    double dx[3] = {0.0, 0.0, 0.0};
    double d2 = 0.0;
    for (int c = 0; c < ndim; ++c) {
      double v = coords[(long long)p * ndim + c] - hp[c];
      if (v > half) v -= L;
      if (v < -half) v += L;
      dx[c] = v;
      d2 = d2 + v * v;
    }
    const double d = sqrt(d2);
    const double d_safe = d > 0.0 ? d : 1.0;
    const T r = T(d > 0.0 ? d : 1e-30) * rs;
    const T x = (bf_log<T>(r > T(1e-30) ? r : T(1e-30)) - ln_r0) / dlnr;
    const T xf = floor(x);
    const int i = xf < T(0) ? 0 : (xf > T(n_r - 2) ? n_r - 2 : int(xf));
    const T t = x - T(i);
    T off = curve[i] * (T(1) - t) + curve[i + 1] * t;
    if (x < T(0) || x > T(n_r - 1)) off = T(0);
    if (!(T(d) < edge)) off = T(0);
    if (!isfinite(off)) off = T(0);
    for (int c = 0; c < ndim; ++c)
      atomicAdd(acc + (long long)c * n_part + p, off * T(dx[c] / d_safe));
  }
}

template <typename T>
int launch(int ndim, int n_part, int n_rows, double L, const double* coords,
           const double* hpos, const int* halos, const int* offsets,
           const int* parts, const T* curves, int n_r, double ln_r0,
           double dlnr, const T* rscale, const T* eps_edge, T* acc,
           void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const size_t smem = sizeof(T) * size_t(n_r);
  snapshot_kernel<T><<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      ndim, n_part, L, coords, hpos, halos, offsets, parts, curves, n_r,
      T(ln_r0), T(dlnr), rscale, eps_edge, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BF_SNAPSHOT(T, SUF)                                                  \
  int bf_snapshot_displace_##SUF(                                            \
      int ndim, int n_part, int n_rows, double L, const double* coords,      \
      const double* hpos, const int* halos, const int* offsets,              \
      const int* parts, const T* curves, int n_r, double ln_r0, double dlnr, \
      const T* rscale, const T* eps_edge, T* acc, void* stream) {            \
    return launch<T>(ndim, n_part, n_rows, L, coords, hpos, halos, offsets,  \
                     parts, curves, n_r, ln_r0, dlnr, rscale, eps_edge, acc, \
                     stream);                                                \
  }

BF_SNAPSHOT(float, f32)
BF_SNAPSHOT(double, f64)
#undef BF_SNAPSHOT

}  // extern "C"
