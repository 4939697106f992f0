// K17: the snapshot displacement (BaryonifySnapshot).
//
// Replaces make_run / one_halo / body of
// baryonforge_tpu/Runners/SnapshotRunner.py:175-227. For every (halo,
// particle) pair of the neighbour search, with T the offsets' type and the
// JAX x64 promotions written out:
//   dx_c = p_c - h_c in float64, minus L where > L/2, plus L where < -L/2
//     (one wrap, :179-182); d = |dx| in float64 (x, y, z summed in order);
//   r = T(d > 0 ? d : 1e-30) * rscale_h in T, and the halo's curve read at
//     r by BaryonificationClass.curve_lookup in T (x = (log max(r, 1e-30) -
//     ln_r0) / dlnr with ln_r0 and dlnr rounded to T, the bracket floor(x)
//     clamped to [0, n_r - 2], the lerp c_i (1 - t) + c_{i+1} t, zero where
//     x < 0 or x > n_r - 1; BaryonCorrection.py:303-318);
//   off = that value where T(d) < eps_edge_h (:192), zeroed where not
//     finite (:198);
//   vec_c = off * T(dx_c / d_safe), d_safe = d > 0 ? d : 1 (:199), summed
//     per particle into acc[c, particle] ((ndim, n_part) in T).
// The JAX version pads each count bucket's halos to its largest count,
// scans halo batches and scatters one component at a time into a flat
// accumulator with a dummy row; the counts are exact, so none of that
// changes a sum, and none of it is here.
//
// Bound: bytes. A pair reads its row index, and a particle its position
// (float64) once and writes its ndim offsets once; the per-row records
// (20,000 of 32 or 48 bytes at the bench) and the curves (3.8 MB in
// float32) stay in L2. ~40 operations a pair, a third of them float64.
// Design: a gather, no atomics. The pairs come particle-major
// (ops.snapshot.particle_major_plain, built once per pair set): the
// particles in a space-filling order (`order`, so that a warp's particles
// share their halos in L1), each particle's halo-major rows prow[poff[s]
// .. poff[s + 1]) in ascending order. One thread a particle walks its rows
// in that order, reads each row's packed record (position, rscale,
// eps_edge: one aligned slot, built by the wrapper per call) and the
// curve's two bracketing entries from global memory, sums in registers and
// writes each component once. The sum runs in the halo-major order, the
// order of a sequential index_add_ over the halo-major pairs, the same in
// every launch. Compiled with --fmad=false, as the plain version computes
// each product and sum as its own rounded operation.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// a row's record: the halo's position in float64 (the third entry unused
// in 2D), then rscale and eps_edge in T (ops.snapshot._records builds it)
template <typename T>
struct alignas(16) Record;
template <>
struct alignas(16) Record<float> {
  double pos[3];
  float rscale, edge;
};
template <>
struct alignas(16) Record<double> {
  double pos[3];
  double rscale, edge, unused;
};
static_assert(sizeof(Record<float>) == 32, "one 32-byte sector a record");
static_assert(sizeof(Record<double>) == 48, "three 16-byte loads a record");

template <typename T>
__device__ __forceinline__ T bf_log(T x);
template <>
__device__ __forceinline__ float bf_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double bf_log<double>(double x) { return log(x); }

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads)
snapshot_gather_kernel(int n_part, double L, const double* __restrict__ coords,
                       const int* __restrict__ order,
                       const int* __restrict__ poff,
                       const int* __restrict__ prow,
                       const int* __restrict__ halos,
                       const Record<T>* __restrict__ rec,
                       const T* __restrict__ curves, int n_r, T ln_r0, T dlnr,
                       T* __restrict__ acc) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_part) return;
  const int p = order[s];
  double pp[NDIM];
  for (int c = 0; c < NDIM; ++c) pp[c] = coords[(long long)p * NDIM + c];
  T sum[NDIM];
  for (int c = 0; c < NDIM; ++c) sum[c] = T(0);
  const double half = L / 2;
  const int k1 = poff[s + 1];
  for (int k = poff[s]; k < k1; ++k) {
    const int r = prow[k];
    const Record<T> h = rec[r];
    const T* curve = curves + (long long)halos[r] * n_r;
    double dx[NDIM];
    double d2 = 0.0;
    for (int c = 0; c < NDIM; ++c) {
      double v = pp[c] - h.pos[c];
      if (v > half) v -= L;
      if (v < -half) v += L;
      dx[c] = v;
      d2 = d2 + v * v;
    }
    const double d = sqrt(d2);
    const double d_safe = d > 0.0 ? d : 1.0;
    const T rr = T(d > 0.0 ? d : 1e-30) * h.rscale;
    const T x = (bf_log<T>(rr > T(1e-30) ? rr : T(1e-30)) - ln_r0) / dlnr;
    const T xf = floor(x);
    const int i = xf < T(0) ? 0 : (xf > T(n_r - 2) ? n_r - 2 : int(xf));
    const T t = x - T(i);
    T off = curve[i] * (T(1) - t) + curve[i + 1] * t;
    if (x < T(0) || x > T(n_r - 1)) off = T(0);
    if (!(T(d) < h.edge)) off = T(0);
    if (!isfinite(off)) off = T(0);
    for (int c = 0; c < NDIM; ++c) sum[c] = sum[c] + off * T(dx[c] / d_safe);
  }
  for (int c = 0; c < NDIM; ++c) acc[(long long)c * n_part + p] = sum[c];
}

template <typename T>
int launch(int ndim, int n_part, double L, const double* coords,
           const int* order, const int* poff, const int* prow,
           const int* halos, const void* rec, const T* curves, int n_r,
           double ln_r0, double dlnr, T* acc, void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n_part == 0) return 0;
  const int blocks = (n_part + kThreads - 1) / kThreads;
  const Record<T>* r = static_cast<const Record<T>*>(rec);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    snapshot_gather_kernel<T, 3><<<blocks, kThreads, 0, s>>>(
        n_part, L, coords, order, poff, prow, halos, r, curves, n_r,
        T(ln_r0), T(dlnr), acc);
  else
    snapshot_gather_kernel<T, 2><<<blocks, kThreads, 0, s>>>(
        n_part, L, coords, order, poff, prow, halos, r, curves, n_r,
        T(ln_r0), T(dlnr), acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// coords (n_part, ndim) float64; order (n_part,), poff (n_part + 1,), prow
// (P,) the particle-major layout; halos (R,) each halo-major row's halo;
// rec (R,) the rows' records; curves (n_halos, n_r) in T; acc (ndim,
// n_part) in T, every entry written
#define BF_SNAPSHOT(T, SUF)                                                  \
  int bf_snapshot_displace_##SUF(                                            \
      int ndim, int n_part, double L, const double* coords, const int* order, \
      const int* poff, const int* prow, const int* halos, const void* rec,   \
      const T* curves, int n_r, double ln_r0, double dlnr, T* acc,           \
      void* stream) {                                                        \
    return launch<T>(ndim, n_part, L, coords, order, poff, prow, halos, rec, \
                     curves, n_r, ln_r0, dlnr, acc, stream);                 \
  }

BF_SNAPSHOT(float, f32)
BF_SNAPSHOT(double, f64)
#undef BF_SNAPSHOT

int bf_snapshot_record_bytes(int f64) {
  return f64 ? int(sizeof(Record<double>)) : int(sizeof(Record<float>));
}

}  // extern "C"
