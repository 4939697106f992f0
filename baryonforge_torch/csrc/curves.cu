// K1: per-halo curve collapse.
//
// Replaces baryonforge_tpu/ops/interp.py: collapse_curves (reached through
// Profiles/BaryonCorrection.py: halo_curves). Each halo's (ln 1/a, ln M)
// is located on the table's z and M axes (searchsorted side="right", minus
// one, clamped to [0, n-2]); the 4 corner rows of the (n_z, n_M, n_r)
// table are blended into one radial curve; halos outside the table get
// `fill`.
//
// Bound: device-memory bytes. Each output value reads 4 table values that
// sit in L2 (the table is 8x20x64, 40 KB in float32) and writes one value;
// the axis searches are a few dozen compares per thread. Design: one
// thread per (halo, radius), neighbouring threads on neighbouring radii, so
// both the table-row reads and the output writes coalesce.

#include "healpix.cuh"

namespace {

// number of axis values <= x (searchsorted side="right"), by bisection
template <typename T>
__device__ __forceinline__ int count_le(const T* ax, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ax[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ void locate(const T* ax, int n, T x, int& i, T& t,
                                       bool& oob) {
  i = bf::clampi(count_le(ax, n, x) - 1, 0, n - 2);
  t = (x - ax[i]) / (ax[i + 1] - ax[i]);
  oob = x < ax[0] || x > ax[n - 1];
}

template <typename T>
__global__ void collapse_curves_kernel(const T* __restrict__ table,
                                       const T* __restrict__ ax_z,
                                       const T* __restrict__ ax_M, int nz,
                                       int nM, int nr,
                                       const T* __restrict__ M,
                                       const T* __restrict__ a, int n_h,
                                       T fill, T* __restrict__ out) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_h * nr) return;
  int h = int(k / nr);
  int r = int(k % nr);
  int iz, iM;
  T tz, tM;
  bool oz, oM;
  locate(ax_z, nz, bf::m_log(T(1) / a[h]), iz, tz, oz);
  locate(ax_M, nM, bf::m_log(M[h]), iM, tM, oM);
  if (oz || oM) {
    out[k] = fill;
    return;
  }
  // corner order and weight products as collapse_curves: bit 0 is z
  const T* row = table + ((long long)iz * nM + iM) * nr + r;
  long long sz = (long long)nM * nr;
  T c = T(0);
  c = c + ((T(1) - tz) * (T(1) - tM)) * row[0];
  c = c + (tz * (T(1) - tM)) * row[sz];
  c = c + ((T(1) - tz) * tM) * row[nr];
  c = c + (tz * tM) * row[sz + nr];
  out[k] = c;
}

template <typename T>
int launch(const T* table, const T* ax_z, const T* ax_M, int nz, int nM,
           int nr, const T* M, const T* a, int n_h, T fill, T* out,
           void* stream) {
  const int threads = 256;
  long long total = (long long)n_h * nr;
  int blocks = int((total + threads - 1) / threads);
  collapse_curves_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, ax_z, ax_M, nz, nM, nr, M, a, n_h, fill, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int bf_collapse_curves_f32(const float* table, const float* ax_z,
                           const float* ax_M, int nz, int nM, int nr,
                           const float* M, const float* a, int n_h,
                           float fill, float* out, void* stream) {
  return launch<float>(table, ax_z, ax_M, nz, nM, nr, M, a, n_h, fill, out,
                       stream);
}

int bf_collapse_curves_f64(const double* table, const double* ax_z,
                           const double* ax_M, int nz, int nM, int nr,
                           const double* M, const double* a, int n_h,
                           double fill, double* out, void* stream) {
  return launch<double>(table, ax_z, ax_M, nz, nM, nr, M, a, n_h, fill, out,
                        stream);
}

}  // extern "C"
