// K1: per-halo curve collapse.
//
// Replaces baryonforge_tpu/ops/interp.py: collapse_curves (reached through
// Profiles/BaryonCorrection.py: halo_curves). The table is laid out as the
// JAX function lays it out: (n_z, n_M, n_r, n_p1, ..., n_pP), radial axis
// at index 2. Each halo's (ln 1/a, ln M, p1, ..., pP) is located on the
// table's non-radial axes (searchsorted side="right", minus one, clamped to
// [0, n-2]; the p values are raw per-halo values, not logs); the 2^(2+P)
// corner rows are blended into one radial curve, corner bit d for axis d in
// the order z, M, p1, ..., with the weight built as w = w * (bit ? t : 1-t)
// in that order; halos with any coordinate outside its axis get `fill`.
//
// The axes come by pointer and size (struct Axes, filled on the host). A
// thread keeps each axis' bracket and fraction in registers, so the number
// of axes is bounded by kMaxAxes: z, M and up to 4 parameter axes. The
// wrapper (ops/interp.py) raises above that.
//
// Bound: device-memory bytes. Each output value reads 2^(2+P) table values
// that sit in L2 (the bench table is 8x20x64, 40 KB in float32) and writes
// one value; the axis searches are a few dozen compares per thread. Design:
// one thread per (halo, radius), neighbouring threads on neighbouring radii,
// so the output writes coalesce, and so do the table reads of a table
// without parameter axes (the radial stride is then 1).

#include "healpix.cuh"

namespace {

constexpr int kMaxAxes = 6;

template <typename T>
struct Axes {
  const T* grid[kMaxAxes];  // z, M, p1, ... grids
  int size[kMaxAxes];
  int n;                    // 2 + P
};

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
                                       Axes<T> ax, int nr,
                                       const T* __restrict__ M,
                                       const T* __restrict__ a,
                                       const T* __restrict__ p, int n_h,
                                       T fill, T* __restrict__ out) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_h * nr) return;
  int h = int(k / nr);
  int r = int(k % nr);
  int idx[kMaxAxes];
  T frac[kMaxAxes];
  bool oob = false;
  for (int d = 0; d < ax.n; ++d) {
    T x;
    if (d == 0) x = bf::m_log(T(1) / a[h]);
    else if (d == 1) x = bf::m_log(M[h]);
    else x = p[(long long)(d - 2) * n_h + h];
    bool o;
    locate(ax.grid[d], ax.size[d], x, idx[d], frac[d], o);
    oob = oob || o;
  }
  if (oob) {
    out[k] = fill;
    return;
  }
  // row-major strides of (z, M, r, p1, ..., pP)
  long long stride[kMaxAxes];
  long long s = 1;
  for (int d = ax.n - 1; d >= 2; --d) {
    stride[d] = s;
    s *= ax.size[d];
  }
  const long long stride_r = s;
  s *= nr;
  stride[1] = s;
  stride[0] = s * ax.size[1];
  T c = T(0);
  for (int corner = 0; corner < (1 << ax.n); ++corner) {
    T w = T(1);
    long long off = r * stride_r;
    for (int d = 0; d < ax.n; ++d) {
      const int bit = (corner >> d) & 1;
      off += (long long)(idx[d] + bit) * stride[d];
      w = w * (bit ? frac[d] : T(1) - frac[d]);
    }
    c = c + w * table[off];
  }
  out[k] = c;
}

template <typename T>
int launch(const T* table, const void* const* grids, const int* sizes,
           int n_axes, int nr, const T* M, const T* a, const T* p, int n_h,
           T fill, T* out, void* stream) {
  if (n_axes < 2 || n_axes > kMaxAxes) return int(cudaErrorInvalidValue);
  Axes<T> ax;
  ax.n = n_axes;
  for (int d = 0; d < kMaxAxes; ++d) {
    ax.grid[d] = d < n_axes ? static_cast<const T*>(grids[d]) : nullptr;
    ax.size[d] = d < n_axes ? sizes[d] : 0;
  }
  const int threads = 256;
  long long total = (long long)n_h * nr;
  int blocks = int((total + threads - 1) / threads);
  collapse_curves_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, ax, nr, M, a, p, n_h, fill, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// grids / sizes: host arrays of n_axes device pointers and axis lengths,
// in the order z, M, p1, ...; p: (n_axes - 2, n_h) parameter values
int bf_collapse_curves_f32(const float* table, const void* const* grids,
                           const int* sizes, int n_axes, int nr,
                           const float* M, const float* a, const float* p,
                           int n_h, float fill, float* out, void* stream) {
  return launch<float>(table, grids, sizes, n_axes, nr, M, a, p, n_h, fill,
                       out, stream);
}

int bf_collapse_curves_f64(const double* table, const void* const* grids,
                           const int* sizes, int n_axes, int nr,
                           const double* M, const double* a, const double* p,
                           int n_h, double fill, double* out, void* stream) {
  return launch<double>(table, grids, sizes, n_axes, nr, M, a, p, n_h, fill,
                        out, stream);
}

}  // extern "C"
