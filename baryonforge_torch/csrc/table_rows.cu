// K9: the rows of the displacement table, float64, two entry points.
//
// Replaces baryonforge_tpu/Profiles/BaryonCorrection.py:
//   _enclosed_mass_curve (the part after the profile evaluation): per mass
//     row, the cumulative Simpson integral of the clipped integrand (scipy's
//     triplet rule, plus the first sample), the validity mask rho > 0 and
//     0 < M < inf, then a masked log-log PCHIP (ops/interp.py:
//     masked_pchip_interp with min_pts = 2) onto the output radii;
//   _displacement_rows: per mass row, the strictly-increasing selections of
//     ln M_DMB and ln M_DMO (running maximum with the 1e-5 threshold, only
//     where DMB and DMO differ by more than 1e-6), then two masked PCHIPs
//     (min_pts = 5): ln M_DMO(ln r), and the inverse ln r_b(ln M_DMB) taken
//     at it; d = exp(ln r_b) - r, NaN where not finite.
//
// The masked PCHIP is the JAX package's static-shape form: valid points are
// compressed to the front in order, the tail is padded with an x-ramp of
// step max(x[-1] - x[0], 1) from the last valid x and the last valid y, the
// PCHIP (scipy's endpoint rule) runs over the whole padded row, and a query
// outside [x_c[0], x_c[n_valid - 1]], or any query of a row with min_pts or
// fewer valid points, is NaN. Bracketing uses the JAX package's own
// bisection (searchsorted side="right"), so a row whose kept points do not
// increase still gives the JAX answer.
//
// Bound: neither: a table of B = 20 rows has ~10^4 points in all, so a
// launch is latency-bound. Design: one block per row; the sequential scans
// (cumulative sum, running maxima, compaction) run on one thread in shared
// memory, and the block's threads share the PCHIP derivatives and the
// evaluations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double sign_of(double v) {
  return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : v);  // keeps 0 and NaN
}

// jnp.maximum: NaN wins
__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}

// the JAX package's searchsorted(side="right"): ceil(log2(n + 1)) halvings
// of [0, n], NaN above everything
__device__ int search_right(const double* x, int n, double q) {
  int levels = 0;
  while ((1 << levels) < n + 1) ++levels;
  int low = 0, high = n;
  for (int l = 0; l < levels; ++l) {
    const int mid = (low + high) >> 1;
    const double xm = x[mid];
    const bool go_left = (q < xm) || (!isnan(q) && isnan(xm));
    if (go_left) high = mid;
    else low = mid;
  }
  return high;
}

__device__ double pchip_edge(double h0, double h1, double del0, double del1) {
  double d = ((2.0 * h0 + h1) * del0 - h0 * del1) / (h0 + h1);
  if (sign_of(d) != sign_of(del0)) d = 0.0;
  if ((sign_of(del0) != sign_of(del1)) && (fabs(d) > 3.0 * fabs(del0)))
    d = 3.0 * del0;
  return d;
}

// PCHIP derivative at knot i of (x, y), n >= 3
__device__ double pchip_slope(const double* x, const double* y, int n, int i) {
  if (i == 0) {
    const double h0 = x[1] - x[0], h1 = x[2] - x[1];
    return pchip_edge(h0, h1, (y[1] - y[0]) / h0, (y[2] - y[1]) / h1);
  }
  if (i == n - 1) {
    const double h0 = x[n - 1] - x[n - 2], h1 = x[n - 2] - x[n - 3];
    return pchip_edge(h0, h1, (y[n - 1] - y[n - 2]) / h0,
                      (y[n - 2] - y[n - 3]) / h1);
  }
  const double h_l = x[i] - x[i - 1], h_r = x[i + 1] - x[i];
  const double d_l = (y[i] - y[i - 1]) / h_l;
  const double d_r = (y[i + 1] - y[i]) / h_r;
  const double w1 = 2.0 * h_r + h_l;
  const double w2 = h_r + 2.0 * h_l;
  if (!((d_l * d_r) > 0.0)) return 0.0;
  const double denom = w1 / (d_l == 0.0 ? 1.0 : d_l) +
                       w2 / (d_r == 0.0 ? 1.0 : d_r);
  return (w1 + w2) / denom;
}

__device__ double hermite(const double* x, const double* y, const double* d,
                          int n, double xq) {
  int i = search_right(x, n, xq) - 1;
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  const double h = x[i + 1] - x[i];
  const double t = (xq - x[i]) / h;
  const double s = 1.0 - t;
  const double h00 = (1.0 + 2.0 * t) * (s * s);
  const double h10 = t * (s * s);
  const double h01 = (t * t) * (3.0 - 2.0 * t);
  const double h11 = (t * t) * (t - 1.0);
  return h00 * y[i] + h10 * h * d[i] + h01 * y[i + 1] + h11 * h * d[i + 1];
}

// Masked PCHIP of one row, called by the whole block. x, y, valid: the row
// (n points, any memory); xc, yc, d: shared scratch of n; nv: a shared int.
// out[k] for the nq queries xq[k].
__device__ void masked_pchip(const double* x, const double* y,
                             const bool* valid, int n, const double* xq,
                             int nq, int min_pts, double* xc, double* yc,
                             double* d, int* nv, double* out) {
  if (threadIdx.x == 0) {
    int k = 0;
    for (int j = 0; j < n; ++j) {
      if (valid[j]) {
        xc[k] = x[j];
        yc[k] = y[j];
        ++k;
      }
    }
    const double span = nan_max(x[n - 1] - x[0], 1.0);
    const int last = k > 0 ? k - 1 : 0;
    const double x_last = k > 0 ? xc[last] : x[0];
    const double y_last = k > 0 ? yc[last] : y[0];
    for (int j = k; j < n; ++j) {
      xc[j] = x_last + (double)(j - last) * span;
      yc[j] = y_last;
    }
    *nv = k;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    d[i] = pchip_slope(xc, yc, n, i);
  __syncthreads();
  const int k = *nv;
  const int last = k > 0 ? k - 1 : 0;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const double v = xq[q];
    const bool ok = (k > min_pts) && (v >= xc[0]) && (v <= xc[last]);
    out[q] = ok ? hermite(xc, yc, d, n, v) : nan("");
  }
  __syncthreads();
}

// shared layout of enclosed_mass: M (n), y (n), xc (n), yc (n), d (n),
// then n valid flags and the count
__global__ void enclosed_mass_kernel(int n, int nq,
                                     const double* __restrict__ intgd,
                                     const double* __restrict__ dens,
                                     const double* __restrict__ lnr_int,
                                     const double* __restrict__ lnr_out,
                                     int min_pts, double* __restrict__ out) {
  extern __shared__ double sh[];
  double* Me = sh;
  double* y = sh + n;
  double* xc = sh + 2 * n;
  double* yc = sh + 3 * n;
  double* d = sh + 4 * n;
  bool* valid = reinterpret_cast<bool*>(sh + 5 * n);
  __shared__ int nv;
  const int row = blockIdx.x;
  const double* f = intgd + (long long)row * n;
  const double* rho = dens + (long long)row * n;
  double* o = out + (long long)row * nq;

  if (threadIdx.x == 0) {
    // scipy's cumulative Simpson on non-overlapping triplets (dx = 1),
    // plus the first sample
    const double f0 = f[0];
    double s = 0.0;
    Me[0] = s + f0;
    for (int i = 0; i < n - 1; ++i) {
      const bool right = (i % 2 == 1) || (i == n - 2 && i % 2 == 0 && i > 0);
      const int qi = right ? i - 1 : (i < n - 3 ? i : n - 3);
      const double a0 = f[qi], a1 = f[qi + 1], a2 = f[qi + 2];
      const double inc = right ? 1.0 / 12.0 * (-a0 + 8.0 * a1 + 5.0 * a2)
                               : 1.0 / 12.0 * (5.0 * a0 + 8.0 * a1 - a2);
      s = s + inc;
      Me[i + 1] = s + f0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double m = Me[i];
    const bool v = (rho[i] > 0.0) && isfinite(m) && (m > 0.0);
    valid[i] = v;
    y[i] = log(v ? m : 1.0);
  }
  __syncthreads();
  masked_pchip(lnr_int, y, valid, n, lnr_out, nq, min_pts, xc, yc, d, &nv, o);
  for (int q = threadIdx.x; q < nq; q += blockDim.x) o[q] = exp(o[q]);
}

// shared layout of displacement_rows: ln_o, ln_b, xb, yo, lq, xc, yc, d
// (n each), then the two masks and the count
__global__ void displacement_rows_kernel(int n,
                                         const double* __restrict__ ln_dmo,
                                         const double* __restrict__ ln_dmb,
                                         const double* __restrict__ lnr,
                                         const double* __restrict__ r,
                                         int min_pts, double* __restrict__ out) {
  extern __shared__ double sh[];
  double* lo = sh;
  double* lb = sh + n;
  double* xb = sh + 2 * n;   // ln M_DMB where finite, else 0
  double* yo = sh + 3 * n;   // ln M_DMO where finite, else 0
  double* lq = sh + 4 * n;   // ln M_DMO(ln r) on the kept DMO points
  double* xc = sh + 5 * n;
  double* yc = sh + 6 * n;
  double* d = sh + 7 * n;
  bool* mask_o = reinterpret_cast<bool*>(sh + 8 * n);
  bool* mask_b = mask_o + n;
  __shared__ int nv;
  const int row = blockIdx.x;
  double* o = out + (long long)row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double a = ln_dmo[(long long)row * n + i];
    const double b = ln_dmb[(long long)row * n + i];
    lo[i] = a;
    lb[i] = b;
    yo[i] = isfinite(a) ? a : 0.0;
    xb[i] = isfinite(b) ? b : 0.0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // keep a point where it exceeds the running maximum of the kept points
    // by more than 1e-5; candidates must be finite and differ from the
    // other curve (> 1e-6 in ln M) unless the other is not finite
    double carry_b = -INFINITY, carry_o = -INFINITY;
    for (int i = 0; i < n; ++i) {
      const bool fin_b = isfinite(lb[i]), fin_o = isfinite(lo[i]);
      const bool neq = fabs(lb[i] - lo[i]) > 1e-6;
      const bool ok_b = fin_b && (neq || !fin_o);
      const bool ok_o = fin_o && (neq || !fin_b);
      const double sb = ok_b ? lb[i] : -INFINITY;
      const double so = ok_o ? lo[i] : -INFINITY;
      const bool keep_b = sb > carry_b + 1e-5;
      const bool keep_o = so > carry_o + 1e-5;
      if (keep_b) carry_b = sb;
      if (keep_o) carry_o = so;
      mask_b[i] = keep_b && ok_b;
      mask_o[i] = keep_o && ok_o;
    }
    mask_b[0] = true;
  }
  __syncthreads();
  masked_pchip(lnr, yo, mask_o, n, lnr, n, min_pts, xc, yc, d, &nv, lq);
  masked_pchip(xb, lnr, mask_b, n, lq, n, min_pts, xc, yc, d, &nv, o);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double v = exp(o[i]) - r[i];
    o[i] = isfinite(v) ? v : nan("");
  }
}

int set_shmem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

}  // namespace

extern "C" {

// intgd, dens: (B, n) clipped integrand and density; lnr_int (n);
// lnr_out (nq); out: (B, nq) enclosed mass at exp(lnr_out), NaN outside
int bf_enclosed_mass_f64(int B, int n, int nq, const double* intgd,
                         const double* dens, const double* lnr_int,
                         const double* lnr_out, int min_pts, double* out,
                         void* stream) {
  if (n < 3) return int(cudaErrorInvalidValue);
  const size_t shmem = size_t(5) * n * sizeof(double) + n * sizeof(bool);
  int e = set_shmem((const void*)enclosed_mass_kernel, shmem);
  if (e) return e;
  enclosed_mass_kernel<<<B, kThreads, shmem, (cudaStream_t)stream>>>(
      n, nq, intgd, dens, lnr_int, lnr_out, min_pts, out);
  return int(cudaGetLastError());
}

// ln_dmo, ln_dmb: (B, n) log enclosed masses; lnr, r: (n) the radii;
// out: (B, n) displacement, NaN where the inversion fails
int bf_displacement_rows_f64(int B, int n, const double* ln_dmo,
                             const double* ln_dmb, const double* lnr,
                             const double* r, int min_pts, double* out,
                             void* stream) {
  if (n < 3) return int(cudaErrorInvalidValue);
  const size_t shmem = size_t(8) * n * sizeof(double) + 2 * n * sizeof(bool);
  int e = set_shmem((const void*)displacement_rows_kernel, shmem);
  if (e) return e;
  displacement_rows_kernel<<<B, kThreads, shmem, (cudaStream_t)stream>>>(
      n, ln_dmo, ln_dmb, lnr, r, min_pts, out);
  return int(cudaGetLastError());
}

}  // extern "C"
