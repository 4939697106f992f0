// K9: the rows of the displacement table, float64.
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
// Bound: latency. A table row is ~10^3 points, so a launch is a chain of
// dependent steps, not bytes or operations. Design: bf_table_rows_f64 makes
// one launch a redshift, a block a mass row; the DMO and DMB enclosed-mass
// curves run at once on the block's two groups of kGroup threads, their
// values at the output radii stay in shared memory (exponentiated and
// logged again, as the plain chain compares those logs with its 1e-6 and
// 1e-5 thresholds), and the whole block then inverts them. Every step but
// one is parallel: the Simpson increments are formed a chunk a thread and
// summed by a block prefix sum (warp shuffles), the compactions are
// ballot/popc prefixes, the PCHIP slopes are formed where a query needs
// them. The running-maximum selection is not associative (its carry is the
// last kept value), so it stays a chain, one lane a curve over n_r values
// in shared memory. bf_enclosed_mass_f64 (get_masses) and
// bf_displacement_rows_f64 run the two halves alone on the same device
// code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroup = 256;                // threads of one curve
constexpr unsigned kFull = 0xffffffffu;

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

// the PCHIP of the knots (x, y) (n of them) at xq, its two slopes formed
// here: the same values as a table of all n slopes
__device__ double hermite(const double* x, const double* y, int n,
                          double xq) {
  int i = search_right(x, n, xq) - 1;
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  const double d0 = pchip_slope(x, y, n, i);
  const double d1 = pchip_slope(x, y, n, i + 1);
  const double h = x[i + 1] - x[i];
  const double t = (xq - x[i]) / h;
  const double s = 1.0 - t;
  const double h00 = (1.0 + 2.0 * t) * (s * s);
  const double h10 = t * (s * s);
  const double h01 = (t * t) * (3.0 - 2.0 * t);
  const double h11 = (t * t) * (t - 1.0);
  return h00 * y[i] + h10 * h * d0 + h01 * y[i + 1] + h11 * h * d1;
}

// A group of G consecutive threads of the block (G a multiple of 32). Every
// thread of the block calls the functions below together: they hold
// __syncthreads barriers, and each group works on its own data.
template <int G>
struct Group {
  int t;      // thread in the group
  int lane;
  int warp;   // warp in the group
  __device__ Group()
      : t(threadIdx.x % G), lane(threadIdx.x & 31), warp(t >> 5) {}
};

// The exclusive prefix sum of v over the group's threads; wsum: the
// group's G / 32 slots of shared scratch
template <int G>
__device__ double group_prefix(const Group<G>& g, double v, double* wsum) {
  double incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, d);
    if (g.lane >= d) incl = incl + y;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (g.lane == 0) excl = 0.0;
  if (g.lane == 31) wsum[g.warp] = incl;
  __syncthreads();
  double before = 0.0;
#pragma unroll
  for (int w = 0; w < G / 32; ++w)
    if (w < g.warp) before = before + wsum[w];
  __syncthreads();
  return before + excl;
}

// The masked PCHIP's knots: the points j < n with ok(j), (x(j), y(j)), in
// order to the front of (xc, yc) by ballot/popc prefixes, G points a round;
// the tail padded with the x-ramp from the last valid point (y0 stands for
// y(0) when no point is valid). wcnt: the group's 2 x G / 32 ints of shared
// scratch (two rounds' warp counts, so one barrier a round). Returns the
// number of valid points; xc and yc are complete on return.
template <int G, typename Ok, typename X, typename Y>
__device__ int compact_pad(const Group<G>& g, int n, Ok ok, X x, Y y,
                           double y0, double* xc, double* yc, int* wcnt) {
  int base = 0;
  for (int r = 0; r * G < n; ++r) {
    const int j = r * G + g.t;
    const bool v = j < n && ok(j);
    const unsigned b = __ballot_sync(kFull, v);
    int* wc = wcnt + (r & 1) * (G / 32);
    if (g.lane == 0) wc[g.warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < G / 32; ++w) {
      before += w < g.warp ? wc[w] : 0;
      total += wc[w];
    }
    if (v) {
      const int k = base + before + __popc(b & ((1u << g.lane) - 1u));
      xc[k] = x(j);
      yc[k] = y(j);
    }
    base += total;
  }
  __syncthreads();
  const int last = base > 0 ? base - 1 : 0;
  const double span = nan_max(x(n - 1) - x(0), 1.0);
  const double x_last = base > 0 ? xc[last] : x(0);
  const double y_last = base > 0 ? yc[last] : y0;
  for (int j = base + g.t; j < n; j += G) {
    xc[j] = x_last + (double)(j - last) * span;
    yc[j] = y_last;
  }
  __syncthreads();
  return base;
}

// The masked PCHIP of the knots (xc, yc) (n, nv valid) at the nq queries
// xq(q): put(q, value), NaN outside [xc[0], xc[nv - 1]] or when nv <=
// min_pts
template <int G, typename Q, typename Put>
__device__ void masked_eval(const Group<G>& g, const double* xc,
                            const double* yc, int n, int nv, int min_pts,
                            int nq, Q xq, Put put) {
  const int last = nv > 0 ? nv - 1 : 0;
  for (int q = g.t; q < nq; q += G) {
    const double v = xq(q);
    const bool ok = (nv > min_pts) && (v >= xc[0]) && (v <= xc[last]);
    put(q, ok ? hermite(xc, yc, n, v) : nan(""));
  }
}

// A block's dynamic shared memory: the inversion's n_r-arrays, the grid's
// logs (n), each curve's n-arrays, then the flags. Every kernel below
// takes the parts it uses (n_r = 0: no inversion; curves = 0: none).
struct Layout {
  // the inversion: ln M_DMO, ln M_DMB at the radii, the two knot sets, ln
  // M_DMO(ln r), the radii's logs; the two masks
  double *lo, *lb, *xo, *yo, *xb, *yb, *lq, *lr;
  bool *mask_o, *mask_b;
  double* xs;      // the grid's logs
  // curve c's n-arrays from curves + 3 c n: the integrand (then the
  // knots' x), log M (NaN where not valid), the knots' y; its rho > 0
  // flags from pos + c n
  double* curves;
  bool* pos;
};

constexpr int kInversionDoubles = 8;

size_t shared_bytes(int curves, int n, int n_r) {
  return (size_t(kInversionDoubles) * n_r + n + size_t(3) * curves * n) *
             sizeof(double) +
         2 * size_t(n_r) + size_t(curves) * n;
}

__device__ __forceinline__ Layout layout(double* sh, int curves, int n,
                                         int n_r) {
  Layout s;
  s.lo = sh;
  s.lb = sh + n_r;
  s.xo = sh + 2 * n_r;
  s.yo = sh + 3 * n_r;
  s.xb = sh + 4 * n_r;
  s.yb = sh + 5 * n_r;
  s.lq = sh + 6 * n_r;
  s.lr = sh + 7 * n_r;
  s.xs = sh + kInversionDoubles * n_r;
  s.curves = s.xs + n;
  s.mask_o = reinterpret_cast<bool*>(s.curves + 3 * curves * n);
  s.mask_b = s.mask_o + n_r;
  s.pos = s.mask_b + n_r;
  return s;
}

// One enclosed-mass row of curve c on a group: intgd and rho the row (n),
// the grid's logs in s.xs (complete); put(q, M(q)) at the nq output radii
// xq(q), M the masked log-log PCHIP's exp (NaN outside the row's valid
// range). The Simpson increments of a chunk of ceil((n - 1) / G)
// intervals a thread, summed by the group's prefix; then M, the mask and
// log M a point.
template <int G, typename Q, typename Put>
__device__ void enclosed_row(const Group<G>& g, int n, int nq, int c,
                             const double* __restrict__ intgd,
                             const double* __restrict__ rho, Layout s,
                             double* wsum, int* wcnt, Q xq, Put put) {
  double* f = s.curves + 3 * c * n;
  double* y = f + n;
  double* yc = f + 2 * n;
  bool* pos = s.pos + c * n;
  for (int j = g.t; j < n; j += G) {
    f[j] = intgd[j];
    pos[j] = rho[j] > 0.0;
  }
  __syncthreads();
  // scipy's cumulative Simpson on non-overlapping triplets (dx = 1)
  auto inc = [&](int i) {
    const bool right = (i % 2 == 1) || (i == n - 2 && i % 2 == 0 && i > 0);
    const int qi = right ? i - 1 : (i < n - 3 ? i : n - 3);
    const double a0 = f[qi], a1 = f[qi + 1], a2 = f[qi + 2];
    return right ? 1.0 / 12.0 * (-a0 + 8.0 * a1 + 5.0 * a2)
                 : 1.0 / 12.0 * (5.0 * a0 + 8.0 * a1 - a2);
  };
  const int chunk = (n - 1 + G - 1) / G;
  const int lo = g.t * chunk < n - 1 ? g.t * chunk : n - 1;
  const int hi = lo + chunk < n - 1 ? lo + chunk : n - 1;
  double part = 0.0;
  for (int i = lo; i < hi; ++i) part = part + inc(i);
  double s_i = group_prefix<G>(g, part, wsum);
  const double f0 = f[0];
  // M at the points this thread owns (i + 1 for its intervals; point 0 on
  // the first thread), and y = log M where valid, NaN where not
  auto mark = [&](int j, double m) {
    const bool v = pos[j] && isfinite(m) && (m > 0.0);
    y[j] = v ? log(m) : nan("");
  };
  if (g.t == 0) mark(0, 0.0 + f0);
  for (int i = lo; i < hi; ++i) {
    s_i = s_i + inc(i);
    mark(i + 1, s_i + f0);
  }
  __syncthreads();
  // the knots' x go where f was
  const double* xs = s.xs;
  const int nv = compact_pad<G>(
      g, n, [&](int j) { return !isnan(y[j]); }, [&](int j) { return xs[j]; },
      [&](int j) { return y[j]; }, 0.0, f, yc, wcnt);
  masked_eval<G>(g, f, yc, n, nv, 2, nq, xq,
                 [&](int q, double v) { put(q, exp(v)); });
}

// The displacement row from s.lo, s.lb and the radii's logs s.lr (n, in
// shared memory, complete) on the whole block (G = blockDim.x): each
// point's candidate value for the two selections, in parallel; the two
// selections as one chain a curve (lanes 0 of warps 0 and 1); then both
// masked PCHIPs; out (n, global) gets d = exp(ln r_b) - r, NaN where not
// finite.
template <int G>
__device__ void invert_row(const Group<G>& g, int n, Layout s, int* wcnt,
                           double* __restrict__ out) {
  // a point is a candidate where it is finite and differs from the other
  // curve (> 1e-6 in ln M) unless the other is not finite; the rest get
  // -inf, which no carry can keep (the candidates go where the knots'
  // x will)
  for (int i = g.t; i < n; i += G) {
    const double a = s.lo[i], b = s.lb[i];
    const bool fin_o = isfinite(a), fin_b = isfinite(b);
    const bool neq = fabs(b - a) > 1e-6;
    s.xo[i] = fin_o && (neq || !fin_b) ? a : -INFINITY;
    s.xb[i] = fin_b && (neq || !fin_o) ? b : -INFINITY;
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    // keep a candidate where it exceeds the running maximum of the kept
    // points by more than 1e-5
    const bool is_b = threadIdx.x == 0;
    const double* sel = is_b ? s.xb : s.xo;
    bool* mask = is_b ? s.mask_b : s.mask_o;
    double carry = -INFINITY;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const double v = sel[i];
      const bool keep = v > carry + 1e-5;
      carry = keep ? v : carry;
      mask[i] = keep;
    }
    if (is_b) mask[0] = true;
  }
  __syncthreads();
  const double* lo = s.lo;
  const double* lb = s.lb;
  const double* lr = s.lr;
  const bool* mask_o = s.mask_o;
  const bool* mask_b = s.mask_b;
  auto yo = [&](int j) { return isfinite(lo[j]) ? lo[j] : 0.0; };
  auto xb = [&](int j) { return isfinite(lb[j]) ? lb[j] : 0.0; };
  auto r_at = [&](int j) { return lr[j]; };
  const int nvo = compact_pad<G>(
      g, n, [&](int j) { return mask_o[j]; }, r_at, yo, yo(0), s.xo, s.yo,
      wcnt);
  const int nvb = compact_pad<G>(
      g, n, [&](int j) { return mask_b[j]; }, xb, r_at, lr[0], s.xb, s.yb,
      wcnt);
  double* lq = s.lq;
  masked_eval<G>(g, s.xo, s.yo, n, nvo, 5, n, r_at,
                 [&](int q, double x) { lq[q] = x; });
  __syncthreads();
  masked_eval<G>(g, s.xb, s.yb, n, nvb, 5, n, [&](int q) { return lq[q]; },
                 [&](int q, double x) {
                   const double d = exp(x) - exp(lr[q]);
                   out[q] = isfinite(d) ? d : nan("");
                 });
}

// one launch a redshift: block b the mass row b, threads [0, kGroup) the
// DMO curve, [kGroup, 2 kGroup) the DMB curve, then all the inversion
__global__ void __launch_bounds__(2 * kGroup)
table_rows_kernel(int n, int n_r, const double* __restrict__ intgd_o,
                  const double* __restrict__ dens_o,
                  const double* __restrict__ intgd_b,
                  const double* __restrict__ dens_b,
                  const double* __restrict__ lnr_int,
                  const double* __restrict__ lnr, double* __restrict__ out) {
  extern __shared__ double sh[];
  __shared__ double wsum[2][kGroup / 32];
  __shared__ int wcnt[2][2 * (2 * kGroup) / 32];
  const Layout s = layout(sh, 2, n, n_r);
  for (int j = threadIdx.x; j < n; j += blockDim.x) s.xs[j] = lnr_int[j];
  for (int j = threadIdx.x; j < n_r; j += blockDim.x) s.lr[j] = lnr[j];
  const int c = threadIdx.x / kGroup;
  const long long row = (long long)blockIdx.x * n;
  double* ln_m = c == 0 ? s.lo : s.lb;
  const double* lr = s.lr;
  const Group<kGroup> g;
  enclosed_row<kGroup>(g, n, n_r, c, (c == 0 ? intgd_o : intgd_b) + row,
                       (c == 0 ? dens_o : dens_b) + row, s, wsum[c], wcnt[c],
                       [&](int q) { return lr[q]; },
                       [&](int q, double m) { ln_m[q] = log(m); });
  __syncthreads();
  const Group<2 * kGroup> all;
  invert_row<2 * kGroup>(all, n_r, s, &wcnt[0][0],
                         out + (long long)blockIdx.x * n_r);
}

// get_masses' half alone: a block (one group) a mass row
__global__ void __launch_bounds__(kGroup)
enclosed_mass_kernel(int n, int nq, const double* __restrict__ intgd,
                     const double* __restrict__ dens,
                     const double* __restrict__ lnr_int,
                     const double* __restrict__ lnr_out,
                     double* __restrict__ out) {
  extern __shared__ double sh[];
  __shared__ double wsum[kGroup / 32];
  __shared__ int wcnt[2 * kGroup / 32];
  const Layout s = layout(sh, 1, n, 0);
  for (int j = threadIdx.x; j < n; j += blockDim.x) s.xs[j] = lnr_int[j];
  const long long row = (long long)blockIdx.x * n;
  double* o = out + (long long)blockIdx.x * nq;
  const Group<kGroup> g;
  enclosed_row<kGroup>(g, n, nq, 0, intgd + row, dens + row, s, wsum, wcnt,
                       [&](int q) { return lnr_out[q]; },
                       [&](int q, double m) { o[q] = m; });
}

// the inversion alone, from the enclosed masses (their logs taken here)
__global__ void __launch_bounds__(2 * kGroup)
displacement_rows_kernel(int n, const double* __restrict__ M_dmo,
                         const double* __restrict__ M_dmb,
                         const double* __restrict__ lnr,
                         double* __restrict__ out) {
  extern __shared__ double sh[];
  __shared__ int wcnt[2 * (2 * kGroup) / 32];
  const long long row = (long long)blockIdx.x * n;
  const Layout s = layout(sh, 0, 0, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.lo[i] = log(M_dmo[row + i]);
    s.lb[i] = log(M_dmb[row + i]);
    s.lr[i] = lnr[i];
  }
  __syncthreads();
  const Group<2 * kGroup> all;
  invert_row<2 * kGroup>(all, n, s, wcnt, out + row);
}

int set_shmem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

}  // namespace

extern "C" {

// intgd_o, dens_o, intgd_b, dens_b: (B, n) clipped integrands and
// densities of the DMO and DMB profiles on the grid lnr_int (n); lnr (n_r)
// the table's radii; out: (B, n_r) displacement, NaN where the inversion
// fails
int bf_table_rows_f64(int B, int n, int n_r, const double* intgd_o,
                      const double* dens_o, const double* intgd_b,
                      const double* dens_b, const double* lnr_int,
                      const double* lnr, double* out, void* stream) {
  if (n < 3 || n_r < 3) return int(cudaErrorInvalidValue);
  const size_t shmem = shared_bytes(2, n, n_r);
  int e = set_shmem((const void*)table_rows_kernel, shmem);
  if (e) return e;
  table_rows_kernel<<<B, 2 * kGroup, shmem, (cudaStream_t)stream>>>(
      n, n_r, intgd_o, dens_o, intgd_b, dens_b, lnr_int, lnr, out);
  return int(cudaGetLastError());
}

// intgd, dens: (B, n) clipped integrand and density; lnr_int (n);
// lnr_out (nq); out: (B, nq) enclosed mass at exp(lnr_out), NaN outside
int bf_enclosed_mass_f64(int B, int n, int nq, const double* intgd,
                         const double* dens, const double* lnr_int,
                         const double* lnr_out, double* out, void* stream) {
  if (n < 3) return int(cudaErrorInvalidValue);
  const size_t shmem = shared_bytes(1, n, 0);
  int e = set_shmem((const void*)enclosed_mass_kernel, shmem);
  if (e) return e;
  enclosed_mass_kernel<<<B, kGroup, shmem, (cudaStream_t)stream>>>(
      n, nq, intgd, dens, lnr_int, lnr_out, out);
  return int(cudaGetLastError());
}

// M_dmo, M_dmb: (B, n) enclosed masses at the radii exp(lnr) (n); out:
// (B, n) displacement, NaN where the inversion fails
int bf_displacement_rows_f64(int B, int n, const double* M_dmo,
                             const double* M_dmb, const double* lnr,
                             double* out, void* stream) {
  if (n < 3) return int(cudaErrorInvalidValue);
  const size_t shmem = shared_bytes(0, 0, n);
  int e = set_shmem((const void*)displacement_rows_kernel, shmem);
  if (e) return e;
  displacement_rows_kernel<<<B, 2 * kGroup, shmem, (cudaStream_t)stream>>>(
      n, M_dmo, M_dmb, lnr, out);
  return int(cudaGetLastError());
}

}  // extern "C"
