// K11: disc paint (the scatter paint), and K13: the anisotropic disc paint.
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py:
// PaintProfilesShell._paint_device's make_body / one_halo / body (with
// ops/healpix.py: disc_candidates and the curve lookups of
// utils/Tabulate.py: TabulatedProfile.curve_lookup for log curves and
// Profiles/BaryonCorrection.py: curve_lookup for raw ones). For each halo,
// every pixel whose centre lies inside the disc (healpix.cuh: DiscWalk,
// K2's walk) gets, in T,
//   r_com = 2 sin(d/2) D / a,
//   v = the halo curve's log-uniform lerp at r_com, exp'd for log curves,
//       zero off the tabulated range,
//   p = v / a, zero if not finite, times T(pixarea D^2) when the caller
//       asks for the per-pixel integral,
// and p is added into the (npix,) accumulator of type A. Unlike K2 there is
// no fewer-than-4-pixels fallback and no eps_max R_com cut: the disc is the
// only cut, as in the JAX paint body.
//
// Bound: atomics to device memory. A member pixel costs ~40 operations (a
// haversine, a log, an exp) and one atomicAdd into a map of 4 or 8 bytes a
// pixel (50 or 100 MB at NSIDE 1024, about the 50 MB L2). Design: one block
// per halo, threads across a ring's phi span, so that a warp's atomics land
// on neighbouring addresses; the curve is read from L1. Sums by atomics
// change order from run to run.
//
// K13 replaces the scatter body of PaintProfilesAnisShell
// (baryonforge_tpu/Runners/HealpixRunner.py:2377-2428: make_body /
// one_halo with disc_pixels, pix2vec and the curve lookups). It walks the
// same member pixels as K11 (disc_pixels is disc_candidates' mask), but
// measures each one as the JAX body does: r_sep = |pix2vec(pix) - vec_h| D
// with the pixel's unit vector from its centre's (theta, phi) in T, vec_h
// computed in float64 and rounded to T, and the difference times the
// float64 D. Under x64 everything after that subtraction is float64: r_com
// = r_sep / T(a), two lookups (the model's painting and the tracer's
// canvas, each on its own grid, log curves exp'd, zero off the grid, no
// -80 clamp) divided by T(a), non-finite values zeroed, mfrac = canvas /
// Mtot[pix] (0 where Mtot <= 0; Mtot already holds the uniform background)
// times orig[pix], the painting times pixarea D^2 when asked, and
// painting * mfrac added into a float64 map. Bound as K11, with two curve
// reads and two map reads more a pixel.

#include "healpix.cuh"
#include "lookup.cuh"

namespace {

struct HaloIn {
  const double* theta;
  const double* phi;
  const double* radius;
  const double* D;
  const double* a;
};

template <typename T>
struct Paint {
  int n_r;
  T ln_r0, dlnr;
  bool log_curves;
  bool pixel_size;  // times pixarea D^2
  double pixarea;
};

template <typename T, typename A>
__global__ void disc_paint_kernel(int N, HaloIn in,
                                  const T* __restrict__ curves, Paint<T> pt,
                                  A* __restrict__ acc) {
  const int hid = blockIdx.x;
  const double D64 = in.D[hid];
  const T D = T(D64), a = T(in.a[hid]);
  const T pixfac = pt.pixel_size ? T(pt.pixarea * (D64 * D64)) : T(1);
  const T* curve = curves + (long long)hid * pt.n_r;
  const bf::DiscWalk<T> walk(N, in.theta[hid], in.phi[hid], in.radius[hid]);
  walk([&](int pix, T, T, T, T sinhd) {
    const T r_com = T(2) * sinhd * D / a;
    const T x = (bf::m_log(r_com > T(1e-30) ? r_com : T(1e-30)) - pt.ln_r0) /
                pt.dlnr;
    const int i = bf::clampi(int(bf::m_floor(x)), 0, pt.n_r - 2);
    const T t = x - T(i);
    T v = curve[i] * (T(1) - t) + curve[i + 1] * t;
    if (pt.log_curves) v = bf::m_exp(v);
    if (x < T(0) || x > T(pt.n_r - 1)) v = T(0);
    T p = v / a;
    if (!isfinite(p)) p = T(0);
    if (pt.pixel_size) p = p * pixfac;
    atomicAdd(acc + pix, A(p));
  });
}

template <typename T, typename A>
int launch(int nside, int n_h, const double* theta, const double* phi,
           const double* radius, const double* D, const double* a,
           const T* curves, int n_r, T ln_r0, T dlnr, int log_curves,
           int pixel_size, double pixarea, A* acc, void* stream) {
  HaloIn in{theta, phi, radius, D, a};
  Paint<T> pt{n_r, ln_r0, dlnr, log_curves != 0, pixel_size != 0, pixarea};
  disc_paint_kernel<T, A><<<n_h, 128, 0, (cudaStream_t)stream>>>(
      nside, in, curves, pt, acc);
  return int(cudaGetLastError());
}

template <typename T>
__global__ void disc_paint_anis_kernel(int N, HaloIn in, bf::Curve<T> cp,
                                       bf::Curve<T> ct,
                                       const double* __restrict__ mtot,
                                       const double* __restrict__ orig,
                                       bool pixel_size, double pixarea,
                                       double* __restrict__ acc) {
  const int hid = blockIdx.x;
  const double th_h = in.theta[hid], ph_h = in.phi[hid], D = in.D[hid];
  const double a = double(T(in.a[hid]));
  const T vh0 = T(sin(th_h) * cos(ph_h));
  const T vh1 = T(sin(th_h) * sin(ph_h));
  const T vh2 = T(cos(th_h));
  const T* curve_p = cp.c + (long long)hid * cp.n_r;
  const T* curve_t = ct.c + (long long)hid * ct.n_r;
  const double pixfac = pixarea * (D * D);
  const bf::DiscWalk<T> walk(N, th_h, ph_h, in.radius[hid]);
  walk([&](int pix, T, T, T, T) {
    T th, ph;
    bf::pix2ang<T>(N, pix, th, ph);
    const T st = bf::m_sin(th);
    const double d0 = double(st * bf::m_cos(ph) - vh0) * D;
    const double d1 = double(st * bf::m_sin(ph) - vh1) * D;
    const double d2 = double(bf::m_cos(th) - vh2) * D;
    const double r_com = sqrt(d0 * d0 + d1 * d1 + d2 * d2) / a;
    double painting = bf::lookup64(curve_p, cp, r_com) / a;
    double canvas = bf::lookup64(curve_t, ct, r_com) / a;
    if (!isfinite(painting)) painting = 0.0;
    if (!isfinite(canvas)) canvas = 0.0;
    const double mt = mtot[pix];
    const double mfrac = (mt > 0.0 ? canvas / mt : 0.0) * orig[pix];
    if (pixel_size) painting = painting * pixfac;
    atomicAdd(acc + pix, painting * mfrac);
  });
}

template <typename T>
int launch_anis(int nside, int n_h, HaloIn in, bf::Curve<T> cp,
                bf::Curve<T> ct,
                const double* mtot, const double* orig, int pixel_size,
                double pixarea, double* acc, void* stream) {
  disc_paint_anis_kernel<T><<<n_h, 128, 0, (cudaStream_t)stream>>>(
      nside, in, cp, ct, mtot, orig, pixel_size != 0, pixarea, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// curves and geometry in the first type, the accumulator in the second
#define BF_DISC_PAINT(T, A, SUF)                                            \
  int bf_disc_paint_##SUF(int nside, int n_h, const double* theta,          \
                          const double* phi, const double* radius,          \
                          const double* D, const double* a, const T* curves, \
                          int n_r, T ln_r0, T dlnr, int log_curves,         \
                          int pixel_size, double pixarea, A* acc,           \
                          void* stream) {                                   \
    return launch<T, A>(nside, n_h, theta, phi, radius, D, a, curves, n_r,  \
                        ln_r0, dlnr, log_curves, pixel_size, pixarea, acc,  \
                        stream);                                            \
  }

BF_DISC_PAINT(float, float, f32_f32)
BF_DISC_PAINT(float, double, f32_f64)
BF_DISC_PAINT(double, float, f64_f32)
BF_DISC_PAINT(double, double, f64_f64)
#undef BF_DISC_PAINT

// geometry and curves in T, the lookups and the map in float64
#define BF_DISC_PAINT_ANIS(T, SUF)                                            \
  int bf_disc_paint_anis_##SUF(                                               \
      int nside, int n_h, const double* theta, const double* phi,             \
      const double* radius, const double* D, const double* a,                 \
      const T* curves_p, int n_rp, double ln_r0_p, double dlnr_p, int log_p,  \
      const T* curves_t, int n_rt, double ln_r0_t, double dlnr_t, int log_t,  \
      const double* mtot, const double* orig, int pixel_size, double pixarea, \
      double* acc, void* stream) {                                            \
    return launch_anis<T>(nside, n_h, HaloIn{theta, phi, radius, D, a},       \
                          bf::Curve<T>{curves_p, n_rp, ln_r0_p, dlnr_p,       \
                                       log_p != 0},                           \
                          bf::Curve<T>{curves_t, n_rt, ln_r0_t, dlnr_t,       \
                                       log_t != 0},                           \
                          mtot, orig, pixel_size, pixarea, acc, stream);      \
  }

BF_DISC_PAINT_ANIS(float, f32)
BF_DISC_PAINT_ANIS(double, f64)
#undef BF_DISC_PAINT_ANIS

}  // extern "C"
