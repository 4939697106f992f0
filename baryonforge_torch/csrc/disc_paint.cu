// K11: disc paint (the scatter paint).
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

#include "healpix.cuh"

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

}  // extern "C"
