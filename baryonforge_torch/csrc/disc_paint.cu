// K11: disc paint (the scatter paint), and K13: the anisotropic disc paint.
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py:
// PaintProfilesShell._paint_device's make_body / one_halo / body (with
// ops/healpix.py: disc_candidates and the curve lookups of
// utils/Tabulate.py: TabulatedProfile.curve_lookup for log curves and
// Profiles/BaryonCorrection.py: curve_lookup for raw ones). For each halo,
// every pixel whose centre lies inside the disc (healpix.cuh: DiscWalk,
// the member set of K2's walk) gets, in T,
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
// pixel (50 or 100 MB at NSIDE 1024, about the 50 MB L2). Design: K2's
// flat disc walk (healpix.cuh: flat_disc_walks), 8 halos a block, one a
// warp; a disc of more than 32 rings is walked by the whole block. The
// discs are small (~16 member pixels over a few rings at the bench), so a
// block per halo left most of its threads idle and repeated the per-disc
// set-up; here a ring's geometry is worked out once by one lane and the
// warp's lanes take consecutive candidates across the rings, so that its
// atomics land on neighbouring addresses. The curve is read from L1. Sums
// by atomics change order from run to run.
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
// reads and two map reads more a pixel. Design: K11's flat walk. A
// pixel's theta, and with it sin and cos theta, is its ring's (ring_theta,
// bitwise pix2ang's: tested on the card); its phi is pix2ang's formula on
// its ring and index.

#include "healpix.cuh"
#include "lookup.cuh"

namespace {

constexpr int kWarps = 8;  // halos a block takes, one a warp
constexpr int kThreads = 32 * kWarps;

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

// one halo's values that every pixel of K11 uses
template <typename T>
struct PaintHalo {
  T D, a, pixfac;  // D and a rounded to T, T(pixarea D^2) or 1
  const T* curve;
};

// A block takes kWarps halos on K2's flat walk (healpix.cuh), one a warp;
// a disc of more than kSplitRings rings is walked by the whole block. A
// pixel's sin(d/2) comes from DiscWalk::ring and ::pixel, so its value does
// not depend on the walk's layout; only the order of the atomics does.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
disc_paint_kernel(int N, int n_h, HaloIn in, const T* __restrict__ curves,
                  Paint<T> pt, A* __restrict__ acc) {
  __shared__ bf::FlatDiscs<T, kWarps> s;
  auto halo = [&](int hid) {
    const double D64 = in.D[hid];
    PaintHalo<T> h;
    h.D = T(D64);
    h.a = T(in.a[hid]);
    h.pixfac = pt.pixel_size ? T(pt.pixarea * (D64 * D64)) : T(1);
    h.curve = curves + (long long)hid * pt.n_r;
    return h;
  };
  auto paint = [&](const PaintHalo<T>& h, const bf::DiscPixel<T>& p) {
    const T r_com = T(2) * p.sinhd * h.D / h.a;
    const T x = (bf::m_log(r_com > T(1e-30) ? r_com : T(1e-30)) - pt.ln_r0) /
                pt.dlnr;
    const int i = bf::clampi(int(bf::m_floor(x)), 0, pt.n_r - 2);
    const T t = x - T(i);
    T v = h.curve[i] * (T(1) - t) + h.curve[i + 1] * t;
    if (pt.log_curves) v = bf::m_exp(v);
    if (x < T(0) || x > T(pt.n_r - 1)) v = T(0);
    T val = v / h.a;
    if (!isfinite(val)) val = T(0);
    if (pt.pixel_size) val = val * h.pixfac;
    atomicAdd(acc + p.pix, A(val));
  };
  bf::flat_disc_walks<kWarps>(
      N, n_h, in.theta, in.phi, in.radius, s,
      [&](int hid, const bf::DiscWalk<T>& walk, bf::DiscRing<T>* rings,
          int* first) {
        const PaintHalo<T> h = halo(hid);
        bf::warp_walk(walk, rings, first,
                      [&](bool m, int, const bf::DiscPixel<T>& p) {
          if (m) paint(h, p);
        });
      },
      [&](int hid, const bf::DiscWalk<T>& walk) {
        const PaintHalo<T> h = halo(hid);
        bf::block_walk<kWarps>(walk, s.rings, s.first, s.wsum,
                               [&](const bf::DiscPixel<T>& p) {
          paint(h, p);
        });
      });
}

template <typename T, typename A>
int launch(int nside, int n_h, const double* theta, const double* phi,
           const double* radius, const double* D, const double* a,
           const T* curves, int n_r, T ln_r0, T dlnr, int log_curves,
           int pixel_size, double pixarea, A* acc, void* stream) {
  HaloIn in{theta, phi, radius, D, a};
  Paint<T> pt{n_r, ln_r0, dlnr, log_curves != 0, pixel_size != 0, pixarea};
  disc_paint_kernel<T, A>
      <<<(n_h + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
          nside, n_h, in, curves, pt, acc);
  return int(cudaGetLastError());
}

// one halo's values that every pixel of K13 uses
template <typename T>
struct AnisHalo {
  T vh0, vh1, vh2;             // its unit vector, float64 rounded to T
  double D, a, pixfac;         // D, a (rounded to T), pixarea D^2
  const T* curve_p;
  const T* curve_t;
};

// A block takes kWarps halos on K2's flat walk (healpix.cuh), one a warp;
// a disc of more than kSplitRings rings is walked by the whole block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
disc_paint_anis_kernel(int N, int n_h, HaloIn in, bf::Curve<T> cp,
                       bf::Curve<T> ct, const double* __restrict__ mtot,
                       const double* __restrict__ orig, bool pixel_size,
                       double pixarea, double* __restrict__ acc) {
  __shared__ bf::FlatDiscs<T, kWarps> s;
  auto halo = [&](int hid) {
    const double th_h = in.theta[hid], ph_h = in.phi[hid], D = in.D[hid];
    AnisHalo<T> h;
    h.vh0 = T(sin(th_h) * cos(ph_h));
    h.vh1 = T(sin(th_h) * sin(ph_h));
    h.vh2 = T(cos(th_h));
    h.D = D;
    h.a = double(T(in.a[hid]));
    h.pixfac = pixarea * (D * D);
    h.curve_p = cp.c + (long long)hid * cp.n_r;
    h.curve_t = ct.c + (long long)hid * ct.n_r;
    return h;
  };
  // the pixel's unit vector in T: its ring's cos/sin theta, which are
  // pix2ang's bit for bit (ring_theta is pix2ang's theta; the card test
  // holds it), and its own phi
  auto paint = [&](const AnisHalo<T>& h, const bf::DiscPixel<T>& p) {
    const T ph = bf::ring_pixel_phi<T>(N, p.ring, p.j, p.shifted);
    const double d0 = double(p.sin_t * bf::m_cos(ph) - h.vh0) * h.D;
    const double d1 = double(p.sin_t * bf::m_sin(ph) - h.vh1) * h.D;
    const double d2 = double(p.cos_t - h.vh2) * h.D;
    const double r_com = sqrt(d0 * d0 + d1 * d1 + d2 * d2) / h.a;
    double painting = bf::lookup64(h.curve_p, cp, r_com) / h.a;
    double canvas = bf::lookup64(h.curve_t, ct, r_com) / h.a;
    if (!isfinite(painting)) painting = 0.0;
    if (!isfinite(canvas)) canvas = 0.0;
    const double mt = mtot[p.pix];
    const double mfrac = (mt > 0.0 ? canvas / mt : 0.0) * orig[p.pix];
    if (pixel_size) painting = painting * h.pixfac;
    atomicAdd(acc + p.pix, painting * mfrac);
  };
  bf::flat_disc_walks<kWarps>(
      N, n_h, in.theta, in.phi, in.radius, s,
      [&](int hid, const bf::DiscWalk<T>& walk, bf::DiscRing<T>* rings,
          int* first) {
        const AnisHalo<T> h = halo(hid);
        bf::warp_walk(walk, rings, first,
                      [&](bool m, int, const bf::DiscPixel<T>& p) {
          if (m) paint(h, p);
        });
      },
      [&](int hid, const bf::DiscWalk<T>& walk) {
        const AnisHalo<T> h = halo(hid);
        bf::block_walk<kWarps>(walk, s.rings, s.first, s.wsum,
                               [&](const bf::DiscPixel<T>& p) {
          paint(h, p);
        });
      });
}

template <typename T>
int launch_anis(int nside, int n_h, HaloIn in, bf::Curve<T> cp,
                bf::Curve<T> ct,
                const double* mtot, const double* orig, int pixel_size,
                double pixarea, double* acc, void* stream) {
  disc_paint_anis_kernel<T>
      <<<(n_h + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
          nside, n_h, in, cp, ct, mtot, orig, pixel_size != 0, pixarea, acc);
  return int(cudaGetLastError());
}

// Every pixel's (theta, phi) in T, a block a ring: from pix2ang, or with
// per_ring as K13 takes them (its ring's ring_theta, ring_pixel_phi)
template <typename T>
__global__ void pixel_angles_kernel(int N, bool per_ring, T* __restrict__ theta,
                                    T* __restrict__ phi) {
  const int i = blockIdx.x + 1;
  const bf::Ring<T> r = bf::ring_info<T>(N, i);
  for (int j = threadIdx.x; j < r.nr; j += blockDim.x) {
    T th, ph;
    if (per_ring) {
      th = bf::ring_theta<T>(N, i);
      ph = bf::ring_pixel_phi<T>(N, i, j, r.shifted);
    } else {
      bf::pix2ang<T>(N, r.sp + j, th, ph);
    }
    theta[r.sp + j] = th;
    phi[r.sp + j] = ph;
  }
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

// theta, phi: (npix,) in T
#define BF_PIXEL_ANGLES(T, SUF)                                              \
  int bf_pixel_angles_##SUF(int nside, int per_ring, T* theta, T* phi,      \
                            void* stream) {                                 \
    pixel_angles_kernel<T><<<4 * nside - 1, 256, 0, (cudaStream_t)stream>>>( \
        nside, per_ring != 0, theta, phi);                                  \
    return int(cudaGetLastError());                                         \
  }

BF_PIXEL_ANGLES(float, f32)
BF_PIXEL_ANGLES(double, f64)
#undef BF_PIXEL_ANGLES

}  // extern "C"
