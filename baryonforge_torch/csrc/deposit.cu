// K2: disc deposit (scatter phase A).
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py: _make_body_factory's
// one_halo / body (with ops/healpix.py: disc_candidates and
// get_interp_weights, and Profiles/BaryonCorrection.py: curve_lookup).
// For each halo, every pixel whose centre lies inside the disc of angular
// radius `radius` (haversine test sin(d/2) <= sin(radius/2)) receives the
// tangent-angle displacement (d theta, sin theta d phi) of the halo's
// displacement curve; a disc with fewer than 4 member pixels deposits on
// the 4 interpolation neighbours of its centre instead.
//
// The JAX version walks a padded (K_ring, K_phi) window whose size is fixed
// per size bucket, because XLA needs static shapes. Here each halo walks its
// own rings and phi spans (healpix.cuh: DiscWalk), each member pixel
// once; the member set is the JAX window's. The JAX accumulator's dummy row
// at index npix becomes a plain `if`.
//
// Bound: atomics to device memory. Each member pixel costs about 40 flops
// and 3 transcendentals, and two atomicAdds into the (npix, 2) accumulator
// (100 MB in float32 at NSIDE 1024: it misses the 50 MB L2); each ring of
// a disc costs four float64 transcendentals (its phi span). Design: the
// flat disc walk of healpix.cuh, shared with K13. A ring's geometry is
// worked out once, by one thread, into shared memory; a scan of the rings'
// span lengths lays the disc out as one flat (ring, dp) index, and the
// threads walk that index, so every lane holds a candidate pixel whatever
// the rings' lengths, and neighbouring lanes deposit on neighbouring
// addresses. A block takes 8 halos, one a warp (warp_route, which also
// counts the members); a disc of more than 32 rings is walked by the whole
// block, so a large disc is spread over 256 threads and a small one keeps
// a warp busy. Sums by atomics change order from run to run.
//
// Precision follows one_halo under x64 (see healpix.cuh): the geometry is
// in T, the halo's cos/sin of theta are float64 rounded to T, and the
// fallback's haversine is partly float64.

#include "healpix.cuh"

namespace {

constexpr int kWarps = 8;             // halos a block takes, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct HaloIn {
  const double* theta;
  const double* phi;
  const double* radius;
  const double* D;
  const double* a;
  const double* Rcom;
  const double* rscale;
};

// per-halo values every pixel of the halo uses
template <typename T>
struct Halo {
  T theta0, ct0, st0, D, a, Rcom, rscale;
  const T* curve;
};

template <typename T>
struct Lookup {
  int n_r;
  T ln_r0, dlnr, eps_max;
};

// tangent displacement of one pixel (one_halo from `chord` on), added into
// acc[pix]
template <typename T>
__device__ __forceinline__ void deposit_pixel(const Halo<T>& h,
                                              const Lookup<T>& lk, int pix,
                                              T cos_t, T sin_t, T dphi_pix,
                                              T sinhd, T* acc) {
  T chord = T(2) * sinhd;
  T r_com = chord * h.D / h.a;
  T r_safe = r_com > T(0) ? r_com : T(1e-30);
  T rr = r_safe * h.rscale;
  // curve_lookup: log-uniform lerp, zero outside the tabulated range
  T x = (bf::m_log(rr > T(1e-30) ? rr : T(1e-30)) - lk.ln_r0) / lk.dlnr;
  int i = bf::clampi(int(bf::m_floor(x)), 0, lk.n_r - 2);
  T t = x - T(i);
  T d = h.curve[i] * (T(1) - t) + h.curve[i + 1] * t;
  if (x < T(0) || x > T(lk.n_r - 1)) d = T(0);
  if (!(r_com < lk.eps_max * h.Rcom)) d = T(0);
  d = d * h.a;
  if (!isfinite(d)) d = T(0);
  T chord_safe = chord > T(0) ? chord : T(1);
  T amp = d / (h.D * chord_safe);
  T t_th = amp * (h.ct0 * sin_t - h.st0 * cos_t * bf::m_cos(dphi_pix));
  T t_ph = amp * (h.st0 * bf::m_sin(dphi_pix));
  if (!isfinite(t_th)) t_th = T(0);
  if (!isfinite(t_ph)) t_ph = T(0);
  atomicAdd(acc + 2 * (long long)pix, t_th);
  atomicAdd(acc + 2 * (long long)pix + 1, t_ph);
}

// deposit_pixel for a pixel of the flat walk
template <typename T>
__device__ __forceinline__ void deposit(const Halo<T>& h, const Lookup<T>& lk,
                                        const bf::DiscPixel<T>& p, T* acc) {
  deposit_pixel(h, lk, p.pix, p.cos_t, p.sin_t, p.dphi_pix, p.sinhd, acc);
}

template <typename T>
__device__ __forceinline__ Halo<T> make_halo(const HaloIn& in,
                                             const T* curves, int n_r,
                                             int hid,
                                             const bf::DiscWalk<T>& walk) {
  Halo<T> h;
  h.theta0 = walk.theta0;
  h.ct0 = T(walk.cos_th);
  h.st0 = T(walk.sin_th);
  h.D = T(in.D[hid]);
  h.a = T(in.a[hid]);
  h.Rcom = T(in.Rcom[hid]);
  h.rscale = T(in.rscale[hid]);
  h.curve = curves + (long long)hid * n_r;
  return h;
}

// fewer than 4 members: lane k < 4 deposits on the centre's k-th
// interpolation neighbour
template <typename T>
__device__ void deposit_fallback(int N, const Halo<T>& h, const Lookup<T>& lk,
                                 double th_h, double ph_h, int k, T* acc) {
  int pix4[4];
  T w4[4];
  const T phi_w = T(bf::floor_fmod(ph_h, bf::kTwoPi));
  bf::interp_weights<T>(N, h.theta0, phi_w, pix4, w4);
  const int pix = pix4[k];
  T t4, p4;
  bf::pix2ang<T>(N, pix, t4, p4);
  const T cos_t = bf::m_cos(t4), sin_t = bf::m_sin(t4);
  const T dphi_pix = T(double(p4) - ph_h);
  const T sdp = bf::m_sin(T(0.5) * dphi_pix);
  const double sdt = sin(0.5 * (double(t4) - th_h));
  double hav = sdt * sdt + double(sin_t * h.st0 * (sdp * sdp));
  hav = hav < 0.0 ? 0.0 : (hav > 1.0 ? 1.0 : hav);
  deposit_pixel(h, lk, pix, cos_t, sin_t, dphi_pix, T(sqrt(hav)), acc);
}

// A disc of at most kSplitRings rings, on one warp (bf::warp_walk). The
// count of members runs along the walk (ballot and popc); members met while
// it is under 4 (at most 3) are held back by flat index and deposited when
// it reaches 4, or never, and then the disc deposits on the centre's 4
// interpolation neighbours instead.
template <typename T>
__device__ void warp_route(int N, const bf::DiscWalk<T>& walk,
                           const Halo<T>& h, const Lookup<T>& lk,
                           double th_h, double ph_h, bf::DiscRing<T>* rings,
                           int* first, int* held, T* acc) {
  const int lane = threadIdx.x & 31;
  const int n = walk.ring_last - walk.ring_first + 1;
  int count = 0;                   // members so far, the same in every lane
  bf::warp_walk(walk, rings, first,
                [&](bool m, int q, const bf::DiscPixel<T>& p) {
    const unsigned mask = __ballot_sync(kFull, m);
    const int cnt = __popc(mask);
    if (count + cnt >= 4) {
      if (m) deposit(h, lk, p, acc);
      if (count < 4 && lane < count) {
        bf::DiscPixel<T> ph;
        bf::flat_candidate(walk, rings, first, n, held[lane], ph);
        deposit(h, lk, ph, acc);
      }
    } else if (m) {
      held[count + __popc(mask & ((1u << lane) - 1u))] = q;
    }
    count += cnt;
  });
  if (count < 4 && lane < 4)
    deposit_fallback(N, h, lk, th_h, ph_h, lane, acc);
}

// A block takes kWarps halos, one a warp; a disc of more than kSplitRings
// rings is walked by the whole block after the warps' own discs
// (bf::flat_disc_walks), and its members are not counted: its rings
// ring_first .. ring_last - 2 (at least 31) have their centres inside the
// disc's colatitude band, so the radius spans more than 15 ring spacings,
// and a pixel is at most ~2.4 ring spacings wide along its ring (3 pi / 4
// sin^2 theta in the belt, pi / 2 in the caps), so the ring nearest the
// disc centre alone holds more than 4 members
// (tests/test_torch_layout_disc.py checks it at the threshold).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    disc_deposit_kernel(int N, int n_h, HaloIn in,
                        const T* __restrict__ curves, Lookup<T> lk,
                        T* __restrict__ acc) {
  __shared__ bf::FlatDiscs<T, kWarps> s;
  __shared__ int held[kWarps][3];
  bf::flat_disc_walks<kWarps>(
      N, n_h, in.theta, in.phi, in.radius, s,
      [&](int hid, const bf::DiscWalk<T>& walk, bf::DiscRing<T>* rings,
          int* first) {
        warp_route(N, walk, make_halo(in, curves, lk.n_r, hid, walk), lk,
                   in.theta[hid], in.phi[hid], rings, first,
                   held[threadIdx.x >> 5], acc);
      },
      [&](int hid, const bf::DiscWalk<T>& walk) {
        const Halo<T> h = make_halo(in, curves, lk.n_r, hid, walk);
        bf::block_walk<kWarps>(walk, s.rings, s.first, s.wsum,
                               [&](const bf::DiscPixel<T>& p) {
          deposit(h, lk, p, acc);
        });
      });
}

template <typename T>
int launch(int nside, int n_h, const double* theta, const double* phi,
           const double* radius, const double* D, const double* a,
           const double* Rcom, const double* rscale, const T* curves, int n_r,
           T ln_r0, T dlnr, T eps_max, T* acc, void* stream) {
  HaloIn in{theta, phi, radius, D, a, Rcom, rscale};
  Lookup<T> lk{n_r, ln_r0, dlnr, eps_max};
  disc_deposit_kernel<T>
      <<<(n_h + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
          nside, n_h, in, curves, lk, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int bf_disc_deposit_f32(int nside, int n_h, const double* theta,
                        const double* phi, const double* radius,
                        const double* D, const double* a, const double* Rcom,
                        const double* rscale, const float* curves, int n_r,
                        float ln_r0, float dlnr, float eps_max, float* acc,
                        void* stream) {
  return launch<float>(nside, n_h, theta, phi, radius, D, a, Rcom, rscale,
                       curves, n_r, ln_r0, dlnr, eps_max, acc, stream);
}

int bf_disc_deposit_f64(int nside, int n_h, const double* theta,
                        const double* phi, const double* radius,
                        const double* D, const double* a, const double* Rcom,
                        const double* rscale, const double* curves, int n_r,
                        double ln_r0, double dlnr, double eps_max,
                        double* acc, void* stream) {
  return launch<double>(nside, n_h, theta, phi, radius, D, a, Rcom, rscale,
                        curves, n_r, ln_r0, dlnr, eps_max, acc, stream);
}

}  // extern "C"
