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
// Bound: atomics to device memory. Each member pixel costs about 30 flops
// and 3 transcendentals, and two atomicAdds into the (npix, 2) accumulator
// (100 MB in float32 at NSIDE 1024: it misses the 50 MB L2). Design: one
// block per halo, threads across a ring's phi span, so that the atomics of
// a warp land on neighbouring addresses; the halo's curve (64 values) is
// read from L1. Sums by atomics change order from run to run.
//
// Precision follows one_halo under x64 (see healpix.cuh): the geometry is
// in T, the halo's cos/sin of theta are float64 rounded to T, and the
// fallback's haversine is partly float64.

#include "healpix.cuh"

namespace {

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

template <typename T>
__global__ void disc_deposit_kernel(int N, HaloIn in,
                                    const T* __restrict__ curves,
                                    Lookup<T> lk, T* __restrict__ acc) {
  __shared__ int members;
  const int hid = blockIdx.x;
  const double th_h = in.theta[hid];
  const double ph_h = in.phi[hid];
  const double rad_h = in.radius[hid];
  const bf::DiscWalk<T> walk(N, th_h, ph_h, rad_h);
  Halo<T> h;
  h.theta0 = walk.theta0;
  h.ct0 = T(walk.cos_th);
  h.st0 = T(walk.sin_th);
  h.D = T(in.D[hid]);
  h.a = T(in.a[hid]);
  h.Rcom = T(in.Rcom[hid]);
  h.rscale = T(in.rscale[hid]);
  h.curve = curves + (long long)hid * lk.n_r;
  if (threadIdx.x == 0) members = 0;
  __syncthreads();

  // count the disc's members, then deposit them unless there are fewer
  // than 4
  int count = 0;
  walk([&](int, T, T, T, T) { ++count; });
  if (count) atomicAdd(&members, count);
  __syncthreads();
  if (members >= 4) {
    walk([&](int pix, T cos_t, T sin_t, T dphi_pix, T sinhd) {
      deposit_pixel(h, lk, pix, cos_t, sin_t, dphi_pix, sinhd, acc);
    });
    return;
  }

  // fewer than 4 members: the centre's 4 interpolation neighbours
  int pix4[4];
  T w4[4];
  const T phi_w = T(bf::floor_fmod(ph_h, bf::kTwoPi));
  bf::interp_weights<T>(N, h.theta0, phi_w, pix4, w4);
  for (int k = threadIdx.x; k < 4; k += blockDim.x) {
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
}

template <typename T>
int launch(int nside, int n_h, const double* theta, const double* phi,
           const double* radius, const double* D, const double* a,
           const double* Rcom, const double* rscale, const T* curves, int n_r,
           T ln_r0, T dlnr, T eps_max, T* acc, void* stream) {
  HaloIn in{theta, phi, radius, D, a, Rcom, rscale};
  Lookup<T> lk{n_r, ln_r0, dlnr, eps_max};
  disc_deposit_kernel<T><<<n_h, 128, 0, (cudaStream_t)stream>>>(
      nside, in, curves, lk, acc);
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
