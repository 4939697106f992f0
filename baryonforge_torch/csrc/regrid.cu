// K3: scatter regrid (phase B).
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py: _phase_b and
// _phase_b_sparse, with _weights_for / _weights_chunk (and
// ops/healpix.py: get_interp_weights). Each source pixel moves by its
// accumulated tangent offset (d theta, sin theta d phi), is reflected
// through the pole when it overshoots, and its value is shared among the 4
// healpy interpolation neighbours of its new position. A pixel whose offset
// is exactly zero adds its own value to itself, an exact identity.
//
// The JAX version passes the pixel centres in as an argument only to keep
// XLA from constant-folding them at compile time; here each thread computes
// its own centre with pix2ang. The JAX sparse form (compact the moved
// pixels, scatter only those) exists because TPU scatter is serialised; it
// equals the dense form up to summation order, and this one kernel covers
// both: unmoved pixels cost one atomic.
//
// Bound: atomics to device memory. Per source pixel: reads of 2 offsets
// and 1 value, ~10 transcendentals, then 4 atomicAdds (1 when unmoved)
// into the output map (50-100 MB at NSIDE 1024, the size of L2). Design:
// one thread per source pixel in RING order, so neighbouring threads read
// neighbouring offsets and their targets mostly fall on neighbouring
// pixels. float64 atomicAdd is native on sm_90. The offsets come in the
// deposit's dtype P, the map and the weights in the regrid dtype T.

#include "healpix.cuh"

namespace {

template <typename P, typename T>
__global__ void regrid_kernel(int N, int npix, const P* __restrict__ po,
                              const T* __restrict__ orig,
                              T* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const T src = orig[p];
  const P o0 = po[2 * (long long)p], o1 = po[2 * (long long)p + 1];
  if (o0 == P(0) && o1 == P(0)) {
    atomicAdd(out + p, src);
    return;
  }
  T theta_p, phi_p;
  bf::pix2ang<T>(N, p, theta_p, phi_p);
  const T sin_t = bf::m_sin(theta_p);
  const T sin_safe = sin_t > T(1e-12) ? sin_t : T(1);
  T theta = theta_p + T(o0);
  T phi = phi_p + T(o1) / sin_safe;
  // a pole overshoot passes through the pole: reflect theta, turn phi by pi
  const bool over = theta < T(0) || theta > T(bf::kPi);
  theta = bf::m_fabs(theta);
  if (theta > T(bf::kPi)) theta = T(bf::kTwoPi) - theta;
  if (over) phi = phi + T(bf::kPi);
  phi = bf::floor_fmod(phi, T(bf::kTwoPi));
  int pix[4];
  T w[4];
  bf::interp_weights<T>(N, theta, phi, pix, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) atomicAdd(out + pix[k], w[k] * src);
}

template <typename P, typename T>
int launch(int nside, const P* po, const T* orig, T* out, void* stream) {
  const int npix = 12 * nside * nside;
  const int threads = 256;
  regrid_kernel<P, T><<<(npix + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(nside, npix, po, orig, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int bf_regrid_f32_f32(int nside, const float* po, const float* orig,
                      float* out, void* stream) {
  return launch<float, float>(nside, po, orig, out, stream);
}

int bf_regrid_f32_f64(int nside, const float* po, const double* orig,
                      double* out, void* stream) {
  return launch<float, double>(nside, po, orig, out, stream);
}

int bf_regrid_f64_f32(int nside, const double* po, const float* orig,
                      float* out, void* stream) {
  return launch<double, float>(nside, po, orig, out, stream);
}

int bf_regrid_f64_f64(int nside, const double* po, const double* orig,
                      double* out, void* stream) {
  return launch<double, double>(nside, po, orig, out, stream);
}

}  // extern "C"
