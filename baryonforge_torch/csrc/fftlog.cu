// K8: the FFTLog discrete Hankel transform, float64.
//
// Replaces baryonforge_tpu/ops/fftlog.py: fht (with _u_coefficients and the
// f64-pair complex log-gamma, reached through cosmo/power.py:
// correlation_3d for the TwoHalo term and through the profiles' Fourier and
// projection transforms). For each row a_j of a (B, N) batch on the
// log-uniform grid lx (N):
//   b_j = a_j exp(-q (lx_j - lx_0))
//   c_m = sum_j b_j exp(-2 pi i (j m mod N) / N)              (forward DFT)
//   d_m = (c_m / N) U_mu(q + i w_m) (k0 x0)^(-i w_m)
//   o_n = Re sum_m d_m exp(-2 pi i (m n mod N) / N)          (forward again,
//         as the JAX function applies its _dft_pair twice)
//   out_n = exp(-q (ln k0x0 + n dln)) o_n
// with m the signed frequency fftfreq(N) * N, w_m = 2 pi m / (N dln), and
// U_mu from the Lanczos log-gamma (g = 7, n = 9) with the reflection below
// Re z = 1/2 and the overflow-safe log sin(pi z) for |Im z| > 1.
//
// Bound: operations. A direct DFT of N points is N^2 complex multiply-adds
// (N = 1024 for correlation_3d's P(k) grid), against 16 N bytes of input
// and output per row, all in float64 (the phases w ln(k0 x0) reach
// thousands of radians). Design: one block per row; the N twiddles
// (cos, sin of 2 pi k / N) sit in shared memory and the exact integer phase
// index (j m mod N) is carried by adding m each step, so any N works; each
// thread owns output frequencies, reads b_j (or d_m) as a broadcast and
// accumulates in registers, in chunks of 32 terms (a sequential sum of N
// terms would lose ~N ulps against an FFT's ~log N). The row's b and d
// live in a global scratch (B, 3, N) that the wrapper allocates. A later PR
// can replace the direct sums by a radix FFT.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kPi = 3.141592653589793;
constexpr double kLn2 = 0.6931471805599453;
constexpr double kLanczosG = 7.0;
// the DFT sums add their terms in chunks of kChunk, then the chunks: the
// rounding error grows as kChunk + N / kChunk instead of N
constexpr int kChunk = 32;
__constant__ double kLanczos[9] = {
    0.99999999999980993,  676.5203681218851,     -1259.1392167224028,
    771.32342877765313,   -176.61502916214059,   12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7};

struct C {
  double re, im;
};

__device__ __forceinline__ C cdiv(C a, C b) {
  const double d = b.re * b.re + b.im * b.im;
  return {(a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d};
}

__device__ __forceinline__ C clog(C a) {
  return {0.5 * log(a.re * a.re + a.im * a.im), atan2(a.im, a.re)};
}

__device__ __forceinline__ double sign_of(double v) {
  return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : v);  // keeps 0 and NaN
}

// log(sin(pi z)), overflow-safe for large |Im z|
__device__ C log_sin_pi(double zr, double zi) {
  const double zia = fabs(zi);
  if (zia > 1.0) {
    const double e = exp(-2.0 * kPi * zia);
    const C l1 = clog({1.0 - e * cos(2.0 * kPi * zr),
                       -e * sin(2.0 * kPi * zr)});
    const double sr = kPi * zia - kLn2 + l1.re;
    const double si = (0.5 * kPi - kPi * zr) + l1.im;
    return {sr, sign_of(zi) * si};
  }
  const double zc = fmin(fmax(zi, -2.0), 2.0);
  return clog({sin(kPi * zr) * cosh(kPi * zc), cos(kPi * zr) * sinh(kPi * zc)});
}

// principal-branch log Gamma(zr + i zi)
__device__ C loggamma(double zr, double zi) {
  const bool reflect = zr < 0.5;
  const double sr = reflect ? 1.0 - zr : zr;
  const double si = reflect ? -zi : zi;
  const double wr = sr - 1.0, wi = si;
  C x = {kLanczos[0], 0.0};
  for (int i = 1; i < 9; ++i) {
    const C t = cdiv({kLanczos[i], 0.0}, {wr + i, wi});
    x.re = x.re + t.re;
    x.im = x.im + t.im;
  }
  const double tr = wr + kLanczosG + 0.5, ti = wi;
  const C lt = clog({tr, ti});
  const C lx = clog(x);
  const double lgr = 0.5 * log(2.0 * kPi) + (wr + 0.5) * lt.re - ti * lt.im -
                     tr + lx.re;
  const double lgi = (wr + 0.5) * lt.im + ti * lt.re - ti + lx.im;
  if (!reflect) return {lgr, lgi};
  const C ls = log_sin_pi(zr, zi);
  return {log(kPi) - ls.re - lgr, -ls.im - lgi};
}

__global__ void fht_kernel(int N, const double* __restrict__ a,
                           const double* __restrict__ lx, double mu, double q,
                           double ln_kcrc, double* __restrict__ scratch,
                           double* __restrict__ out) {
  extern __shared__ double tw[];  // cos [0, N), sin [N, 2N)
  const int row = blockIdx.x;
  const double* ar = a + (long long)row * N;
  double* b = scratch + (long long)row * 3 * N;
  double* dr = b + N;
  double* di = b + 2 * N;
  double* o = out + (long long)row * N;
  const double lx0 = lx[0], lxn = lx[N - 1];
  const double dln = (lxn - lx0) / (N - 1);
  const double ln_k0x0 = ln_kcrc - lxn + lx0;

  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    double s, c;
    sincospi(2.0 * k / N, &s, &c);
    tw[k] = c;
    tw[N + k] = s;
    b[k] = ar[k] * exp(-q * (lx[k] - lx0));
  }
  __syncthreads();

  for (int m = threadIdx.x; m < N; m += blockDim.x) {
    double sr = 0.0, si = 0.0, pr = 0.0, pi = 0.0;
    int idx = 0;
    for (int j = 0; j < N; ++j) {
      const double bj = b[j];
      pr = pr + bj * tw[idx];
      pi = pi + bj * tw[N + idx];
      if ((j & (kChunk - 1)) == kChunk - 1) {
        sr = sr + pr;
        si = si + pi;
        pr = pi = 0.0;
      }
      idx += m;
      if (idx >= N) idx -= N;
    }
    sr = sr + pr;
    si = si + pi;
    const double cr = sr / N, ci = -si / N;
    // the signed frequency, with fftfreq's rounding
    const int ms = m <= (N - 1) / 2 ? m : m - N;
    const double mf = ((double)ms / (double)N) * N;
    const double omega = 2.0 * kPi * mf / (N * dln);
    const C g1 = loggamma((mu + 1.0 + q) / 2.0, omega / 2.0);
    const C g2 = loggamma((mu + 1.0 - q) / 2.0, -omega / 2.0);
    const double er = q * kLn2 + g1.re - g2.re;
    const double ei = omega * kLn2 + g1.im - g2.im - omega * ln_k0x0;
    const double e = exp(er);
    const double ur = e * cos(ei), ui = e * sin(ei);
    dr[m] = cr * ur - ci * ui;
    di[m] = cr * ui + ci * ur;
  }
  __syncthreads();

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    double s = 0.0, p = 0.0;
    int idx = 0;
    for (int m = 0; m < N; ++m) {
      p = p + (dr[m] * tw[idx] + di[m] * tw[N + idx]);
      if ((m & (kChunk - 1)) == kChunk - 1) {
        s = s + p;
        p = 0.0;
      }
      idx += n;
      if (idx >= N) idx -= N;
    }
    s = s + p;
    o[n] = exp(-q * (ln_k0x0 + n * dln)) * s;
  }
}

}  // namespace

extern "C" {

// a, out: (B, N) float64; lx: (N,) the log grid; scratch: (B, 3, N)
int bf_fht_f64(int B, int N, const double* a, const double* lx, double mu,
               double q, double ln_kcrc, double* scratch, double* out,
               void* stream) {
  if (N < 2) return int(cudaErrorInvalidValue);
  const size_t shmem = size_t(2) * N * sizeof(double);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
    if (e != cudaSuccess) return int(e);
  }
  fht_kernel<<<B, 256, shmem, (cudaStream_t)stream>>>(N, a, lx, mu, q,
                                                      ln_kcrc, scratch, out);
  return int(cudaGetLastError());
}

}  // extern "C"
