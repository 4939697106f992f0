// K8: the FFTLog discrete Hankel transform, float64.
//
// Replaces baryonforge_tpu/ops/fftlog.py: fht (with _u_coefficients and the
// f64-pair complex log-gamma, reached through cosmo/power.py:
// correlation_3d for the TwoHalo term and through the profiles' Fourier and
// projection transforms). For each row a_j of a (B, N) batch on the
// log-uniform grid x (N), lx = ln x:
//   b_j = a_j exp(-q (lx_j - lx_0))
//   c_m = sum_j b_j exp(-2 pi i (j m mod N) / N)              (forward DFT)
//   d_m = (c_m / N) U_mu(q + i w_m) (k0 x0)^(-i w_m)
//   o_n = Re sum_m d_m exp(-2 pi i (m n mod N) / N)          (forward again,
//         as the JAX function applies its _dft_pair twice)
//   out_n = exp(-q (ln k0x0 + n dln)) o_n
// with m the signed frequency fftfreq(N) * N, w_m = 2 pi m / (N dln), and
// U_mu from the Lanczos log-gamma (g = 7, n = 9) with the reflection below
// Re z = 1/2 and the overflow-safe log sin(pi z) for |Im z| > 1; and the
// output grid k_n = exp(ln kcrc - lx_{N-1} + n dln), written by block 0,
// so that an fht call on the card is this one launch.
//
// Bound: operations. Two FFTs of ~5 N log2 N float64 operations a row and
// ~450 a distinct frequency for the coefficients (two log-gammas with
// their complex logs, a complex exponential), against 16 N bytes a row of
// input and output; everything in float64 (the phases w ln(k0 x0) reach
// thousands of radians). Design: one block a row; both DFTs are the FFT of
// csrc/fft.cuh (K18's) on the row's arrays in shared memory: 4 M doubles
// (the points, Re and Im, and the twiddles) with M = N for a power of two,
// else Bluestein's chirp convolution with M >= 2 N - 1 and 6 M doubles (the
// chirp's spectrum too, formed once a block and used by both DFTs). A row
// too long for the shared memory a block may have (on the H100 a power of
// two over 4096, any other N over 2048) runs the same code on a slot of
// device memory, at most kLongBlocks blocks walking the rows (as many as
// the wrapper's slots: it sizes them to the free memory). A slot's arrays
// are addressed from 64-bit offsets, so M may reach 2^30 points (a slot of
// 32 GiB, 48 GiB with Bluestein's chirp); the indices inside an array stay
// below M. The wrapper takes M up to ops.fftlog.FHT_MAX_M (2^27), the
// longest FFT held against its plain version on the card.
// The second forward DFT of a power-of-two row comes from the inverse FFT:
// Re DFT(d) = Re conj(IDFT(conj d)) = Re IDFT(conj d), so each d_m is
// conjugated where the forward FFT left c_m (bit-reversed order) and
// ifft_dit brings the sums back in natural order. Bluestein's route runs
// its forward chirp transform twice.
// The coefficients: U at frequency -m is the conjugate of U at m (mu and q
// are real), so a thread forms U for the pair m, N - m at once, m = 0 .. N
// / 2; N / 2 of an even N, which fftfreq gives the frequency -N / 2, has no
// partner and is formed alone. Each coefficient is applied in place to the
// row's c as soon as it is formed.

#include "fft.cuh"

namespace {

using bf::swz;

constexpr double kPi = 3.141592653589793;
constexpr double kLn2 = 0.6931471805599453;
constexpr double kLanczosG = 7.0;
constexpr int kThreads = 512;
constexpr int kLongBlocks = 132;  // blocks of the device-memory route
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

// U_mu(q + i w_m) (k0 x0)^(-i w_m) of frequency index m < N
__device__ C coefficient(int m, int N, double dln, double mu, double q,
                         double ln_k0x0) {
  // the signed frequency, with fftfreq's rounding
  const int ms = m <= (N - 1) / 2 ? m : m - N;
  const double mf = ((double)ms / (double)N) * N;
  const double omega = 2.0 * kPi * mf / (N * dln);
  const C g1 = loggamma((mu + 1.0 + q) / 2.0, omega / 2.0);
  const C g2 = loggamma((mu + 1.0 - q) / 2.0, -omega / 2.0);
  const double er = q * kLn2 + g1.re - g2.re;
  const double ei = omega * kLn2 + g1.im - g2.im - omega * ln_k0x0;
  const double e = exp(er);
  return {e * cos(ei), e * sin(ei)};
}

// (c / N) u
__device__ __forceinline__ C scaled(double cr, double ci, int N, C u) {
  cr = cr / N;
  ci = ci / N;
  return {cr * u.re - ci * u.im, cr * u.im + ci * u.re};
}

// Bluestein's product of the row's spectrum with the chirp's, then the
// inverse FFT: natural order out, M times the circular convolution
__device__ void convolve(double* re, double* im, const double* br,
                         const double* bi, const double* twr,
                         const double* twi, int M) {
  bf::fft_dif(re, im, twr, twi, M);
  for (int e = threadIdx.x; e < M; e += blockDim.x) {
    const double ur = re[e], ui = im[e], vr = br[e], vi = bi[e];
    re[e] = ur * vr - ui * vi;
    im[e] = ur * vi + ui * vr;
  }
  __syncthreads();
  bf::ifft_dit(re, im, twr, twi, M);
}

// Rows row = blockIdx.x, + gridDim.x, ... of B; buf is shared memory, or
// with scratch a slot of `slot` doubles a block.
template <bool kBluestein>
__global__ void __launch_bounds__(kThreads)
fht_kernel(int B, int N, int M, const double* __restrict__ a,
           const double* __restrict__ x, double mu, double q,
           double ln_kcrc, double* scratch, long long slot,
           double* __restrict__ k, double* __restrict__ out) {
  extern __shared__ double smem[];
  double* buf = scratch ? scratch + (long long)blockIdx.x * slot : smem;
  const long long lm = M;
  double *re = buf, *im = buf + lm, *twr = buf + 2 * lm, *twi = buf + 3 * lm;
  double *br = buf + 4 * lm, *bi = buf + 5 * lm;  // Bluestein: chirp spectrum
  const double lx0 = log(x[0]), lxn = log(x[N - 1]);
  const double dln = (lxn - lx0) / (N - 1);
  const double ln_k0x0 = ln_kcrc - lxn + lx0;
  const int lg = __ffs(M) - 1;
  const double inv_m = 1.0 / double(M);
  if (blockIdx.x == 0) {
    for (int n = threadIdx.x; n < N; n += blockDim.x)
      k[n] = exp(ln_kcrc - lxn + n * dln);
  }

  bf::make_twiddles(twr, twi, M);
  if (kBluestein) {
    // b_m = conj chirp at m and M - m, m < N
    for (int e = threadIdx.x; e < M; e += blockDim.x) {
      const int m = e < N ? e : (e > M - N ? M - e : -1);
      double c = 0.0, s = 0.0;
      if (m >= 0) {
        bf::chirp(m, N, &c, &s);
        s = -s;
      }
      br[swz(e)] = c;
      bi[swz(e)] = s;
    }
    __syncthreads();
    bf::fft_dif(br, bi, twr, twi, M);
  }

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const double* ar = a + (long long)row * N;
    // the biased row (times the chirp for Bluestein), zero past N
    for (int j = threadIdx.x; j < M; j += blockDim.x) {
      double xr = 0.0, xi = 0.0;
      if (j < N) {
        const double bj = ar[j] * exp(-q * (log(x[j]) - lx0));
        if (kBluestein) {
          double c, s;
          bf::chirp(j, N, &c, &s);
          xr = bj * c;
          xi = bj * s;
        } else {
          xr = bj;
        }
      }
      re[swz(j)] = xr;
      im[swz(j)] = xi;
    }
    __syncthreads();

    // c = DFT(b): bit-reversed order (a power of two), or chirp_k M conv_k
    // in natural order (Bluestein)
    if (kBluestein)
      convolve(re, im, br, bi, twr, twi, M);
    else
      bf::fft_dif(re, im, twr, twi, M);

    // d_m = (c_m / N) U_m in place: conjugated for the inverse FFT, or
    // times the chirp as the second Bluestein transform's input
    auto apply = [&](int m, C u) {
      if (kBluestein) {
        const int e = swz(m);
        double c, s;
        bf::chirp(m, N, &c, &s);
        const double cr = re[e] * inv_m, ci = im[e] * inv_m;
        const C d = scaled(cr * c - ci * s, cr * s + ci * c, N, u);
        re[e] = d.re * c - d.im * s;
        im[e] = d.re * s + d.im * c;
      } else {
        const int e = swz(int(__brev(unsigned(m)) >> (32 - lg)));  // M >= 2
        const C d = scaled(re[e], im[e], N, u);
        re[e] = d.re;
        im[e] = -d.im;
      }
    };
    for (int t = threadIdx.x; 2 * t <= N; t += blockDim.x) {
      const C u = coefficient(t, N, dln, mu, q, ln_k0x0);
      apply(t, u);
      if (t > 0 && 2 * t < N) apply(N - t, {u.re, -u.im});
    }
    if (kBluestein) {
      for (int j = N + threadIdx.x; j < M; j += blockDim.x) {
        re[swz(j)] = 0.0;
        im[swz(j)] = 0.0;
      }
    }
    __syncthreads();

    // o = Re DFT(d), natural order
    if (kBluestein)
      convolve(re, im, br, bi, twr, twi, M);
    else
      bf::ifft_dit(re, im, twr, twi, M);
    double* o = out + (long long)row * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const int e = swz(n);
      double v;
      if (kBluestein) {
        double c, s;
        bf::chirp(n, N, &c, &s);
        v = (re[e] * inv_m) * c - (im[e] * inv_m) * s;
      } else {
        v = re[e];
      }
      o[n] = exp(-q * (ln_k0x0 + n * dln)) * v;
    }
    __syncthreads();  // the buffer is the next row's
  }
}

template <bool kBluestein>
int launch(int B, int N, int M, bool in_shared, int slots, const double* a,
           const double* x, double mu, double q, double ln_kcrc,
           double* scratch, double* k, double* out, cudaStream_t stream) {
  const long long slot = (kBluestein ? 6LL : 4LL) * M;
  if (in_shared) {
    const size_t smem = sizeof(double) * size_t(slot);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fht_kernel<kBluestein>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(smem));
      if (e != cudaSuccess) return int(e);
    }
    fht_kernel<kBluestein><<<max(B, 1), kThreads, smem, stream>>>(
        B, N, M, a, x, mu, q, ln_kcrc, nullptr, 0, k, out);
  } else {
    if (scratch == nullptr || slots < 1 || slots > kLongBlocks)
      return int(cudaErrorInvalidValue);
    const int blocks = min(max(B, 1), slots);
    fht_kernel<kBluestein><<<blocks, kThreads, 0, stream>>>(
        B, N, M, a, x, mu, q, ln_kcrc, scratch, slot, k, out);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, out: (B, N) float64; x: (N,) the log-uniform grid; k: (N,) the output
// grid k_n = exp(ln_kcrc - ln x_{N-1} + n dln), written by block 0 (one
// block runs when B is 0).
// M and the route from ops.fftlog.fht_plan: M = N for a power of two,
// else Bluestein's (the least power of two >= 2 N - 1); in_shared puts the
// row's arrays in shared memory, else scratch holds `slots` slots (1 to
// kLongBlocks) of 4 M doubles (6 M for Bluestein), and min(max(B, 1),
// slots) blocks walk the rows
int bf_fht_f64(int B, int N, int M, int bluestein, int in_shared, int slots,
               const double* a, const double* x, double mu, double q,
               double ln_kcrc, double* scratch, double* k, double* out,
               void* stream) {
  // int indices inside an array of M points, 64-bit offsets between them
  const bool pow2 = M >= 2 && M <= (1 << 30) && (M & (M - 1)) == 0;
  if (B < 0 || N < 2 || !pow2 || (bluestein ? M < 2LL * N - 1 : M != N))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  return bluestein ? launch<true>(B, N, M, in_shared != 0, slots, a, x, mu,
                                  q, ln_kcrc, scratch, k, out, s)
                   : launch<false>(B, N, M, in_shared != 0, slots, a, x, mu,
                                   q, ln_kcrc, scratch, k, out, s);
}

int bf_fht_long_blocks(void) { return kLongBlocks; }

}  // extern "C"
