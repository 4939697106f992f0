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
// output grid k_n = exp(ln kcrc - lx_{N-1} + n dln).
//
// Bound: operations. Two FFTs of ~5 N log2 N float64 operations a row and
// ~450 a distinct frequency for the coefficients (two log-gammas with
// their complex logs, a complex exponential), against 16 N bytes a row of
// input and output; everything in float64 (the phases w ln(k0 x0) reach
// thousands of radians).
//
// The routes, chosen by ops.fftlog.fht_plan from the shapes and the card:
//
// One block a row (fht_kernel): both DFTs are the FFT of csrc/fft.cuh
// (K18's) on the row's arrays in shared memory: 4 M doubles (the points,
// Re and Im, and the twiddles) with M = N for a power of two, else
// Bluestein's chirp convolution with M >= 2 N - 1 and 6 M doubles (the
// chirp's spectrum too, formed once a block and used by both DFTs): on the
// H100 a power of two up to 4096 points, any other N up to 2048. The same
// code runs on slots of device memory (at most kLongBlocks blocks walking
// the rows) for a batch of rows for every SM, each a power of two of 8192
// points, where it beats the passes. One launch a call, the k grid written
// by block 0.
//
// Longer rows on the whole card, in passes over device memory
// (fht_setup, fht_pass, fht_coeff; a launch each). The FFT of M = 2^k
// points is split into passes of radices R_0 .. R_{P-1} (M their product;
// ops.fftlog.fht_passes: the last pass's R is the Q = min(M, 4096) points
// a block holds, the others at most 1024): pass p cuts the row into
// segments of L_p = R_p S_p points (S_p the product of the later radices)
// and runs a DFT of R_p points down each of a segment's S_p columns
// (stride S_p), then multiplies output k of column c by e^{-2 pi i c k /
// L_p} (the four-step twiddle; none in the last pass, where S = 1). A
// block holds T = Q / R_p neighbouring columns, interleaved in shared
// memory (element j of column s at j T + s), so each load and store of a
// row of T points is contiguous in device memory, and runs their DFTs as
// fft.cuh's transform with tb = log2 T; it reads and writes its Q points
// once, in place. After the P passes, frequency m = sum k_p R_0 .. R_{p-1}
// sits at position sum k_p S_p (the digits reversed); the inverse passes
// (p = P - 1 .. 0: the conjugate twiddle, then the inverse DFTs) take that
// order back to natural order. Each pass is one launch over every SM. The
// bias is applied as the first pass loads the row, the unbias (and for
// Bluestein the chirp) as the last inverse pass stores it; the
// coefficients are a pass of their own (fht_coeff), a thread a pair m, N -
// m as below; Bluestein's product with the chirp's spectrum is applied as
// the first inverse pass loads; fht_setup writes the k grid, the
// sub-transforms' twiddle table (Q - 1 entries, read from device memory)
// and, for Bluestein, the chirp sequence whose spectrum the forward passes
// then form once a call. Scratch: 16 M bytes a row (Re and Im), 16 M more
// for the chirp's spectrum; rows go in groups of as many as the free
// memory holds (ops.fftlog.fht_slots). Indices into a row are 64-bit.
//
// Every route: the second forward DFT of a power-of-two row comes from the
// inverse FFT: Re DFT(d) = Re conj(IDFT(conj d)) = Re IDFT(conj d), so each
// d_m is conjugated where the forward FFT left c_m and the inverse brings
// the sums back in natural order. Bluestein's route runs its forward chirp
// transform twice. Every phase is an exact integer index into sincospi.
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
__device__ C coefficient(long long m, long long N, double dln, double mu,
                         double q, double ln_k0x0) {
  // the signed frequency, with fftfreq's rounding
  const long long ms = m <= (N - 1) / 2 ? m : m - N;
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
__device__ __forceinline__ C scaled(double cr, double ci, long long N, C u) {
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

// ---------------------------------------------------------------------
// The route over the whole card: passes over device memory.

// a pass's block (with 256 threads the passes ran 4-13% slower on the
// H100: chip_probes.py K8), and the set-up's and the coefficients'
constexpr int kPassThreads = 512;
constexpr int kCoeffThreads = 256;
constexpr int kMaxLgQ = 12;  // points a block: 2 Q doubles of shared memory

struct Grid {  // the log grid's scalars, as fht_kernel forms them
  double lx0, lxn, dln, ln_k0x0;
};

__device__ __forceinline__ Grid grid_of(const double* x, long long N,
                                        double ln_kcrc) {
  Grid g;
  g.lx0 = log(x[0]);
  g.lxn = log(x[N - 1]);
  g.dln = (g.lxn - g.lx0) / (N - 1);
  g.ln_k0x0 = ln_kcrc - g.lxn + g.lx0;
  return g;
}

// log2 R_p of pass p, from the passes' radices packed 6 bits each
__device__ __forceinline__ int lg_of(long long lgs, int p) {
  return int((lgs >> (6 * p)) & 63);
}

// the frequency at position pos after the forward passes, and back: digit
// k_p of pass p has weight R_0 .. R_{p-1} in the frequency and S_p in the
// position
__device__ long long freq_of(long long pos, int P, long long lgs, int lgM) {
  long long m = 0;
  int w = 0, sh = lgM;
  for (int p = 0; p < P; ++p) {
    const int l = lg_of(lgs, p);
    sh -= l;
    m |= ((pos >> sh) & ((1LL << l) - 1)) << w;
    w += l;
  }
  return m;
}

__device__ long long pos_of(long long m, int P, long long lgs, int lgM) {
  long long pos = 0;
  int w = 0, sh = lgM;
  for (int p = 0; p < P; ++p) {
    const int l = lg_of(lgs, p);
    sh -= l;
    pos |= ((m >> w) & ((1LL << l) - 1)) << sh;
    w += l;
  }
  return pos;
}

// the k grid, the twiddle table of the sub-transforms (nt - 1 entries,
// make_twiddles' layout) and, for Bluestein, the conjugate chirp at m and M
// - m (m < N) in natural order, the input of its spectrum's passes
__global__ void __launch_bounds__(kCoeffThreads)
fht_setup(long long N, long long M, int nt, int bluestein,
          const double* __restrict__ x, double ln_kcrc, double* twr,
          double* twi, double* br, double* bi, double* __restrict__ k) {
  const Grid gr = grid_of(x, N, ln_kcrc);
  long long total = N > nt - 1 ? N : nt - 1;
  if (bluestein && M > total) total = M;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < nt - 1) {
      const int ei = int(e), h = 1 << (31 - __clz(ei + 1));
      double sn, cs;
      sincospi(double(ei + 1 - h) / double(h), &sn, &cs);
      twr[e] = cs;
      twi[e] = -sn;
    }
    if (e < N) k[e] = exp(ln_kcrc - gr.lxn + e * gr.dln);
    if (bluestein && e < M) {
      const long long m = e < N ? e : (e > M - N ? M - e : -1);
      double cs = 0.0, sn = 0.0;
      if (m >= 0) {
        bf::chirp(m, N, &cs, &sn);
        sn = -sn;
      }
      br[e] = cs;
      bi[e] = sn;
    }
  }
}

// the input of the first forward pass
enum { kScratch = 0, kBias = 1, kBiasChirp = 2 };
// the output of the last inverse pass
enum { kOutPow2 = 1, kOutChirp = 2 };

// One pass of G rows of M points (scratch re, im: row g at g M): radix R =
// 2^lgR, column stride S, Q = 2^lgQ points (T = Q / R columns) a block,
// M / Q blocks a row. kFwd: load (kIO: the scratch, or the biased input a
// with or without the chirp), DFTs, twiddle, store in place. Else: load,
// times the chirp's spectrum (spr, spi; when given), conjugate twiddle,
// inverse DFTs, store (kIO: in place, or the unbiased output).
template <bool kFwd, int kIO>
__global__ void __launch_bounds__(kPassThreads)
fht_pass(long long N, long long M, int lgR, int lgQ, long long S,
         const double* __restrict__ a, const double* __restrict__ x,
         double q, double ln_kcrc, const double* __restrict__ twr,
         const double* __restrict__ twi, const double* __restrict__ spr,
         const double* __restrict__ spi, double* re, double* im,
         double* __restrict__ out) {
  extern __shared__ double smem[];
  const int Q = 1 << lgQ, tb = lgQ - lgR, T = 1 << tb;
  double *zr = smem, *zi = smem + Q;
  const long long bpr = M >> lgQ;  // blocks a row
  const long long g = blockIdx.x / bpr, b = blockIdx.x % bpr;
  const long long groups = S >> tb;  // column groups a segment
  // element (s, j) of the block at index first + s + S j of the row
  const long long first = (b / groups) * (S << lgR) + (b % groups) * T;
  const long long c0 = (b % groups) * T;  // its first column
  const long long L = S << lgR;
  double* rr = re + g * M;
  double* ri = im + g * M;
  const bool twiddle = S > 1;

  if (kFwd) {
    Grid gr;
    if (kIO != kScratch) gr = grid_of(x, N, ln_kcrc);
    for (int e = threadIdx.x; e < Q; e += blockDim.x) {
      const long long n = first + (e & (T - 1)) + S * (e >> tb);
      double vr = 0.0, vi = 0.0;
      if (kIO == kScratch) {
        vr = rr[n];
        vi = ri[n];
      } else if (n < N) {
        const double bj = a[g * N + n] * exp(-q * (log(x[n]) - gr.lx0));
        if (kIO == kBiasChirp) {
          double cs, sn;
          bf::chirp(n, N, &cs, &sn);
          vr = bj * cs;
          vi = bj * sn;
        } else {
          vr = bj;
        }
      }
      zr[bf::swz(e)] = vr;
      zi[bf::swz(e)] = vi;
    }
    __syncthreads();
    bf::fft_dif(zr, zi, twr, twi, Q, tb);
    for (int e = threadIdx.x; e < Q; e += blockDim.x) {
      const int s = e & (T - 1), kk = e >> tb;
      const int src =
          bf::swz(int((__brev(unsigned(kk)) >> (32 - lgR)) << tb) | s);
      double vr = zr[src], vi = zi[src];
      if (twiddle) {  // times e^{-2 pi i c k / L}, c k < L
        double sn, cs;
        sincospi(double(2 * (c0 + s) * kk) / double(L), &sn, &cs);
        const double wr = vr * cs + vi * sn;
        vi = vi * cs - vr * sn;
        vr = wr;
      }
      const long long n = first + s + S * kk;
      rr[n] = vr;
      ri[n] = vi;
    }
  } else {
    for (int e = threadIdx.x; e < Q; e += blockDim.x) {
      const int s = e & (T - 1), kk = e >> tb;
      const long long n = first + s + S * kk;
      double vr = rr[n], vi = ri[n];
      if (spr != nullptr) {
        const double ur = vr, ui = vi, sr = spr[n], si = spi[n];
        vr = ur * sr - ui * si;
        vi = ur * si + ui * sr;
      }
      if (twiddle) {  // times e^{+2 pi i c k / L}
        double sn, cs;
        sincospi(double(2 * (c0 + s) * kk) / double(L), &sn, &cs);
        const double wr = vr * cs - vi * sn;
        vi = vi * cs + vr * sn;
        vr = wr;
      }
      const int dst =
          bf::swz(int((__brev(unsigned(kk)) >> (32 - lgR)) << tb) | s);
      zr[dst] = vr;
      zi[dst] = vi;
    }
    __syncthreads();
    bf::ifft_dit(zr, zi, twr, twi, Q, tb);
    Grid gr;
    if (kIO != kScratch) gr = grid_of(x, N, ln_kcrc);
    const double inv_m = 1.0 / double(M);
    for (int e = threadIdx.x; e < Q; e += blockDim.x) {
      const long long n = first + (e & (T - 1)) + S * (e >> tb);
      const double vr = zr[bf::swz(e)], vi = zi[bf::swz(e)];
      if (kIO == kScratch) {
        rr[n] = vr;
        ri[n] = vi;
      } else if (n < N) {
        double v = vr;
        if (kIO == kOutChirp) {
          double cs, sn;
          bf::chirp(n, N, &cs, &sn);
          v = (vr * inv_m) * cs - (vi * inv_m) * sn;
        }
        out[g * N + n] = exp(-q * (gr.ln_k0x0 + n * gr.dln)) * v;
      }
    }
  }
}

// The coefficients of G rows in place. A power of two (N = M): the rows
// hold c in the passes' order; a thread takes a position whose frequency m
// is below N / 2 (the last pass's digit, the position's lowest, below R /
// 2: runs of R / 2 neighbours), forms U for m and applies it there and,
// conjugated, at -m's position (m = 0: N / 2 instead, alone). Bluestein:
// the rows hold M times the circular convolution in natural order; a
// thread takes m = 0 .. N / 2 and N - m, as fht_kernel, or zeroes a point
// past N. Two log-gammas a thread take ~220 registers; capped at 128 (two
// blocks an SM, a few spills) the call runs 4-17% faster on the H100 than
// uncapped, and 2-20% faster than capped for three (chip_probes.py K8).
template <bool kBluestein>
__global__ void __launch_bounds__(kCoeffThreads, 2)
fht_coeff(int G, long long N, long long M, int P, long long lgs,
          const double* __restrict__ x, double mu, double q, double ln_kcrc,
          double* re, double* im) {
  const Grid gr = grid_of(x, N, ln_kcrc);
  const int lgM = 63 - __clzll(M);
  const double inv_m = 1.0 / double(M);
  const long long half = N / 2 + 1;
  const long long per = kBluestein ? half + (M - N) : M / 2;
  const int lgl = lg_of(lgs, P - 1);
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < per * G; t += (long long)gridDim.x * blockDim.x) {
    const long long g = t / per, r = t % per;
    double* zr = re + g * M;
    double* zi = im + g * M;
    auto apply = [&](long long m, long long e, C u) {
      if (kBluestein) {
        double cs, sn;
        bf::chirp(m, N, &cs, &sn);
        const double cr = zr[e] * inv_m, ci = zi[e] * inv_m;
        const C d = scaled(cr * cs - ci * sn, cr * sn + ci * cs, N, u);
        zr[e] = d.re * cs - d.im * sn;
        zi[e] = d.re * sn + d.im * cs;
      } else {
        const C d = scaled(zr[e], zi[e], N, u);
        zr[e] = d.re;
        zi[e] = -d.im;
      }
    };
    if (kBluestein) {
      if (r < half) {
        const C u = coefficient(r, N, gr.dln, mu, q, gr.ln_k0x0);
        apply(r, r, u);
        if (r > 0 && 2 * r < N) apply(N - r, N - r, {u.re, -u.im});
      } else {
        zr[N + r - half] = 0.0;
        zi[N + r - half] = 0.0;
      }
    } else {
      const long long pos =
          ((r >> (lgl - 1)) << lgl) | (r & ((1LL << (lgl - 1)) - 1));
      const long long m = freq_of(pos, P, lgs, lgM);
      const C u = coefficient(m, N, gr.dln, mu, q, gr.ln_k0x0);
      apply(m, pos, u);
      if (m > 0)
        apply(N - m, pos_of(N - m, P, lgs, lgM), {u.re, -u.im});
      else
        apply(N / 2, pos_of(N / 2, P, lgs, lgM),
              coefficient(N / 2, N, gr.dln, mu, q, gr.ln_k0x0));
    }
  }
}

int blocks_for(long long work) {
  const long long b = (work + kCoeffThreads - 1) / kCoeffThreads;
  return int(b < 1 ? 1 : (b > 132 * 32 ? 132 * 32 : b));
}

template <bool kFwd, int kIO>
int pass_launch(long long blocks, size_t smem, long long N, long long M,
                int lgR, int lgQ, long long S, const double* a,
                const double* x, double q, double ln_kcrc, const double* twr,
                const double* twi, const double* spr, const double* spi,
                double* re, double* im, double* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fht_pass<kFwd, kIO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fht_pass<kFwd, kIO><<<unsigned(blocks), kPassThreads, smem, stream>>>(
      N, M, lgR, lgQ, S, a, x, q, ln_kcrc, twr, twi, spr, spi, re, im, out);
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

// The route over the whole card (ops.fftlog.fht_plan's passes), a launch
// each call. tw: the sub-transforms' twiddles, Re then Im (nt - 1 each,
// nt = the points a block, Q); chirp: for Bluestein its sequence, then its
// spectrum, Re then Im (M each), else null; k: (N,) the output grid.
int bf_fht_setup_f64(long long N, long long M, int nt, int bluestein,
                     const double* x, double ln_kcrc, double* tw,
                     double* chirp, double* k, void* stream) {
  const bool pow2 = M >= 2 && (M & (M - 1)) == 0;
  if (N < 2 || !pow2 || nt < 2 || nt > (1 << kMaxLgQ) || (nt & (nt - 1)) ||
      (bluestein ? (M < 2 * N - 1 || chirp == nullptr) : M != N))
    return int(cudaErrorInvalidValue);
  long long work = N > nt ? N : nt;
  if (bluestein && M > work) work = M;
  fht_setup<<<blocks_for(work), kCoeffThreads, 0, (cudaStream_t)stream>>>(
      N, M, nt, bluestein, x, ln_kcrc, tw, tw + (nt - 1), chirp,
      chirp == nullptr ? nullptr : chirp + M, k);
  return int(cudaGetLastError());
}

// One pass of G rows: forward (io: 0 the scratch, 1 the biased input a
// (G, N), 2 biased times the chirp) or inverse (io: 0 to the scratch, 1 the
// unbiased output out (G, N), 2 times the chirp first; spec, when given,
// the chirp's spectrum (Re then Im, M each) multiplied in as it loads), of
// radix 2^lgR over columns of stride S, 2^lgQ points a block. scratch: Re
// then Im, G M each.
int bf_fht_pass_f64(int forward, int io, int G, long long N, long long M,
                    int lgR, int lgQ, long long S, const double* a,
                    const double* x, double q, double ln_kcrc,
                    const double* tw, const double* spec, double* scratch,
                    double* out, void* stream) {
  const bool pow2 = M >= 2 && (M & (M - 1)) == 0;
  if (G < 1 || N < 2 || !pow2 || lgQ < 1 || lgQ > kMaxLgQ || lgR < 1 ||
      lgR > lgQ || (M >> lgQ) < 1 || (M & ((1LL << lgQ) - 1)) ||
      S < (1LL << (lgQ - lgR)) || (S << lgR) > M || io < 0 || io > 2)
    return int(cudaErrorInvalidValue);
  const long long blocks = (long long)G * (M >> lgQ);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(double) * (size_t(2) << lgQ);
  const int nt = 1 << lgQ;
  const double *twr = tw, *twi = tw + (nt - 1);
  const double* spr = spec;
  const double* spi = spec == nullptr ? nullptr : spec + M;
  double *re = scratch, *im = scratch + (long long)G * M;
  cudaStream_t st = (cudaStream_t)stream;
  if (forward) {
    if (io == kScratch)
      return pass_launch<true, kScratch>(blocks, smem, N, M, lgR, lgQ, S, a,
                                         x, q, ln_kcrc, twr, twi, spr, spi,
                                         re, im, out, st);
    if (io == kBias)
      return pass_launch<true, kBias>(blocks, smem, N, M, lgR, lgQ, S, a, x,
                                      q, ln_kcrc, twr, twi, spr, spi, re, im,
                                      out, st);
    return pass_launch<true, kBiasChirp>(blocks, smem, N, M, lgR, lgQ, S, a,
                                         x, q, ln_kcrc, twr, twi, spr, spi,
                                         re, im, out, st);
  }
  if (io == kScratch)
    return pass_launch<false, kScratch>(blocks, smem, N, M, lgR, lgQ, S, a,
                                        x, q, ln_kcrc, twr, twi, spr, spi, re,
                                        im, out, st);
  if (io == kOutPow2)
    return pass_launch<false, kOutPow2>(blocks, smem, N, M, lgR, lgQ, S, a,
                                        x, q, ln_kcrc, twr, twi, spr, spi, re,
                                        im, out, st);
  return pass_launch<false, kOutChirp>(blocks, smem, N, M, lgR, lgQ, S, a, x,
                                       q, ln_kcrc, twr, twi, spr, spi, re, im,
                                       out, st);
}

// The coefficients of G rows of the scratch in place (Re then Im, G M
// each): P passes of radices 2^lg_p, lgs their log2 packed 6 bits each
// (pass p at bit 6 p), for a power of two; natural order for Bluestein.
int bf_fht_coeff_f64(int G, long long N, long long M, int bluestein, int P,
                     long long lgs, const double* x, double mu, double q,
                     double ln_kcrc, double* scratch, void* stream) {
  const bool pow2 = M >= 2 && (M & (M - 1)) == 0;
  int total = 0;
  for (int p = 0; p < P && p < 10; ++p) total += int((lgs >> (6 * p)) & 63);
  if (G < 1 || N < 2 || !pow2 || P < 1 || P > 10 ||
      (1LL << total) != M || (bluestein ? M < 2 * N - 1 : M != N))
    return int(cudaErrorInvalidValue);
  const long long per = bluestein ? N / 2 + 1 + (M - N) : M / 2;
  double *re = scratch, *im = scratch + (long long)G * M;
  cudaStream_t st = (cudaStream_t)stream;
  if (bluestein)
    fht_coeff<true><<<blocks_for(per * G), kCoeffThreads, 0, st>>>(
        G, N, M, P, lgs, x, mu, q, ln_kcrc, re, im);
  else
    fht_coeff<false><<<blocks_for(per * G), kCoeffThreads, 0, st>>>(
        G, N, M, P, lgs, x, mu, q, ln_kcrc, re, im);
  return int(cudaGetLastError());
}

}  // extern "C"
