// The in-place float64 FFT that K18 (ring modes, sht.cu) and K8 (FFTLog,
// fftlog.cu) run: a block's threads over one transform of M = 2^k points,
// Re and Im in two arrays, in shared memory or in a slot of device memory.
//
// fft_dif is the forward transform (e^{-2 pi i j k / M}), decimation in
// frequency, natural order in and bit-reversed order out; ifft_dit the
// unnormalised inverse (e^{+2 pi i j k / M}), decimation in time,
// bit-reversed order in and natural order out, so a product of two spectra
// needs no reordering. Both read the twiddles of make_twiddles (M - 1
// entries). The stages of half-size >= 16 run in radix-4 passes (two
// stages a pass, four elements a thread in registers: half the passes and
// barriers), the last four in radix-2. Element e lives at swz(e) = e ^ ((e
// >> 4) & 15): a radix-4 pass's half-warp reads sixteen consecutive
// elements, and at the radix-2 stages of half-size h < 16 each half-warp
// takes eight butterflies from a 16-element block B and eight from B ^ h,
// so every half-warp's sixteen 8-byte reads and writes fall in sixteen
// different bank pairs at every stage (M >= 32 h). Every phase is an exact
// integer index into sincospi (p / h in the butterflies, j^2 mod 2n in
// Bluestein's chirp). A transform of n points that is no power of two is
// Bluestein's chirp convolution, by FFTs of fft_size(n, true) >= 2n - 1
// points.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bf {

// where element e of an M-point array lives
__device__ __forceinline__ int swz(int e) { return e ^ ((e >> 4) & 15); }

// the first element of butterfly t at the stage of half-size h = 2^hb
__device__ __forceinline__ int first_of(int t, int h, int hb, int M) {
  if (h >= 16 || (M >> 5) < h)
    return ((t >> hb) << (hb + 1)) + (t & (h - 1));
  const int u = t & 15, q = t >> 4, v = u & 7;
  const int blk = (((q >> hb) << (hb + 1)) | (q & (h - 1))) | (u >= 8 ? h : 0);
  return blk * 16 + ((v >> hb) << (hb + 1)) + (v & (h - 1));
}

// twiddles of every stage: e^{-i pi p / h} at h - 1 + p, p < h < M
__device__ inline void make_twiddles(double* twr, double* twi, int M) {
  for (int e = threadIdx.x; e < M - 1; e += blockDim.x) {
    const int h = 1 << (31 - __clz(e + 1));
    double s, c;
    sincospi(double(e + 1 - h) / double(h), &s, &c);
    twr[e] = c;
    twi[e] = -s;
  }
}

// the butterflies of both directions: DIF (u, v) <- (u + v, (u - v) w),
// DIT (u, x) <- (u + x conj w, u - x conj w)
__device__ __forceinline__ void bfly_dif(double& ur, double& ui, double& vr,
                                         double& vi, double wr, double wi) {
  const double dr = ur - vr, di = ui - vi;
  ur = ur + vr;
  ui = ui + vi;
  vr = dr * wr - di * wi;
  vi = dr * wi + di * wr;
}

__device__ __forceinline__ void bfly_dit(double& ur, double& ui, double& xr,
                                         double& xi, double wr, double wi) {
  wi = -wi;
  const double vr = xr * wr - xi * wi, vi = xr * wi + xi * wr;
  xr = ur - vr;
  xi = ui - vi;
  ur = ur + vr;
  ui = ui + vi;
}

// one radix-2 stage of half-size h = 2^hb
template <bool kDif>
__device__ void pass2(double* re, double* im, const double* twr,
                      const double* twi, int M, int h, int hb) {
  for (int t = threadIdx.x; t < M / 2; t += blockDim.x) {
    const int i = first_of(t, h, hb, M), p = i & (h - 1);
    const int a = swz(i), b = swz(i + h);
    double ur = re[a], ui = im[a], vr = re[b], vi = im[b];
    if (kDif)
      bfly_dif(ur, ui, vr, vi, twr[h - 1 + p], twi[h - 1 + p]);
    else
      bfly_dit(ur, ui, vr, vi, twr[h - 1 + p], twi[h - 1 + p]);
    re[a] = ur;
    im[a] = ui;
    re[b] = vr;
    im[b] = vi;
  }
  __syncthreads();
}

// the two stages of half-sizes 2q and q (q = 2^qb >= 16) as one radix-4
// pass, the same butterflies in the same order as two radix-2 stages (DIF:
// 2q then q; DIT: q then 2q): a thread holds the elements i, i + q, i + 2q,
// i + 3q of a block of 4q in registers; a half-warp's sixteen i are
// sixteen consecutive elements, so each access meets sixteen bank pairs
template <bool kDif>
__device__ void pass4(double* re, double* im, const double* twr,
                      const double* twi, int M, int q, int qb) {
  for (int t = threadIdx.x; t < M / 4; t += blockDim.x) {
    const int p = t & (q - 1);
    const int i = ((t >> qb) << (qb + 2)) + p;
    int e[4];
    double xr[4], xi[4];
    for (int k = 0; k < 4; ++k) {
      e[k] = swz(i + k * q);
      xr[k] = re[e[k]];
      xi[k] = im[e[k]];
    }
    const int w1 = q - 1 + p, w2 = 2 * q - 1 + p;
    if (kDif) {
      bfly_dif(xr[0], xi[0], xr[2], xi[2], twr[w2], twi[w2]);
      bfly_dif(xr[1], xi[1], xr[3], xi[3], twr[w2 + q], twi[w2 + q]);
      bfly_dif(xr[0], xi[0], xr[1], xi[1], twr[w1], twi[w1]);
      bfly_dif(xr[2], xi[2], xr[3], xi[3], twr[w1], twi[w1]);
    } else {
      bfly_dit(xr[0], xi[0], xr[1], xi[1], twr[w1], twi[w1]);
      bfly_dit(xr[2], xi[2], xr[3], xi[3], twr[w1], twi[w1]);
      bfly_dit(xr[0], xi[0], xr[2], xi[2], twr[w2], twi[w2]);
      bfly_dit(xr[1], xi[1], xr[3], xi[3], twr[w2 + q], twi[w2 + q]);
    }
    for (int k = 0; k < 4; ++k) {
      re[e[k]] = xr[k];
      im[e[k]] = xi[k];
    }
  }
  __syncthreads();
}

// in-place forward FFT, natural order in, bit-reversed order out: the
// stages of half-size >= 16 in radix-4 passes (the first alone when their
// count is odd), then radix-2 down to 1
__device__ inline void fft_dif(double* re, double* im, const double* twr,
                        const double* twi, int M) {
  int hb = __ffs(M) - 2;
  if (hb >= 4 && ((hb - 3) & 1)) {
    pass2<true>(re, im, twr, twi, M, 1 << hb, hb);
    --hb;
  }
  for (; hb >= 5; hb -= 2)
    pass4<true>(re, im, twr, twi, M, 1 << (hb - 1), hb - 1);
  for (; hb >= 0; --hb) pass2<true>(re, im, twr, twi, M, 1 << hb, hb);
}

// in-place inverse FFT (unnormalised), bit-reversed order in, natural out:
// fft_dif's passes in reverse
__device__ inline void ifft_dit(double* re, double* im, const double* twr,
                         const double* twi, int M) {
  const int lg = __ffs(M) - 1;
  int hb = 0;
  for (; hb < lg && hb < 4; ++hb)
    pass2<false>(re, im, twr, twi, M, 1 << hb, hb);
  for (; hb + 1 < lg; hb += 2)
    pass4<false>(re, im, twr, twi, M, 1 << hb, hb);
  if (hb < lg) pass2<false>(re, im, twr, twi, M, 1 << hb, hb);
}

// e^{-i pi (j^2 mod 2n) / n}
__device__ __forceinline__ void chirp(long long j, int n, double* c,
                                      double* s) {
  const long long ph = (j * j) % (2LL * n);
  sincospi(double(ph) / double(n), s, c);
  *s = -*s;
}

// the ring's M (its own n for a power of two, else Bluestein's)
__device__ __forceinline__ int fft_size(int n, bool bluestein) {
  return bluestein ? 1 << (32 - __clz(2 * n - 2)) : n;
}

}  // namespace bf
