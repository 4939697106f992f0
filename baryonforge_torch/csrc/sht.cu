// K18 ring modes and K19 Legendre transform: the spherical-harmonic
// analysis of a RING-ordered HEALPix map (utils/sht.anafast).
//
// K18 replaces _ring_modes of baryonforge_tpu/utils/sht.py:49-89: for each
// iso-latitude ring r (nr pixels from sp, first centre at phi0 = pi / nr on
// shifted rings, else 0) and each m <= lmax,
//   F_m = e^{-i m phi0} sum_j map_j e^{-2 pi i m j / nr}.
// The JAX version forms the angles m (j 2 pi / nr) in float64 and runs
// cos/sin matrix products over ring batches (the TPU has no complex type).
// Here each ring is one FFT. A real ring's sums depend on m only through
// m mod nr and G_{nr-k} = conj(G_k), so G_k, k = 0 .. nr / 2, comes from
// the complex FFT Z of the n = nr / 2 points z_j = x_{2j} + i x_{2j+1}:
//   G_k = (Z_k + conj Z_{n-k}) / 2 - i e^{-2 pi i k / nr} (Z_k - conj
//   Z_{n-k}) / 2,
// and each output m takes G_{m mod nr} (conjugated past nr / 2) turned by
// e^{-i m pi / nr} on shifted rings. Power-of-two n (the belt at
// power-of-two NSIDE, cap rings 4i with i a power of two) run an FFT of n
// points; any other n runs Bluestein's chirp convolution by
// power-of-two FFTs of M >= 2n - 1 points, the chirp e^{-i pi j^2 / n}
// from the exact integer j^2 mod 2n. Every phase is an exact integer index
// (p / h with h a power of two in the butterflies, j^2 mod 2n, 2k / nr,
// m / nr) into sincospi: no angle is rounded as the JAX angles are; the
// plain version keeps those, and ops/sht.py bounds the difference.
// Bound: bytes (the map read once, the (n_ring, lmax + 1) modes written
// once; ~2.5 nr log2 nr float64 operations a ring are far under them).
// Design: one block per ring. The block's working arrays (the M points,
// Re and Im apart, the butterflies' twiddles, stage by stage, and for
// Bluestein the chirp's spectrum) sit in shared memory (4 M doubles, 6 M
// for Bluestein: 64 KB for the NSIDE 1024 belt, 192 KB for its longest
// caps); rings that need more take the same code on a slot of device
// memory (a grid of kLongBlocks blocks walking those rings). Rings are
// launched in groups of one route and one M, each with its own shared
// memory size. The FFTs run in place: decimation in frequency (natural
// order in, bit-reversed out) forward, decimation in time back, so
// Bluestein's product needs no reordering and no second buffer (a
// Stockham FFT's ping-pong would take 2 M more doubles: 256 KB for
// Bluestein's M = 4096 at NSIDE 1024, over the 227 KB a block may have).
// The stages of half-size >= 16 run in radix-4 passes (two stages a pass,
// four elements a thread in registers: half the passes and barriers),
// the last four in radix-2. Element e lives at e ^ ((e >> 4) & 15); a
// radix-4 pass's half-warp reads sixteen consecutive elements, and at the
// radix-2 stages of half-size h < 16 each half-warp takes eight
// butterflies from a 16-element block B and eight from B ^ h: every
// half-warp's sixteen 8-byte reads and writes fall in sixteen different
// bank pairs at every stage (M >= 32 h).
//
// K19 replaces _alm_from_modes of sht.py:92-150: for each m, the
// normalised associated Legendre functions lambda_lm(z_r) run up in l from
// lambda_mm = exp(0.5 logfac_m + m log s - 0.5 log 4pi) (s = sqrt(max(1 -
// z^2, 0)), log s of max(s, DBL_MIN), exact 0 where that underflows; at s =
// 0 lambda_00 = 1 / sqrt(4 pi), else 0) by
//   lambda_lm = a_lm (z lambda_{l-1,m}) - b_lm lambda_{l-2,m},
//   a_lm = sqrt((2l+1)(2l-1) / max((l-m)(l+m), 1)),
//   b_lm = sqrt(max((2l+1)(l-1-m)(l-1+m), 0) / max((2l-3)(l-m)(l+m), 1)),
// each l contracted with the ring modes over the rings: a_lm = sum_r F_rm
// lambda_lm(z_r) (Re and Im), zero for l < m. The recurrence is the JAX
// scan's, operation for operation (--fmad=false); the contraction is summed
// in another order, with fma.
// Mirrored rings: s is the same for z and -z and the recurrence commutes
// with negation, so lambda_lm(-z) = (-1)^(l-m) lambda_lm(z) bitwise. The
// wrapper lists chains (ops.sht.mirror_pairs): a ring and its exact mirror,
// or a ring alone. A chain runs one recurrence on its first ring's z and
// contracts it with E = F_r + F_r' where l - m is even, O = F_r - F_r' where
// it is odd (F_r' = 0 alone): 2,048 chains for the 4,095 rings at NSIDE
// 1024 with ops.sht.ring_heights.
// Bound: operations, a chain-step (l, m) costs 6 float64 instructions (3
// products and a difference, 2 fma), ~8 as counted operations.
// Design: one block per m (and per chunk of kChains * kMaxThreads chains
// when there are more, added atomically; a chain is never split), each
// thread carrying kChains chains' z, E, O and two recurrence values in
// registers. A thread keeps its partial sums of kChunk consecutive l and
// the warp adds them in one transposed reduction (kChunk + 1 shuffle-adds
// for kChunk l, not 5 a l) into shared memory. The block meets at a
// barrier once a round of kRound l: the round's warp sums are added and
// written, and a_lm, b_lm of the round after next are formed, in double
// buffers, while the warps run on into the next round.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// K18 -----------------------------------------------------------------------

constexpr int kFftThreads = 512;
constexpr int kLongBlocks = 264;  // blocks of the device-memory route

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
__device__ void make_twiddles(double* twr, double* twi, int M) {
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
__device__ void fft_dif(double* re, double* im, const double* twr,
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
__device__ void ifft_dit(double* re, double* im, const double* twr,
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

// Rings rings[0 .. n_rings) of one route, in blocks of kFftThreads; buf is
// shared memory, or with scratch a slot of `slot` doubles a block.
template <bool kBluestein>
__global__ void __launch_bounds__(kFftThreads)
ring_fft_kernel(const double* __restrict__ map,
                const long long* __restrict__ sp,
                const int* __restrict__ nr_all,
                const int* __restrict__ shifted,
                const int* __restrict__ rings, int n_rings, int L,
                double* scratch, long long slot, double* __restrict__ Fr,
                double* __restrict__ Fi) {
  extern __shared__ double smem[];
  double* buf = scratch ? scratch + (long long)blockIdx.x * slot : smem;
  for (int q = blockIdx.x; q < n_rings; q += gridDim.x) {
    const int r = rings[q];
    const int nr = nr_all[r], n = nr / 2;
    const int M = fft_size(n, kBluestein);
    double *ar = buf, *ai = buf + M, *twr = buf + 2 * M, *twi = buf + 3 * M;
    const double* x = map + sp[r];
    make_twiddles(twr, twi, M);
    if (kBluestein) {
      double *br = buf + 4 * M, *bi = buf + 5 * M;
      // b_m = conj chirp at m and M - m, m < n
      for (int e = threadIdx.x; e < M; e += blockDim.x) {
        const int m = e < n ? e : (e > M - n ? M - e : -1);
        double c = 0.0, s = 0.0;
        if (m >= 0) {
          chirp(m, n, &c, &s);
          s = -s;
        }
        br[swz(e)] = c;
        bi[swz(e)] = s;
      }
      // a_j = z_j chirp_j, j < n
      for (int j = threadIdx.x; j < M; j += blockDim.x) {
        double zr = 0.0, zi = 0.0;
        if (j < n) {
          double c, s;
          chirp(j, n, &c, &s);
          const double xr = x[2 * j], xi = x[2 * j + 1];
          zr = xr * c - xi * s;
          zi = xr * s + xi * c;
        }
        ar[swz(j)] = zr;
        ai[swz(j)] = zi;
      }
      __syncthreads();
      fft_dif(br, bi, twr, twi, M);
      fft_dif(ar, ai, twr, twi, M);
      for (int e = threadIdx.x; e < M; e += blockDim.x) {
        const double ur = ar[e], ui = ai[e], vr = br[e], vi = bi[e];
        ar[e] = ur * vr - ui * vi;
        ai[e] = ur * vi + ui * vr;
      }
      __syncthreads();
      ifft_dit(ar, ai, twr, twi, M);
    } else {
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        ar[swz(j)] = x[2 * j];
        ai[swz(j)] = x[2 * j + 1];
      }
      __syncthreads();
      fft_dif(ar, ai, twr, twi, M);
    }
    // Z_k: Bluestein's chirp_k c_k / M, or the FFT's bit-reversed slot
    const int lg = __ffs(M) - 1;
    const double inv_m = 1.0 / double(M);
    auto Z = [&](int k, double* zr, double* zi) {
      if (kBluestein) {
        const int e = swz(k);
        double c, s;
        chirp(k, n, &c, &s);
        const double cr = ar[e] * inv_m, ci = ai[e] * inv_m;
        *zr = cr * c - ci * s;
        *zi = cr * s + ci * c;
      } else {
        const int e = swz(int(__brev(unsigned(k)) >> (32 - lg)));  // M >= 2
        *zr = ar[e];
        *zi = ai[e];
      }
    };
    const bool shift = shifted[r] != 0;
    for (int m = threadIdx.x; m < L; m += blockDim.x) {
      int k = m % nr;
      const bool flip = 2 * k > nr;
      if (flip) k = nr - k;
      double pr, pi, qr, qi;
      Z(k % n, &pr, &pi);
      Z((n - k) % n, &qr, &qi);
      qi = -qi;  // conj Z_{n-k}
      const double er = 0.5 * (pr + qr), ei = 0.5 * (pi + qi);
      const double orr = 0.5 * (pi - qi), oi = -0.5 * (pr - qr);
      double ws, wc;
      sincospi(double(2 * k) / double(nr), &ws, &wc);
      const double gr = er + (wc * orr + ws * oi);
      double gi = ei + (wc * oi - ws * orr);
      if (flip) gi = -gi;
      double s0 = 0.0, c0 = 1.0;
      if (shift) sincospi(double(m) / double(nr), &s0, &c0);
      Fr[(long long)r * L + m] = gr * c0 + gi * s0;
      Fi[(long long)r * L + m] = gi * c0 - gr * s0;
    }
    __syncthreads();  // the buffer is the next ring's
  }
}

template <bool kBluestein>
int launch_rings(const double* map, const long long* sp, const int* nr,
                 const int* shifted, const int* rings, int count, int M,
                 int L, bool in_shared, double* scratch, double* Fr,
                 double* Fi, cudaStream_t stream) {
  const long long slot = (kBluestein ? 6LL : 4LL) * M;
  if (in_shared) {
    const size_t smem = sizeof(double) * size_t(slot);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ring_fft_kernel<kBluestein>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
    }
    ring_fft_kernel<kBluestein><<<count, kFftThreads, smem, stream>>>(
        map, sp, nr, shifted, rings, count, L, nullptr, 0, Fr, Fi);
  } else {
    const int blocks = count < kLongBlocks ? count : kLongBlocks;
    ring_fft_kernel<kBluestein><<<blocks, kFftThreads, 0, stream>>>(
        map, sp, nr, shifted, rings, count, L, scratch, slot, Fr, Fi);
  }
  return int(cudaGetLastError());
}

// K19 -----------------------------------------------------------------------

constexpr double kPi = 3.141592653589793;
constexpr int kChains = 8;       // chains a thread
constexpr int kMaxThreads = 256;
constexpr int kChunk = 16;       // l a chunk (partial sums a thread keeps)
constexpr int kRound = 64;       // l between two barriers of the block
constexpr unsigned kFull = 0xffffffffu;

// the sums over the warp of v[0 .. kChunk): lane j ends with the sum of
// v[j >> kShift]. Each halving step keeps the upper or the lower half of
// the H live values by one lane bit and adds the partner's other half.
constexpr int kShift = kChunk == 8 ? 2 : (kChunk == 16 ? 1 : 0);
static_assert(32 >> kShift == kChunk, "kChunk must be 8, 16 or 32");
static_assert(kRound % kChunk == 0, "a round is whole chunks");

template <int H>
__device__ __forceinline__ void transpose_halve(double (&v)[kChunk],
                                                int lane) {
  constexpr int o = 32 * H / kChunk;
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const double send = up ? v[j] : v[j + H];
    const double keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, o);
  }
  if constexpr (H > 1) transpose_halve<H / 2>(v, lane);
}

__device__ __forceinline__ double warp_transposed_sum(double (&v)[kChunk],
                                                      int lane) {
  transpose_halve<kChunk / 2>(v, lane);
#pragma unroll
  for (int o = (1 << kShift) >> 1; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(kFull, v[0], o);
  return v[0];
}

// a_lm and b_lm of l = l0 .. l0 + kRound - 1 (those below L) into ca, cb
__device__ __forceinline__ void round_coefficients(int l0, int L, double md,
                                                   double* ca, double* cb) {
  for (int k = threadIdx.x; k < kRound && l0 + k < L; k += blockDim.x) {
    const double l = double(l0 + k);
    ca[k] = sqrt(((2 * l + 1) * (2 * l - 1)) /
                 fmax((l - md) * (l + md), 1.0));
    cb[k] = sqrt(fmax((2 * l + 1) * (l - 1 - md) * (l - 1 + md), 0.0) /
                 fmax((2 * l - 3) * (l - md) * (l + md), 1.0));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
legendre_kernel(int n_chain, int L, const double* __restrict__ z,
                const double* __restrict__ Fr, const double* __restrict__ Fi,
                const int2* __restrict__ chains,
                const double* __restrict__ logfac, int atomic,
                double* __restrict__ alm_r, double* __restrict__ alm_i) {
  // two of everything: round r uses [r & 1] while round r - 1's sums are
  // added and round r + 1's coefficients are formed in the other
  __shared__ double ca[2][kRound], cb[2][kRound];
  __shared__ double red[2][2][kMaxThreads / 32][kRound];   // [buf][re, im]
  const int m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const double md = double(m);
  const double half_log4pi = 0.5 * log(4.0 * kPi);
  const double inv_sqrt4pi = 1.0 / sqrt(4.0 * kPi);

  // chain q: z, E and O (Re, Im), and lambda_{l-1}, lambda_{l-2}
  double zz[kChains], er[kChains], ei[kChains], orr[kChains], oi[kChains];
  double p1[kChains], p2[kChains];
  const int base = blockIdx.y * kChains * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kChains; ++q) {
    const int c = base + q * blockDim.x;
    double f1r = 0.0, f1i = 0.0, f2r = 0.0, f2i = 0.0;
    zz[q] = 0.0;
    if (c < n_chain) {
      const int2 rr = chains[c];
      zz[q] = z[rr.x];
      f1r = Fr[(long long)rr.x * L + m];
      f1i = Fi[(long long)rr.x * L + m];
      if (rr.y >= 0) {
        f2r = Fr[(long long)rr.y * L + m];
        f2i = Fi[(long long)rr.y * L + m];
      }
    }
    er[q] = f1r + f2r;
    ei[q] = f1i + f2i;
    orr[q] = f1r - f2r;
    oi[q] = f1i - f2i;
    const double s = sqrt(fmax(1.0 - zz[q] * zz[q], 0.0));
    const double log_s = log(fmax(s, 2.2250738585072014e-308));
    double lam = exp(0.5 * logfac[m] + md * log_s - half_log4pi);
    if (!(s > 0.0)) lam = m == 0 ? inv_sqrt4pi : 0.0;
    p1[q] = lam;   // lambda_mm: the first step emits it as it is
    p2[q] = 0.0;
  }
  if (!atomic && blockIdx.y == 0) {
    for (int l = threadIdx.x; l < m; l += blockDim.x) {
      alm_r[(long long)m * L + l] = 0.0;
      alm_i[(long long)m * L + l] = 0.0;
    }
  }
  round_coefficients(m, L, md, ca[0], cb[0]);
  round_coefficients(m + kRound, L, md, ca[1], cb[1]);
  __syncthreads();

  for (int l0 = m, r = 0; l0 < L; l0 += kRound, ++r) {
    const int buf = r & 1, nround = min(kRound, L - l0);
    for (int c0 = 0; c0 < nround; c0 += kChunk) {
      const int nl = min(kChunk, nround - c0);
      double sr[kChunk], si[kChunk];
      if (nl == kChunk && (r > 0 || c0 > 0)) {
        // a whole chunk past lambda_mm: no branch, so the recurrence
        // values rotate through registers
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const double a = ca[buf][c0 + k], b = cb[buf][c0 + k];
          sr[k] = 0.0;
          si[k] = 0.0;
#pragma unroll
          for (int q = 0; q < kChains; ++q) {
            const double cur = a * (zz[q] * p1[q]) - b * p2[q];
            p2[q] = p1[q];
            p1[q] = cur;
            // l - m = (l0 + c0 - m) + k, and l0 + c0 - m is a multiple
            // of kChunk
            sr[k] = fma((k & 1) ? orr[q] : er[q], cur, sr[k]);
            si[k] = fma((k & 1) ? oi[q] : ei[q], cur, si[k]);
          }
        }
      } else {
        // the first chunk (lambda_mm as it is) and a last partial one
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          sr[k] = 0.0;
          si[k] = 0.0;
          if (k < nl) {
            const double a = ca[buf][c0 + k], b = cb[buf][c0 + k];
            const bool first = k == 0 && c0 == 0 && r == 0;
#pragma unroll
            for (int q = 0; q < kChains; ++q) {
              double cur = p1[q];
              if (!first) {
                cur = a * (zz[q] * p1[q]) - b * p2[q];
                p2[q] = p1[q];
                p1[q] = cur;
              }
              sr[k] = fma((k & 1) ? orr[q] : er[q], cur, sr[k]);
              si[k] = fma((k & 1) ? oi[q] : ei[q], cur, si[k]);
            }
          }
        }
      }
      const double tr = warp_transposed_sum(sr, lane);
      const double ti = warp_transposed_sum(si, lane);
      if ((lane & ((1 << kShift) - 1)) == 0) {
        red[buf][0][warp][c0 + (lane >> kShift)] = tr;
        red[buf][1][warp][c0 + (lane >> kShift)] = ti;
      }
    }
    __syncthreads();
    // the round's sums over the warps, and the coefficients of round r + 2
    for (int t = threadIdx.x; t < 2 * nround; t += blockDim.x) {
      const int k = t % nround, part = t / nround;
      double acc = 0.0;
      for (int w = 0; w < nwarps; ++w) acc += red[buf][part][w][k];
      double* out = (part ? alm_i : alm_r) + (long long)m * L + l0 + k;
      if (atomic)
        atomicAdd(out, acc);
      else
        *out = acc;
    }
    round_coefficients(l0 + 2 * kRound, L, md, ca[buf], cb[buf]);
  }
}

}  // namespace

extern "C" {

// F (n_ring, L) float64, Re and Im, of the RING map, from the rings' first
// pixels, lengths and shift flags on the card. `groups` (host memory, 5
// ints a group: first, count, M, Bluestein, in shared memory) cut `rings`
// into launches; scratch holds kLongBlocks slots of the largest
// device-memory group (6 M doubles for Bluestein, else 4 M).
int bf_ring_modes_f64(int L, const double* map, const long long* sp,
                      const int* nr, const int* shifted, const int* rings,
                      int n_groups, const int* groups, double* scratch,
                      double* Fr, double* Fi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int g = 0; g < n_groups; ++g) {
    const int* G = groups + 5 * g;
    const int* sub = rings + G[0];
    const int count = G[1], M = G[2];
    const bool shared = G[4] != 0;
    if (count <= 0) continue;
    if (!shared && scratch == nullptr) return int(cudaErrorInvalidValue);
    const int err =
        G[3] ? launch_rings<true>(map, sp, nr, shifted, sub, count, M, L,
                                  shared, scratch, Fr, Fi, s)
             : launch_rings<false>(map, sp, nr, shifted, sub, count, M, L,
                                   shared, scratch, Fr, Fi, s);
    if (err != 0) return err;
  }
  return 0;
}

int bf_ring_modes_long_blocks(void) { return kLongBlocks; }

// the dynamic shared memory a block may opt in to on `device` (bytes), as
// the card reports it; minus the CUDA error on failure
int bf_shared_memory_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -int(e);
}

// a (L, L) float64, Re and Im, indexed [m, l], from the rings' z and
// modes F (n_ring, L); chains (n_chain, 2) int32: a ring and its exact
// mirror, or a ring and -1 (every ring in one chain); logfac (L,) the
// cumulative sums of log((2k+1)/(2k)); alm zeroed by the caller when the
// chains take more than one block a row (they are then added atomically)
int bf_legendre_alm_f64(int n_ring, int n_chain, int L, const double* z,
                        const double* Fr, const double* Fi, const int* chains,
                        const double* logfac, double* alm_r, double* alm_i,
                        void* stream) {
  if (n_ring == 0 || n_chain == 0 || L == 0) return 0;
  int threads = (n_chain + kChains - 1) / kChains;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int chunks = (n_chain + kChains * threads - 1) / (kChains * threads);
  const dim3 grid(L, chunks);
  legendre_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      n_chain, L, z, Fr, Fi, reinterpret_cast<const int2*>(chains), logfac,
      chunks > 1 ? 1 : 0, alm_r, alm_i);
  return int(cudaGetLastError());
}

int bf_legendre_chains_per_block(void) { return kChains * kMaxThreads; }

}  // extern "C"
