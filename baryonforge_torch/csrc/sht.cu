// K18 ring modes and K19 Legendre transform: the spherical-harmonic
// analysis of a RING-ordered HEALPix map (utils/sht.anafast).
//
// K18 replaces _ring_modes of baryonforge_tpu/utils/sht.py:49-89: for each
// iso-latitude ring r (nr pixels from sp, first centre at phi0 = pi / nr on
// shifted rings, else 0) and each m <= lmax,
//   F_m = e^{-i m phi0} sum_j map_j e^{-2 pi i m j / nr}.
// The JAX version forms the angles m (j 2 pi / nr) in float64 and runs
// cos/sin matrix products over ring batches (the TPU has no complex type).
// Here the phase of (m, j) is the exact integer (m j mod nr) into a table of
// cos(2 pi k / nr), the sine being the same table a quarter turn on (nr is a
// multiple of 4), so the kernel carries no angle rounding; the plain version
// keeps the JAX angles, and the two differ by that rounding (ops/sht.py
// states the bound). A real map's sums depend on m only through m mod nr
// and G_{nr-k} = conj(G_k): each ring sums k = 0 .. min(nr / 2, lmax) only
// and hands each G_k to every m = +-k mod nr. Bound: operations, nr (min(nr
// / 2, lmax) + 1) multiply-adds of two a ring, the ring's values and table
// read from shared memory (a direct DFT; an FFT would need O(nr log nr)).
// Design: one block per ring, the ring's values and the cosine table
// staged in shared memory (rings of up to kSmemRing pixels; longer rings
// read the map and compute each twiddle, correct but slow), a thread a k.
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
// lambda_lm(z_r) (Re and Im), zero for l < m; the same operations in the
// same order as the JAX scan (with --fmad=false), only the sum over rings in
// another order. Bound: operations, ~8 float64 operations a (ring, l, m)
// with l >= m. Design: one block per m (and per chunk of kRings * kThreads
// rings when there are more, added atomically), each thread carrying
// kRings rings' two recurrence values in registers; a_lm and b_lm of a
// chunk of kChunk l staged in shared memory, each l's per-warp sums by
// shuffles, the warps' sums added once a chunk.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// K18 -----------------------------------------------------------------------

constexpr int kModesThreads = 256;
constexpr int kSmemRing = 8192;  // values and table: 16 bytes a pixel

__global__ void ring_modes_kernel(const double* __restrict__ map,
                                  const long long* __restrict__ sp,
                                  const int* __restrict__ nr_all,
                                  const int* __restrict__ shifted, int L,
                                  int smem_ring, double* __restrict__ Fr,
                                  double* __restrict__ Fi) {
  extern __shared__ double sm[];
  const int r = blockIdx.x;
  const int nr = nr_all[r];
  const double* vals = map + sp[r];
  const bool staged = nr <= smem_ring;
  double* sv = sm;
  double* ct = sm + nr;
  if (staged) {
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      sv[j] = vals[j];
      ct[j] = cospi(2.0 * double(j) / double(nr));
    }
    __syncthreads();
  }
  const int quarter = 3 * (nr / 4);  // sin(2 pi k / nr) = table[k + 3 nr / 4]
  const int kmax = min(nr / 2, L - 1);
  const bool shift = shifted[r] != 0;
  for (int k = threadIdx.x; k <= kmax; k += blockDim.x) {
    double re = 0.0, im = 0.0;
    int idx = 0;           // k j mod nr
    int ids = quarter;     // (k j + 3 nr / 4) mod nr
    for (int j = 0; j < nr; ++j) {
      double v, c, s;
      if (staged) {
        v = sv[j];
        c = ct[idx];
        s = ct[ids];
      } else {
        v = vals[j];
        sincospi(2.0 * double(idx) / double(nr), &s, &c);
      }
      re = re + v * c;
      im = im + v * s;
      idx += k;
      if (idx >= nr) idx -= nr;
      ids += k;
      if (ids >= nr) ids -= nr;
    }
    // G_k = re - i im; G_{nr-k} = conj(G_k)
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && (k == 0 || 2 * k == nr)) break;
      const double gr = re, gi = pass == 0 ? -im : im;
      for (long long m = pass == 0 ? k : nr - k; m < L; m += nr) {
        double s0 = 0.0, c0 = 1.0;
        if (shift) sincospi(double(m) / double(nr), &s0, &c0);
        Fr[(long long)r * L + m] = gr * c0 + gi * s0;
        Fi[(long long)r * L + m] = gi * c0 - gr * s0;
      }
    }
  }
}

// K19 -----------------------------------------------------------------------

constexpr double kPi = 3.141592653589793;
constexpr int kRings = 16;     // rings a thread
constexpr int kMaxThreads = 256;
constexpr int kChunk = 32;     // l a chunk

__global__ void __launch_bounds__(kMaxThreads)
legendre_kernel(int n_ring, int L, const double* __restrict__ z,
                const double* __restrict__ Fr, const double* __restrict__ Fi,
                const double* __restrict__ logfac, int atomic,
                double* __restrict__ alm_r, double* __restrict__ alm_i) {
  __shared__ double sa[kChunk], sb[kChunk];
  __shared__ double red_r[kMaxThreads / 32][kChunk];
  __shared__ double red_i[kMaxThreads / 32][kChunk];
  const int m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const double md = double(m);
  const double half_log4pi = 0.5 * log(4.0 * kPi);
  const double inv_sqrt4pi = 1.0 / sqrt(4.0 * kPi);

  double zz[kRings], fr[kRings], fi[kRings], p1[kRings], p2[kRings];
  const int base = blockIdx.y * kRings * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kRings; ++q) {
    const int r = base + q * blockDim.x;
    const bool ok = r < n_ring;
    zz[q] = ok ? z[r] : 0.0;
    fr[q] = ok ? Fr[(long long)r * L + m] : 0.0;
    fi[q] = ok ? Fi[(long long)r * L + m] : 0.0;
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

  for (int l0 = m; l0 < L; l0 += kChunk) {
    const int nl = min(kChunk, L - l0);
    if (threadIdx.x < nl) {
      const double l = double(l0 + threadIdx.x);
      sa[threadIdx.x] = sqrt(((2 * l + 1) * (2 * l - 1)) /
                             fmax((l - md) * (l + md), 1.0));
      sb[threadIdx.x] = sqrt(fmax((2 * l + 1) * (l - 1 - md) * (l - 1 + md),
                                  0.0) /
                             fmax((2 * l - 3) * (l - md) * (l + md), 1.0));
    }
    __syncthreads();
    for (int k = 0; k < nl; ++k) {
      const double a = sa[k], b = sb[k];
      const bool first = l0 + k == m;
      double sr = 0.0, si = 0.0;
#pragma unroll
      for (int q = 0; q < kRings; ++q) {
        double cur = p1[q];
        if (!first) {
          cur = a * (zz[q] * p1[q]) - b * p2[q];
          p2[q] = p1[q];
          p1[q] = cur;
        }
        sr = sr + fr[q] * cur;
        si = si + fi[q] * cur;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        si += __shfl_xor_sync(0xffffffffu, si, o);
      }
      if (lane == 0) {
        red_r[warp][k] = sr;
        red_i[warp][k] = si;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * nl; t += blockDim.x) {
      const int k = t % nl;
      const bool imag = t >= nl;
      double acc = 0.0;
      for (int w = 0; w < nwarps; ++w) acc += imag ? red_i[w][k] : red_r[w][k];
      double* out = (imag ? alm_i : alm_r) + (long long)m * L + l0 + k;
      if (atomic)
        atomicAdd(out, acc);
      else
        *out = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// F (n_ring, L) float64, Re and Im, of the RING map; the rings' first
// pixels, lengths and shift flags from the host
int bf_ring_modes_f64(int n_ring, int L, int smem_ring, const double* map,
                      const long long* sp, const int* nr, const int* shifted,
                      int nr_max, double* Fr, double* Fi, void* stream) {
  if (n_ring == 0) return 0;
  if (smem_ring > kSmemRing) smem_ring = kSmemRing;
  const int staged = nr_max < smem_ring ? nr_max : smem_ring;
  const size_t smem = sizeof(double) * 2 * size_t(staged);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_modes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  ring_modes_kernel<<<n_ring, kModesThreads, smem, (cudaStream_t)stream>>>(
      map, sp, nr, shifted, L, staged, Fr, Fi);
  return int(cudaGetLastError());
}

// a (L, L) float64, Re and Im, indexed [m, l]; logfac (L,) the cumulative
// sums of log((2k+1)/(2k)); alm zeroed by the caller when the rings take
// more than one block a row (they are then added atomically)
int bf_legendre_alm_f64(int n_ring, int L, const double* z, const double* Fr,
                        const double* Fi, const double* logfac,
                        double* alm_r, double* alm_i, void* stream) {
  if (n_ring == 0 || L == 0) return 0;
  int threads = (n_ring + kRings - 1) / kRings;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int chunks = (n_ring + kRings * threads - 1) / (kRings * threads);
  const dim3 grid(L, chunks);
  legendre_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      n_ring, L, z, Fr, Fi, logfac, chunks > 1 ? 1 : 0, alm_r, alm_i);
  return int(cudaGetLastError());
}

int bf_legendre_rings_per_block(void) { return kRings * kMaxThreads; }

}  // extern "C"
