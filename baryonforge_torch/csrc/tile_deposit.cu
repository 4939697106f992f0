// K4: tile deposit (tiled phase A), K10: tile paint, K12: paint2.
//
// K4 replaces baryonforge_tpu/ops/tiles.py: make_tile_deposit(mode="displace")
// (its one_tile and run_all_into, with SkyTiling.slot_local(tangent=True)).
// For every (slot, halo) pair of a touched tile: the chord from tile-local
// coordinates, subtracting before squaring (dh = vh - c and the slot's
// dp = v_pix - c are both small, so float32 keeps the chord's relative
// error near eps * tile size / chord); ln r = ln chord + lnDa; the direct
// lerp of the halo's curve at x = (ln r - ln_r0) inv_dlnr; the mask
// chord^2 <= crit2 and 0 <= x <= n_r - 1; amp = d afac rsqrt(chord^2) invD.
// Per slot the split sums s0 = sum amp, sth = sum amp (dh . e_th),
// sph = sum amp (dh . e_ph) give out = (s0 a_th - sth, s0 a_ph - sph).
// Dead slots and non-finite values are written as exact zeros.
//
// The JAX version sweeps a hat basis over all curve points (the TPU has no
// per-lane gather), pads each tile's halo list to a bucket's static width,
// and scatters tile rows into the accumulator. Here one block takes one
// touched tile from a CSR list (tiles ascending, each with its halos) and
// owns that tile's rows of the accumulator, so no atomics are needed;
// untouched tiles keep the wrapper's zeros. Each thread owns one slot: it
// computes the slot's geometry (per-ring values in float64, then the small
// local quantities in T, as slot_local) and sums its pairs in CSR order.
//
// Bound: arithmetic, and little of it: at the bench shapes ~37M pair-slot
// evaluations of ~40 flops, one log and one rsqrt each. Design: the tile's
// halos are staged in shared memory in chunks (7 values and the curve per
// halo), so the pair loop reads only shared memory and registers; the
// accumulator rows are written once, coalesced.
//
// Precision: the geometry's float64 steps are those of slot_local under
// x64 (ring data, 2 pi / nr, the azimuth offset and its wrap); ln_r0 and
// inv_dlnr are used in T, as the JAX weak-typed Python floats are.
//
// K10 (kPaint) replaces make_tile_deposit(mode="paint"): one_tile's
// non-displace branches (slot_local without the tangent basis; after the
// lerp, exp for log curves; d = (use ? val : 0) afac summed per slot into
// a (n_tiles, RB*K) map). It is the same kernel with the tangent terms
// compiled out, so the pair loop, the staging and the bound are K4's; a
// pair costs ~25 operations (one log, one exp for log curves). Paint discs
// are small against a tile, so most of a touched tile's slots are masked:
// the runner picks the 8 x 16 tiling (P = 128) when the median disc is
// under 1.5 tile heights, as the JAX runner does.
//
// K12 (kPaint2) replaces make_tile_deposit(mode="paint2"), the halo sum of
// PaintProfilesAnisShell._tiled_paint2: per pair two lookups that share
// ln r, the first curve's at x = (ln r - ln_r0) inv_dlnr and the second's
// at x2 = (ln r - ln_r0_2) inv_dlnr_2, each on its own grid; the pair is
// used only when x and x2 both lie on their grids. With two log curves the
// value is exp(v1 + v2), one exp a pair; otherwise v1 v2 (the runner exps
// a log operand up front). The second curve is staged beside the first, so
// a halo takes 7 + n_r + n_r2 values of shared memory; a pair costs ~35
// operations.

#include "tiles.cuh"

namespace {

__device__ __forceinline__ float m_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double m_rsqrt(double x) { return rsqrt(x); }

constexpr int kHaloVals = 7;  // dh0, dh1, dh2, lnDa, crit2, afac, invD

// the pair loop's modes: K4, K10, K12
enum Mode { kDisplace = 0, kPaint = 1, kPaint2 = 2 };

template <typename T>
struct Pack {
  const double* vh;
  const T* crit2;
  const T* lnDa;
  const T* invD;
  const T* afac;
  const T* curves;
  int n_r;
  T ln_r0, inv_dlnr;
  const T* curves2;  // kPaint2: the second curve and its grid
  int n_r2;
  T ln_r0_2, inv_dlnr_2;
};

struct Tiling {
  int N, RB, K;
  const int* i0;
  const int* s;
  const int* S;
  const double* center;  // (n_tiles, 3)
  const double* csc;     // (n_tiles, 5)
};

template <typename T, int kMode>
__global__ void tile_pairs_kernel(Tiling tl, const int* __restrict__ tiles,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ halos, Pack<T> pk,
                                  int hc, bool log_curves,
                                  T* __restrict__ acc) {
  constexpr bool paints = kMode != kDisplace;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh_vals = reinterpret_cast<T*>(smem_raw);      // (hc, kHaloVals)
  T* sh_curves = sh_vals + hc * kHaloVals;          // (hc, n_r)
  T* sh_curves2 = sh_curves + hc * pk.n_r;          // (hc, n_r2), kPaint2

  const int t = tiles[blockIdx.x];
  const int P = tl.RB * tl.K;
  const int slot = threadIdx.x;
  const int u = slot / tl.K, v = slot % tl.K;
  const double* csc = tl.csc + 5 * (long long)t;

  // ---- slot geometry (slot_local, tangent=True)
  const bf::Seg g = bf::tile_segment(tl.N, tl.i0[t], u, tl.s[t], tl.S[t]);
  const bool valid = g.ok && v < g.len;
  const double theta_r = bf::ring_theta<double>(tl.N, g.i_c);
  const double sth_r = sin(theta_r), cth_r = cos(theta_r);
  const T dsin = T(sth_r - csc[0]);
  const T dcos = T(cth_r - csc[1]);
  const T sth = T(sth_r), cth = T(cth_r);
  const double dphi = bf::kTwoPi / double(g.nr);
  double d = (double(g.j0 + v) + 0.5 * double(g.sh)) * dphi - csc[4];
  d = bf::floor_fmod(d + bf::kPi, bf::kTwoPi) - bf::kPi;
  const T d32 = T(d);
  const T s2 = bf::m_sin(T(0.5) * d32), c2 = bf::m_cos(T(0.5) * d32);
  const T sind = T(2) * s2 * c2;
  const T cosm1 = T(-2) * s2 * s2;
  const T A = dsin + sth * cosm1;
  const T B = sth * sind;
  const T sphc = T(csc[2]), cphc = T(csc[3]);
  const T dp0 = cphc * A - sphc * B;
  const T dp1 = sphc * A + cphc * B;
  const T dp2 = dcos;
  const T cosd = T(1) + cosm1;
  const T sinp = sphc * cosd + cphc * sind;
  const T cosp = cphc * cosd - sphc * sind;
  const T eth0 = cth * cosp, eth1 = cth * sinp, eth2 = -sth;
  const T eph0 = -sinp, eph1 = cosp, eph2 = T(0);
  const T a_th = dp0 * eth0 + dp1 * eth1 + dp2 * eth2;
  const T a_ph = dp0 * eph0 + dp1 * eph1 + dp2 * eph2;

  const T c0 = T(tl.center[3 * (long long)t]);
  const T c1 = T(tl.center[3 * (long long)t + 1]);
  const T c2c = T(tl.center[3 * (long long)t + 2]);

  T s0 = T(0), sth_sum = T(0), sph_sum = T(0);
  const int first = offsets[blockIdx.x], last = offsets[blockIdx.x + 1];
  const int n_r = pk.n_r;
  for (int base = first; base < last; base += hc) {
    const int nh = min(hc, last - base);
    __syncthreads();  // the previous chunk is consumed
    for (int k = threadIdx.x; k < nh; k += blockDim.x) {
      const long long h = halos[base + k];
      T* hv = sh_vals + k * kHaloVals;
      hv[0] = T(pk.vh[3 * h]) - c0;
      hv[1] = T(pk.vh[3 * h + 1]) - c1;
      hv[2] = T(pk.vh[3 * h + 2]) - c2c;
      hv[3] = pk.lnDa[h];
      hv[4] = pk.crit2[h];
      hv[5] = pk.afac[h];
      if (!paints) hv[6] = pk.invD[h];
    }
    for (int k = threadIdx.x; k < nh * n_r; k += blockDim.x) {
      const int hk = k / n_r;
      sh_curves[k] = pk.curves[(long long)halos[base + hk] * n_r + k % n_r];
    }
    if constexpr (kMode == kPaint2) {
      const int n_r2 = pk.n_r2;
      for (int k = threadIdx.x; k < nh * n_r2; k += blockDim.x) {
        const int hk = k / n_r2;
        sh_curves2[k] =
            pk.curves2[(long long)halos[base + hk] * n_r2 + k % n_r2];
      }
    }
    __syncthreads();
    if (slot >= P) continue;
    for (int k = 0; k < nh; ++k) {
      const T* hv = sh_vals + k * kHaloVals;
      const T dh0 = hv[0], dh1 = hv[1], dh2 = hv[2];
      const T e0 = dh0 - dp0, e1 = dh1 - dp1, e2 = dh2 - dp2;
      T chord2 = e0 * e0 + e1 * e1 + e2 * e2;
      chord2 = chord2 > T(1e-30) ? chord2 : T(1e-30);
      const T lnr = T(0.5) * bf::m_log(chord2) + hv[3];
      const T x = (lnr - pk.ln_r0) * pk.inv_dlnr;
      const int i = bf::clampi(int(x), 0, n_r - 2);
      const T tt = x - T(i);
      const T* cv = sh_curves + k * n_r;
      T val = cv[i] * (T(1) - tt) + cv[i + 1] * tt;
      bool use = x >= T(0) && x <= T(n_r - 1) && chord2 <= hv[4];
      if constexpr (kMode == kPaint2) {
        const int n_r2 = pk.n_r2;
        const T x2 = (lnr - pk.ln_r0_2) * pk.inv_dlnr_2;
        const int i2 = bf::clampi(int(x2), 0, n_r2 - 2);
        const T t2 = x2 - T(i2);
        const T* cv2 = sh_curves2 + k * n_r2;
        const T v2 = cv2[i2] * (T(1) - t2) + cv2[i2 + 1] * t2;
        val = log_curves ? val + v2 : val * v2;
        use = use && x2 >= T(0) && x2 <= T(n_r2 - 1);
      }
      if constexpr (paints) {
        const T pv = log_curves ? bf::m_exp(val) : val;
        s0 = s0 + (use ? pv : T(0)) * hv[5];
      } else {
        const T dd = (use ? val : T(0)) * hv[5];
        const T amp = dd * m_rsqrt(chord2) * hv[6];
        const T gth = dh0 * eth0 + dh1 * eth1 + dh2 * eth2;
        const T gph = dh0 * eph0 + dh1 * eph1 + dh2 * eph2;
        s0 = s0 + amp;
        sth_sum = sth_sum + amp * gth;
        sph_sum = sph_sum + amp * gph;
      }
    }
  }
  if (slot >= P) return;
  if constexpr (paints) {
    acc[(long long)t * P + slot] = (valid && isfinite(s0)) ? s0 : T(0);
  } else {
    T o0 = s0 * a_th - sth_sum;
    T o1 = s0 * a_ph - sph_sum;
    if (!valid) o0 = o1 = T(0);
    if (!isfinite(o0)) o0 = T(0);
    if (!isfinite(o1)) o1 = T(0);
    T* out = acc + ((long long)t * P + slot) * 2;
    out[0] = o0;
    out[1] = o1;
  }
}

template <typename T, int kMode>
int launch(int nside, int RB, int K, int n_touched, const int* tiles,
           const int* offsets, const int* halos, const int* tile_i0,
           const int* tile_s, const int* tile_S, const double* center,
           const double* csc, const double* vh, const T* crit2,
           const T* lnDa, const T* invD, const T* afac, const T* curves,
           int n_r, T ln_r0, T inv_dlnr, const T* curves2, int n_r2,
           T ln_r0_2, T inv_dlnr_2, bool log_curves, T* acc, void* stream) {
  const int P = RB * K;
  if (P > 1024) return int(cudaErrorInvalidValue);
  if (kMode == kPaint2 && n_r2 < 2) return int(cudaErrorInvalidValue);
  // halos per shared-memory chunk: up to 64, within 48 KB
  const int per_halo =
      int(sizeof(T)) * (kHaloVals + n_r + (kMode == kPaint2 ? n_r2 : 0));
  int hc = 48 * 1024 / per_halo;
  hc = hc > 64 ? 64 : hc;
  if (hc < 1) return int(cudaErrorInvalidValue);
  const int threads = (P + 31) / 32 * 32;
  Tiling tl{nside, RB, K, tile_i0, tile_s, tile_S, center, csc};
  Pack<T> pk{vh,    crit2,    lnDa,    invD, afac,    curves,    n_r,
             ln_r0, inv_dlnr, curves2, n_r2, ln_r0_2, inv_dlnr_2};
  tile_pairs_kernel<T, kMode><<<n_touched, threads, size_t(hc) * per_halo,
                                (cudaStream_t)stream>>>(
      tl, tiles, offsets, halos, pk, hc, log_curves, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BF_TILE_DEPOSIT(T, SUF)                                              \
  int bf_tile_deposit_##SUF(                                                 \
      int nside, int RB, int K, int n_touched, const int* tiles,             \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* invD, const T* afac, const T* curves, int n_r, T ln_r0,       \
      T inv_dlnr, T* acc, void* stream) {                                    \
    return launch<T, kDisplace>(                                             \
        nside, RB, K, n_touched, tiles, offsets, halos, tile_i0, tile_s,     \
        tile_S, center, csc, vh, crit2, lnDa, invD, afac, curves, n_r,       \
        ln_r0, inv_dlnr, nullptr, 0, T(0), T(0), false, acc, stream);        \
  }                                                                          \
  int bf_tile_paint_##SUF(                                                   \
      int nside, int RB, int K, int n_touched, const int* tiles,             \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* afac, const T* curves, int n_r, T ln_r0, T inv_dlnr,          \
      int log_curves, T* acc, void* stream) {                                \
    return launch<T, kPaint>(                                                \
        nside, RB, K, n_touched, tiles, offsets, halos, tile_i0, tile_s,     \
        tile_S, center, csc, vh, crit2, lnDa, nullptr, afac, curves, n_r,    \
        ln_r0, inv_dlnr, nullptr, 0, T(0), T(0), log_curves != 0, acc,       \
        stream);                                                             \
  }                                                                          \
  int bf_tile_paint2_##SUF(                                                  \
      int nside, int RB, int K, int n_touched, const int* tiles,             \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* afac, const T* curves, const T* curves2, int n_r, T ln_r0,    \
      T inv_dlnr, int n_r2, T ln_r0_2, T inv_dlnr_2, int log_curves, T* acc, \
      void* stream) {                                                        \
    return launch<T, kPaint2>(                                               \
        nside, RB, K, n_touched, tiles, offsets, halos, tile_i0, tile_s,     \
        tile_S, center, csc, vh, crit2, lnDa, nullptr, afac, curves, n_r,    \
        ln_r0, inv_dlnr, curves2, n_r2, ln_r0_2, inv_dlnr_2,                 \
        log_curves != 0, acc, stream);                                       \
  }

BF_TILE_DEPOSIT(float, f32)
BF_TILE_DEPOSIT(double, f64)
#undef BF_TILE_DEPOSIT

}  // extern "C"
