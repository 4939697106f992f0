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
// owns that tile's rows of the accumulator, so no atomics are needed; the
// blocks after them write the untouched tiles' zeros, so every slot of the
// accumulator is written once and the wrapper clears nothing. Each thread
// sums its slots' pairs in CSR order: two launches are bitwise equal.
//
// Bound: the accumulator written once (bytes; 0.04 ms at the bench); the
// work is ~37M pair-slot evaluations of ~40 flops, one log and one rsqrt
// each, and ~15M slots' geometry. Design: a tile (16 rows x 32 slots, ~2.5
// halos at the bench) has little pair work against its fixed work, so the
// fixed work is cut and spread. One warp takes a tile (kTileWarps), a
// block of its own: no block barrier holds other warps while one waits on
// memory, and an SM keeps 32 tiles in flight. Its lanes form the rows'
// ring values once a row in shared memory (Row: ring_theta's float64
// asin/acos and its sin and cos, 2 pi / nr), stage the halos (7 values
// and the curve a halo, up to kChunk a chunk), then take the tile's slots
// 32 kSlots at a time: each slot forms its azimuth offset in float64 and
// its small local quantities in T (slot_geometry; sin and cos of d/2 by
// one sincosf) and loops over the staged halos. The offset's wrap into
// [-pi, pi) takes the exact remainder (healpix.cuh: floor_fmod_near; d +
// pi lies in (-2 pi, 4 pi) for every slot), not the library fmod's loop.
// chip_probes.py times these choices against their alternatives.
//
// Precision: the geometry's float64 steps are those of slot_local under
// x64 (ring data, 2 pi / nr, the azimuth offset and its wrap), and the
// rows' values are the same float64 functions on the same ring as when
// each slot formed them; ln_r0 and inv_dlnr are used in T, as the JAX
// weak-typed Python floats are.
//
// K10 (kPaint) replaces make_tile_deposit(mode="paint"): one_tile's
// non-displace branches (slot_local without the tangent basis; after the
// lerp, exp for log curves; d = (use ? val : 0) afac summed per slot into
// a (n_tiles, RB*K) map). It is the same kernel with the tangent terms
// compiled out, so the rows, the pair loop, the staging, the zero blocks
// and the bound are K4's; a pair costs ~25 operations (one log, one exp
// for log curves). Paint discs
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

// sin and cos of x: in float by one sincosf (its results are sinf's and
// cosf's to the bit on the card: chip_probes.py), in double by sin and cos
__device__ __forceinline__ void m_sincos(float x, float& s, float& c) {
  sincosf(x, &s, &c);
}
__device__ __forceinline__ void m_sincos(double x, double& s, double& c) {
  s = sin(x);
  c = cos(x);
}

constexpr int kHaloVals = 7;  // dh0, dh1, dh2, lnDa, crit2, afac, invD
constexpr int kChunk = 16;    // halos a shared-memory chunk, at most
constexpr int kZeroTiles = 32;  // tiles a zero block covers (a warp's mask)
constexpr int kSmemBytes = 48 * 1024 - 16;  // dynamic shared memory, at most
constexpr unsigned kFull = 0xffffffffu;

// the pair loop's modes: K4, K10, K12
enum Mode { kDisplace = 0, kPaint = 1, kPaint2 = 2 };

// slots a thread, and warps a tile: a block of kTileWarps warps takes a
// tile's slots kTileWarps 32 kSlots at a time
constexpr int kSlots = 2;
constexpr int kTileWarps = 1;

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
  int N, RB, K, n_tiles;
  const int* i0;
  const int* s;
  const int* S;
  const double* center;  // (n_tiles, 3)
  const double* csc;     // (n_tiles, 5)
};

// one ring row of a tile, as its slots use it: slot_local's per-ring
// float64 steps, formed once a row
template <typename T>
struct Row {
  double dphi;            // 2 pi / nr
  double jb;              // j0 + sh / 2: slot v sits at (jb + v) dphi
  T dsin, dcos, sth, cth;  // sin/cos theta_r minus the centre's, and alone
  int len;                // segment length
  int ok;                 // ring on the sphere
};

template <typename T>
__device__ __forceinline__ Row<T> row_geometry(const Tiling& tl, int t,
                                               int u, const double* csc) {
  const bf::Seg g = bf::tile_segment(tl.N, tl.i0[t], u, tl.s[t], tl.S[t]);
  const double theta_r = bf::ring_theta<double>(tl.N, g.i_c);
  const double sth_r = sin(theta_r), cth_r = cos(theta_r);
  Row<T> r;
  r.dphi = bf::kTwoPi / double(g.nr);
  r.dsin = T(sth_r - csc[0]);
  r.dcos = T(cth_r - csc[1]);
  r.sth = T(sth_r);
  r.cth = T(cth_r);
  r.jb = double(g.j0) + 0.5 * double(g.sh);
  r.len = g.len;
  r.ok = g.ok;
  return r;
}

// one slot's tile-local geometry (slot_local, tangent=True) and its sums
template <typename T>
struct Slot {
  T dp0, dp1, dp2;         // v_pix - c
  T eth0, eth1, eth2;      // e_theta
  T eph0, eph1;            // e_phi (its z component is 0)
  T s0, sth_sum, sph_sum;  // the split sums
  bool valid;
};

template <typename T>
__device__ __forceinline__ void slot_geometry(const Row<T>& g, int v,
                                              double ph_c, T sphc, T cphc,
                                              Slot<T>& q) {
  q.valid = g.ok && v < g.len;
  // (v + jb) is slot_local's j + sh / 2 to the bit: both are exact
  double d = (double(v) + g.jb) * g.dphi - ph_c;
  // d + pi lies in (-2 pi, 4 pi) for every slot: the exact path
  d = bf::floor_fmod_near(d + bf::kPi, bf::kTwoPi) - bf::kPi;
  const T d32 = T(d);
  T s2, c2;
  m_sincos(T(0.5) * d32, s2, c2);
  const T sind = T(2) * s2 * c2;
  const T cosm1 = T(-2) * s2 * s2;
  const T A = g.dsin + g.sth * cosm1;
  const T B = g.sth * sind;
  q.dp0 = cphc * A - sphc * B;
  q.dp1 = sphc * A + cphc * B;
  q.dp2 = g.dcos;
  const T cosd = T(1) + cosm1;
  const T sinp = sphc * cosd + cphc * sind;
  const T cosp = cphc * cosd - sphc * sind;
  q.eth0 = g.cth * cosp;
  q.eth1 = g.cth * sinp;
  q.eth2 = -g.sth;
  q.eph0 = -sinp;
  q.eph1 = cosp;
  q.s0 = q.sth_sum = q.sph_sum = T(0);
}

// A zero block: the untouched tiles among kZeroTiles consecutive ones
// written as zeros, so that the accumulator needs no clearing beforehand.
// The first touched tile at or past them (tiles ascend) is found by a
// 32-way search, a load a lane a step, and the touched ones among them by
// a warp's mask.
template <typename T>
__device__ void zero_tiles(int z, int n_tiles, int n_touched,
                           const int* __restrict__ tiles, int per_tile,
                           T* __restrict__ acc) {
  __shared__ unsigned touched;
  const int t0 = z * kZeroTiles;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int lo = 0, hi = n_touched;  // tiles[lo - 1] < t0 <= tiles[hi]
    while (hi - lo > 32) {
      const int step = (hi - lo + 31) / 32;
      const int k = lo + lane * step;
      const unsigned below =
          __ballot_sync(kFull, k < hi && tiles[k] < t0);
      const int c = __popc(below);  // samples below t0, from lane 0 on
      hi = min(hi, lo + c * step);
      lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    }
    lo += __popc(
        __ballot_sync(kFull, lo + lane < hi && tiles[lo + lane] < t0));
    const int k = lo + lane;
    const int d = k < n_touched ? tiles[k] - t0 : kZeroTiles;
    const unsigned bits =
        __reduce_or_sync(kFull, d < kZeroTiles ? 1u << d : 0u);
    if (lane == 0) touched = bits;
  }
  __syncthreads();
  const int nt = min(kZeroTiles, n_tiles - t0);
  for (int k = 0; k < nt; ++k) {
    if (touched >> k & 1u) continue;
    T* tile = acc + (long long)(t0 + k) * per_tile;
    for (int e = threadIdx.x; e < per_tile; e += blockDim.x) tile[e] = T(0);
  }
}

// Blocks 0 .. n_touched - 1 take a touched tile each from the CSR list;
// the blocks after them write the untouched tiles' zeros (zero_tiles).
// A touched block's warp 0 forms its rows' geometry in shared memory while
// the other warps (if any) stage the halos, behind one barrier; then each
// pass of the block takes kSlots blockDim.x slots, a thread kSlots of
// them, p0 + tid + j blockDim.x.
template <typename T, int kMode>
__global__ void tile_pairs_kernel(Tiling tl, int n_touched,
                                  const int* __restrict__ tiles,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ halos, Pack<T> pk,
                                  int hc, bool log_curves,
                                  T* __restrict__ acc) {
  constexpr bool paints = kMode != kDisplace;
  constexpr int kOut = paints ? 1 : 2;  // values a slot
  const int P = tl.RB * tl.K;
  const int b = blockIdx.x;  // the touched tile's place in the CSR list
  if (b >= n_touched) {
    zero_tiles<T>(b - n_touched, tl.n_tiles, n_touched, tiles, P * kOut,
                  acc);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Row<T>* rows = reinterpret_cast<Row<T>*>(smem_raw);  // (RB,)
  T* sh_vals = reinterpret_cast<T*>(rows + tl.RB);     // (hc, 7)
  T* sh_curves = sh_vals + hc * kHaloVals;             // (hc, n_r)
  T* sh_curves2 = sh_curves + hc * pk.n_r;             // (hc, n_r2)

  const int t = tiles[b];
  const double* csc = tl.csc + 5 * (long long)t;
  const T c0 = T(tl.center[3 * (long long)t]);
  const T c1 = T(tl.center[3 * (long long)t + 1]);
  const T c2c = T(tl.center[3 * (long long)t + 2]);
  const int first = offsets[b], last = offsets[b + 1];
  const int n_r = pk.n_r;

  // the halos base .. base + nh - 1 of the tile's list into shared memory,
  // a warp a halo, from warp w0 on: lanes 0-6 its values, all lanes its
  // curve
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  auto stage = [&](int base, int nh, int w0) {
    if (warp < w0) return;
    for (int k = warp - w0; k < nh; k += n_warps - w0) {
      const long long h = halos[base + k];
      if (lane < kHaloVals) {
        T v;
        switch (lane) {
          case 0: v = T(pk.vh[3 * h]) - c0; break;
          case 1: v = T(pk.vh[3 * h + 1]) - c1; break;
          case 2: v = T(pk.vh[3 * h + 2]) - c2c; break;
          case 3: v = pk.lnDa[h]; break;
          case 4: v = pk.crit2[h]; break;
          case 5: v = pk.afac[h]; break;
          default: v = paints ? T(0) : pk.invD[h];
        }
        sh_vals[k * kHaloVals + lane] = v;
      }
      for (int i = lane; i < n_r; i += 32)
        sh_curves[k * n_r + i] = pk.curves[h * n_r + i];
      if constexpr (kMode == kPaint2) {
        const int n_r2 = pk.n_r2;
        for (int i = lane; i < n_r2; i += 32)
          sh_curves2[k * n_r2 + i] = pk.curves2[h * n_r2 + i];
      }
    }
  };

  // warp 0 forms the rows while the others stage the halos, when they fit
  // one chunk (else each pass stages its chunks in turn)
  const bool one_chunk = last - first <= hc;
  if (warp == 0)
    for (int u = lane; u < tl.RB; u += 32)
      rows[u] = row_geometry<T>(tl, t, u, csc);
  if (one_chunk) stage(first, last - first, n_warps > 1 ? 1 : 0);
  __syncthreads();

  const T sphc = T(csc[2]), cphc = T(csc[3]);
  // a slot's row u = slot / K without an integer division: (slot + 1/2) /
  // K in float is at least 1 / (2 K) from an integer, and its rounding
  // moves it far less for any tile's slot count
  const float inv_K = 1.0f / float(tl.K);
  for (int p0 = 0; p0 < P; p0 += kSlots * int(blockDim.x)) {
    Slot<T> q[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = p0 + threadIdx.x + j * blockDim.x;
      const int sl = slot < P ? slot : P - 1;
      const int u = int((float(sl) + 0.5f) * inv_K);
      slot_geometry<T>(rows[u], sl - u * tl.K, csc[4], sphc, cphc, q[j]);
    }

    for (int base = first; base < last; base += hc) {
      const int nh = min(hc, last - base);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk is consumed
        stage(base, nh, 0);
        __syncthreads();
      }
      for (int k = 0; k < nh; ++k) {
        const T* hv = sh_vals + k * kHaloVals;
        const T dh0 = hv[0], dh1 = hv[1], dh2 = hv[2];
        const T lnDa = hv[3], crit2 = hv[4], afac = hv[5];
        const T* cv = sh_curves + k * n_r;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          Slot<T>& s = q[j];
          const T e0 = dh0 - s.dp0, e1 = dh1 - s.dp1, e2 = dh2 - s.dp2;
          T chord2 = e0 * e0 + e1 * e1 + e2 * e2;
          chord2 = chord2 > T(1e-30) ? chord2 : T(1e-30);
          const T lnr = T(0.5) * bf::m_log(chord2) + lnDa;
          const T x = (lnr - pk.ln_r0) * pk.inv_dlnr;
          const int i = bf::clampi(int(x), 0, n_r - 2);
          const T tt = x - T(i);
          T val = cv[i] * (T(1) - tt) + cv[i + 1] * tt;
          bool use = x >= T(0) && x <= T(n_r - 1) && chord2 <= crit2;
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
            s.s0 = s.s0 + (use ? pv : T(0)) * afac;
          } else {
            const T dd = (use ? val : T(0)) * afac;
            const T amp = dd * m_rsqrt(chord2) * hv[6];
            const T gth = dh0 * s.eth0 + dh1 * s.eth1 + dh2 * s.eth2;
            const T gph = dh0 * s.eph0 + dh1 * s.eph1 + dh2 * T(0);
            s.s0 = s.s0 + amp;
            s.sth_sum = s.sth_sum + amp * gth;
            s.sph_sum = s.sph_sum + amp * gph;
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int slot = p0 + threadIdx.x + j * blockDim.x;
      if (slot >= P) break;
      const Slot<T>& s = q[j];
      if constexpr (paints) {
        acc[(long long)t * P + slot] =
            (s.valid && isfinite(s.s0)) ? s.s0 : T(0);
      } else {
        const T a_th = s.dp0 * s.eth0 + s.dp1 * s.eth1 + s.dp2 * s.eth2;
        const T a_ph = s.dp0 * s.eph0 + s.dp1 * s.eph1 + s.dp2 * T(0);
        T o0 = s.s0 * a_th - s.sth_sum;
        T o1 = s.s0 * a_ph - s.sph_sum;
        if (!s.valid) o0 = o1 = T(0);
        if (!isfinite(o0)) o0 = T(0);
        if (!isfinite(o1)) o1 = T(0);
        T* out = acc + ((long long)t * P + slot) * 2;
        out[0] = o0;
        out[1] = o1;
      }
    }
  }
}

template <typename T, int kMode>
int launch(int nside, int RB, int K, int n_tiles, int n_touched,
           const int* tiles, const int* offsets, const int* halos,
           const int* tile_i0, const int* tile_s, const int* tile_S,
           const double* center, const double* csc, const double* vh,
           const T* crit2, const T* lnDa, const T* invD, const T* afac,
           const T* curves, int n_r, T ln_r0, T inv_dlnr, const T* curves2,
           int n_r2, T ln_r0_2, T inv_dlnr_2, bool log_curves, T* acc,
           void* stream) {
  const int threads = 32 * kTileWarps;
  if (kMode == kPaint2 && n_r2 < 2) return int(cudaErrorInvalidValue);
  // halos per shared-memory chunk: up to kChunk, within 48 KB after the
  // rows and the zero blocks' static word
  const int rows = RB * int(sizeof(Row<T>));
  const int per_halo =
      int(sizeof(T)) * (kHaloVals + n_r + (kMode == kPaint2 ? n_r2 : 0));
  int hc = (kSmemBytes - rows) / per_halo;
  hc = hc > kChunk ? kChunk : hc;
  if (hc < 1) return int(cudaErrorInvalidValue);
  Tiling tl{nside, RB, K, n_tiles, tile_i0, tile_s, tile_S, center, csc};
  Pack<T> pk{vh,    crit2,    lnDa,    invD, afac,    curves,    n_r,
             ln_r0, inv_dlnr, curves2, n_r2, ln_r0_2, inv_dlnr_2};
  const int blocks = n_touched + (n_tiles + kZeroTiles - 1) / kZeroTiles;
  tile_pairs_kernel<T, kMode>
      <<<blocks, threads, size_t(rows) + size_t(hc) * per_halo,
         (cudaStream_t)stream>>>(tl, n_touched, tiles, offsets, halos, pk,
                                 hc, log_curves, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// n_tiles: the tiling's tiles, all written; n_touched: the CSR's
#define BF_TILE_DEPOSIT(T, SUF)                                              \
  int bf_tile_deposit_##SUF(                                                 \
      int nside, int RB, int K, int n_tiles, int n_touched, const int* tiles, \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* invD, const T* afac, const T* curves, int n_r, T ln_r0,       \
      T inv_dlnr, T* acc, void* stream) {                                    \
    return launch<T, kDisplace>(                                             \
        nside, RB, K, n_tiles, n_touched, tiles, offsets, halos, tile_i0,    \
        tile_s, tile_S, center, csc, vh, crit2, lnDa, invD, afac, curves,    \
        n_r, ln_r0, inv_dlnr, nullptr, 0, T(0), T(0), false, acc, stream);   \
  }                                                                          \
  int bf_tile_paint_##SUF(                                                   \
      int nside, int RB, int K, int n_tiles, int n_touched, const int* tiles, \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* afac, const T* curves, int n_r, T ln_r0, T inv_dlnr,          \
      int log_curves, T* acc, void* stream) {                                \
    return launch<T, kPaint>(                                                \
        nside, RB, K, n_tiles, n_touched, tiles, offsets, halos, tile_i0,    \
        tile_s, tile_S, center, csc, vh, crit2, lnDa, nullptr, afac, curves, \
        n_r, ln_r0, inv_dlnr, nullptr, 0, T(0), T(0), log_curves != 0, acc,  \
        stream);                                                             \
  }                                                                          \
  int bf_tile_paint2_##SUF(                                                  \
      int nside, int RB, int K, int n_tiles, int n_touched, const int* tiles, \
      const int* offsets, const int* halos, const int* tile_i0,              \
      const int* tile_s, const int* tile_S, const double* center,            \
      const double* csc, const double* vh, const T* crit2, const T* lnDa,    \
      const T* afac, const T* curves, const T* curves2, int n_r, T ln_r0,    \
      T inv_dlnr, int n_r2, T ln_r0_2, T inv_dlnr_2, int log_curves, T* acc, \
      void* stream) {                                                        \
    return launch<T, kPaint2>(                                               \
        nside, RB, K, n_tiles, n_touched, tiles, offsets, halos, tile_i0,    \
        tile_s, tile_S, center, csc, vh, crit2, lnDa, nullptr, afac, curves, \
        n_r, ln_r0, inv_dlnr, curves2, n_r2, ln_r0_2, inv_dlnr_2,            \
        log_curves != 0, acc, stream);                                       \
  }

BF_TILE_DEPOSIT(float, f32)
BF_TILE_DEPOSIT(double, f64)
#undef BF_TILE_DEPOSIT

}  // extern "C"
