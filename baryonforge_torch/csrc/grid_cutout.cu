// K15: the grid runners' per-halo cutout bodies.
//
// Replaces make_body / one_halo / body of the three Cartesian grid runners
// (baryonforge_tpu/Runners/Map2DRunner.py: BaryonifyGrid 366-434,
// PaintProfilesGrid 551-625, PaintProfilesAnisGrid 747-777, with
// _cutout_geometry 276-289). Every halo of a launch walks the same cutout
// of Ns^d cells (its size bucket's largest Ns), offsets o from -w to
// Ns - 1 - w on each axis (w = floor(Ns/2); Ns may be odd) around its
// nearest grid centre `cen`, wrapped periodically:
//   rel_d = o_d res + d_off_d (float64, as under x64),
//   r = |rel|, or |rel Rmat| for a 2D halo with ellipticity,
// and, by mode:
//   displace (T the offsets' type): d = raw curve at max(r, 1e-30) rscale,
//     0 unless r < rmax (eps_max Rcom rounded to T), rounded to T, over
//     res in float64, zeroed if not finite; per axis d T(rel_d / r) in
//     float64, zeroed if not finite, rounded to T and added into the
//     (ndim, nflat) offsets (pixel widths) in T;
//   paint: the curve (log curves exp'd) at r, over a in 2D (projected
//     curves), added into the float64 map where finite and r < rmax
//     (eps_max R_com);
//   anis: painting and canvas (two curves at r, each over a, non-finite
//     values zeroed), mfrac = canvas / Mtot[cell] (0 where Mtot <= 0) times
//     orig[cell], painting mfrac added where finite and r < rmax.
// The lookups are float64 from curves stored in T (lookup.cuh). A cell
// with r >= rmax adds nothing in any mode, so it takes no lookup.
//
// Bound: float64 operations, ~50 a cell with r < rmax in a halo's box (a
// square root, a log, one or two lerps, an exp for log curves); the maps
// (the 3D grid's 134 MB float64 map, 201 MB float32 offsets) are read and
// written once. Design: the grid is cut into tiles of kTile3^3 cells (3D)
// or kTile2^2 (2D), the last ones partial when N is not a multiple; one
// block a tile, one thread a cell. Each tile's halos are listed on the
// card, in ascending halo index: bf_tile_pairs keys every (halo, candidate
// tile) pair, dropping a tile whose nearest point lies beyond rmax (plus a
// cell) when there is no ellipticity, and ops/grid.py sorts the keys. The
// block
// reads its cells' values of the accumulator (and, anis, of Mtot and the
// map) once, stages the listed halos' columns in shared memory kBatch at a
// time, adds every listed halo's terms in that order in registers,
// and writes each touched cell once: tiles are disjoint, so no atomics,
// and the sums come out the same on every call. A cell's box offset comes
// from 32-bit integers: (x - (cen - Ns/2)) mod N, one conditional add.
//
// K22: the same bodies for models without halo_curves (the direct branch
// of the three JAX bodies: model.displacement, Map2DRunner.py:410;
// model.projected / model.real, :584, :609; model.projected and
// tracer.projected, :757-759). Map2DRunner reads the model on chunks of a
// size bucket's halos (a cell budget, which the readout's temporaries
// set) and groups consecutive chunks up to a value budget; for a group:
//   bf_grid_radii writes each cutout cell's r (float64, the geometry
//     above, ellipticity included), halo-major with the cells row-major in
//     the box (the last axis fastest): a block a (halo, plane of the box)
//     in 3D, (halo, 8 rows) in 2D, a thread a cell of a row, 32-bit
//     indices from the launch, each row written coalesced;
//   the model is read on the rows chunk by chunk (ops/direct.py);
//   bf_grid_direct adds the group's values through the tile body above in
//     one launch, each (halo, cell) reading its value from the rows instead
//     of a curve:
//   displace: d = the value (in T) over res in float64, zeroed if not
//     finite; per axis d T(rel_d / r), zeroed if not finite, rounded to T
//     and added into the offsets, at every cell of the box (the direct
//     body has no r < rmax cut: the wrapper passes rmax = inf);
//   paint: the value (float64) added where finite and r < rmax;
//   anis: painting and canvas (float64, non-finite zeroed), mfrac as
//     above, painting mfrac added where finite and r < rmax.
// The group's tile lists are made once (as K15's); the wrapper compacts
// the tiles they touch into a list whose length stays on the device, and
// a persistent grid (the SMs times the blocks resident on each) walks it,
// a block taking the next tile from a counter as it finishes one, so no
// block is launched for an untouched tile and nothing is read back.
// A tile adds its listed halos in ascending order holding each running sum
// in the map's type, so one apply over chunks 1..k equals k applies in
// sequence bit for bit.
// Bound: the radii pass by its writes (8 bytes a cell); the apply by its
// reads of the rows (4 or 8 bytes, 16 for anis, a (halo, cell) pair) and
// the map read and written once, beside ~20 float64 operations a pair.

#include "healpix.cuh"
#include "lookup.cuh"

namespace {

enum Mode { kDisplace = 0, kPaint = 1, kAnis = 2 };

constexpr int kTile3 = 8;   // 3D tiles: 8^3 cells, 512 threads
constexpr int kTile2 = 16;  // 2D tiles: 16^2 cells, 256 threads
constexpr int kBatch = 256;  // halo columns staged at a time

template <typename T>
struct Cutout {
  int ndim, N, Ns;
  long long nflat;
  double res;
  const int* cen;        // (n, ndim) nearest grid centre
  const double* doff;    // (n, ndim) bins[cen] - pos
  const double* rmax;    // (n,) cells with r < rmax count
  const double* rscale;  // (n,) displace: radius scale of the lookup
  const double* rmat;    // (n, 4) 2D shear matrices (row-major), or null
  bf::Curve<T> c1, c2;   // the curve; anis: the painting's and the canvas'
  double a;              // 2D (projected curves): paint values over a
  const double* mtot;    // anis: the total-mass canvas, background included
  const double* orig;    // anis: the input map
  const void* vals;      // direct: (n, Ns^d) values, T (displace) or double
  const double* vals2;   // direct anis: the canvas' values
  long long cells;       // direct: Ns^d, a row's length
};

// the offset od_d of every axis of cell `local` of a box of Ns^d cells
// (row-major, the last axis fastest)
template <int kDim>
__device__ __forceinline__ long long box_local(const int* od, int Ns) {
  long long l = 0;
  for (int d = 0; d < kDim; ++d) l = l * Ns + od[d];
  return l;
}

// tile t's cells, its halos tile_halo[first .. last) (first < last): the
// body of one block (every thread of the block calls it)
template <typename T, int kMode, int kDim, bool kDirect>
__device__ __forceinline__ void cutout_tile(const Cutout<T>& p, int t,
                                            int first, int last,
                                            const int* __restrict__ tile_halo,
                                            void* acc_raw) {
  constexpr int TS = kDim == 3 ? kTile3 : kTile2;
  const int N = p.N, Ns = p.Ns, w = Ns / 2;
  const int nt = (N + TS - 1) / TS;
  // this thread's cell: the tile's origin plus threadIdx, the last axis
  // fastest
  int x[3];
  if (kDim == 3) {
    x[0] = (t / (nt * nt)) * TS + int(threadIdx.x >> 6);
    x[1] = ((t / nt) % nt) * TS + int((threadIdx.x >> 3) & 7);
    x[2] = (t % nt) * TS + int(threadIdx.x & 7);
  } else {
    x[0] = (t / nt) * TS + int(threadIdx.x >> 4);
    x[1] = (t % nt) * TS + int(threadIdx.x & 15);
  }
  bool inside = true;
  long long flat = 0;
  for (int d = 0; d < kDim; ++d) {
    inside = inside && x[d] < N;
    flat = flat * N + (x[d] < N ? x[d] : 0);
  }
  T sum[kDim];  // displace: the offsets' running sums, in T
  double acc_v = 0.0, mt = 0.0, og = 0.0;
  if (inside) {
    if constexpr (kMode == kDisplace) {
      const T* acc = static_cast<const T*>(acc_raw);
      for (int d = 0; d < kDim; ++d) sum[d] = acc[d * p.nflat + flat];
    } else {
      acc_v = static_cast<const double*>(acc_raw)[flat];
      if constexpr (kMode == kAnis) {
        mt = p.mtot[flat];
        og = p.orig[flat];
      }
    }
  }
  // the listed halos' columns, a batch at a time; lo = (cen - Ns/2) mod N
  __shared__ int s_h[kBatch], s_lo[kBatch * kDim];
  __shared__ double s_doff[kBatch * kDim], s_rmax[kBatch], s_rscale[kBatch];
  __shared__ double s_rmat[kDim == 2 ? kBatch * 4 : 1];
  const bool ell = p.rmat != nullptr;
  bool touched = false;
  for (int q0 = first; q0 < last; q0 += kBatch) {
    const int nb = min(kBatch, last - q0);
    __syncthreads();  // the last batch is spent
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const int h = tile_halo[q0 + i];
      s_h[i] = h;
      for (int d = 0; d < kDim; ++d) {
        s_lo[i * kDim + d] = bf::floor_mod(p.cen[h * kDim + d] - w, N);
        s_doff[i * kDim + d] = p.doff[h * kDim + d];
      }
      s_rmax[i] = p.rmax[h];
      if (kMode == kDisplace && !kDirect) s_rscale[i] = p.rscale[h];
      if (kDim == 2 && ell)
        for (int k = 0; k < 4; ++k) s_rmat[i * 4 + k] = p.rmat[4 * h + k];
    }
    __syncthreads();
    if (!inside) continue;
    for (int i = 0; i < nb; ++i) {
      // box offsets o_d = od - Ns/2, od = (x - lo) mod N < Ns
      double g[kDim];
      int ods[kDim];
      bool in_box = true;
      for (int d = 0; d < kDim; ++d) {
        int od = x[d] - s_lo[i * kDim + d];
        if (od < 0) od += N;
        in_box = in_box && od < Ns;
        ods[d] = od;
        g[d] = double(od - w) * p.res + s_doff[i * kDim + d];
      }
      if (!in_box) continue;
      double r2;
      if constexpr (kDim == 3) {
        r2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
      } else if (ell) {
        const double* R = s_rmat + 4 * i;
        const double xe = g[0] * R[0] + g[1] * R[2];
        const double ye = g[0] * R[1] + g[1] * R[3];
        r2 = xe * xe + ye * ye;
      } else {
        r2 = g[0] * g[0] + g[1] * g[1];
      }
      // r >= rmax adds nothing in any mode; the square test skips the
      // root where r is surely past rmax, the root decides the rest
      const double rmax = s_rmax[i];
      if (r2 > rmax * rmax * (1.0 + 1e-12)) continue;
      const double r = sqrt(r2);
      if (!(r < rmax)) continue;
      const int h = s_h[i];
      // direct: this (halo, cell)'s place in the rows
      const long long slot =
          kDirect ? (long long)h * p.cells + box_local<kDim>(ods, Ns) : 0;
      if constexpr (kMode == kDisplace) {
        double dd;
        if constexpr (kDirect) {
          dd = double(static_cast<const T*>(p.vals)[slot]) / p.res;
        } else {
          const T* curve1 = p.c1.c + (long long)h * p.c1.n_r;
          const double r_safe = r > 1e-30 ? r : 1e-30;
          const double dv =
              bf::lookup64(curve1, p.c1, r_safe * s_rscale[i]);
          dd = double(T(dv)) / p.res;  // pixel units
        }
        if (!isfinite(dd)) dd = 0.0;
        for (int d = 0; d < kDim; ++d) {
          double comp = dd * double(T(g[d] / r));
          if (!isfinite(comp)) comp = 0.0;
          sum[d] = sum[d] + T(comp);
        }
        touched = true;
      } else {
        double v;
        if constexpr (kMode == kPaint && kDirect) {
          v = static_cast<const double*>(p.vals)[slot];
        } else if constexpr (kMode == kPaint) {
          const T* curve1 = p.c1.c + (long long)h * p.c1.n_r;
          v = bf::lookup64(curve1, p.c1, r);
          if (kDim == 2) v = v / p.a;
        } else {
          double painting, canvas;
          if constexpr (kDirect) {
            painting = static_cast<const double*>(p.vals)[slot];
            canvas = p.vals2[slot];
          } else {
            const T* curve1 = p.c1.c + (long long)h * p.c1.n_r;
            const T* curve2 = p.c2.c + (long long)h * p.c2.n_r;
            painting = bf::lookup64(curve1, p.c1, r) / p.a;
            canvas = bf::lookup64(curve2, p.c2, r) / p.a;
          }
          if (!isfinite(painting)) painting = 0.0;
          if (!isfinite(canvas)) canvas = 0.0;
          v = painting * ((mt > 0.0 ? canvas / mt : 0.0) * og);
        }
        if (isfinite(v)) {
          acc_v = acc_v + v;
          touched = true;
        }
      }
    }
  }
  if (!inside || !touched) return;
  if constexpr (kMode == kDisplace) {
    T* acc = static_cast<T*>(acc_raw);
    for (int d = 0; d < kDim; ++d) acc[d * p.nflat + flat] = sum[d];
  } else {
    static_cast<double*>(acc_raw)[flat] = acc_v;
  }
}

// K15: a block a tile of the grid, its lists tile_start / tile_halo
template <typename T, int kMode, int kDim>
__global__ void __launch_bounds__(kDim == 3 ? 512 : 256)
grid_cutout_kernel(Cutout<T> p, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_halo, void* acc_raw) {
  const int t = blockIdx.x;
  const int first = tile_start[t], last = tile_start[t + 1];
  if (first == last) return;
  cutout_tile<T, kMode, kDim, false>(p, t, first, last, tile_halo, acc_raw);
}

// K22's apply: a persistent grid over the work[0] tiles of `tiles` (the
// touched ones, compacted), a block a tile at a time, each block taking
// the next tile from the counter work[1] (0 at the launch) as it finishes
// one, so that tiles of many halos do not pile up on one block. In 3D the
// registers are capped so that 3 blocks of 512 threads fit an SM (a few
// spill; 2-10% faster than 2 blocks on an apply group, chip_probes.py K22)
template <typename T, int kMode, int kDim>
__global__ void __launch_bounds__(kDim == 3 ? 512 : 256, kDim == 3 ? 3 : 1)
grid_direct_kernel(Cutout<T> p, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_halo,
                   const int* __restrict__ tiles, int* __restrict__ work,
                   void* acc_raw) {
  __shared__ int s_next;
  const int n = work[0];
  for (;;) {
    __syncthreads();  // every thread has read the last s_next
    if (threadIdx.x == 0) s_next = atomicAdd(work + 1, 1);
    __syncthreads();
    const int i = s_next;
    if (i >= n) return;
    const int t = tiles[i];
    cutout_tile<T, kMode, kDim, true>(p, t, tile_start[t], tile_start[t + 1],
                                      tile_halo, acc_raw);
  }
}

// the (tile, halo) pairs of halos h0 .. h0 + m - 1, each one's K^d
// candidate tiles from the tile of its box's first cell (halo-major, the
// last axis fastest): key = the row-major tile id, or n_tiles where the
// box misses the tile or, with prune, where the per-axis lower bounds of
// |rel_d| over the tile's box cells, squared and summed, reach (rmax +
// res)^2; the same operations as ops/grid.tile_pairs_plain
__global__ void tile_pairs_kernel(int ndim, int N, int Ns, int TS, int K,
                                  int h0, int m, const int* __restrict__ cen,
                                  const double* __restrict__ doff, double res,
                                  const double* __restrict__ rmax, int prune,
                                  int* __restrict__ key,
                                  int* __restrict__ owner) {
  const int per = ndim == 3 ? K * K * K : K * K;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * per) return;
  const int h = h0 + idx / per;
  int c = idx % per, digit[3];
  for (int d = ndim - 1; d >= 0; --d) {
    digit[d] = c % K;
    c /= K;
  }
  const int nt = (N + TS - 1) / TS, w = Ns / 2;
  int tid = 0;
  double lb2 = 0.0;
  for (int d = 0; d < ndim; ++d) {
    const int cd = cen[h * ndim + d];
    const double od = doff[h * ndim + d];
    const int t = (bf::floor_mod(cd - w, N) / TS + digit[d]) % nt;
    const int lo_cell = t * TS, hi_cell = min(lo_cell + TS, N) - 1;
    const double ostar = -od / res;
    double lb = INFINITY;
    for (int k = -1; k <= 1; ++k) {  // the tile's copies one period apart
      const int lo = max(lo_cell + k * N - cd, -w);
      const int hi = min(hi_cell + k * N - cd, Ns - 1 - w);
      double dist = fmin(fabs(double(lo) * res + od),
                         fabs(double(hi) * res + od));
      if (double(lo) <= ostar && ostar <= double(hi)) dist = 0.0;
      if (lo <= hi) lb = fmin(lb, dist);
    }
    tid = tid * nt + t;
    lb2 = d == 0 ? lb * lb : lb2 + lb * lb;
  }
  bool keep = isfinite(lb2);
  if (prune) {
    const double reach = rmax[h] + res;
    keep = keep && lb2 < reach * reach;
  }
  key[idx] = keep ? tid : (ndim == 3 ? nt * nt * nt : nt * nt);
  owner[idx] = h;
}

// K15: a block a tile of the grid
template <typename T, int kMode, int kDim>
int launch_tiles(int n_tiles, const Cutout<T>& p, const int* tile_start,
                 const int* tile_halo, void* acc, cudaStream_t s) {
  grid_cutout_kernel<T, kMode, kDim>
      <<<n_tiles, kDim == 3 ? 512 : 256, 0, s>>>(p, tile_start, tile_halo,
                                                 acc);
  return int(cudaGetLastError());
}

// K22's apply on at most n_tiles touched tiles: the SMs times the blocks
// each holds at once, no more blocks than tiles
template <typename T, int kMode, int kDim>
int launch_direct(int n_tiles, const Cutout<T>& p, const int* tile_start,
                  const int* tile_halo, const int* tiles, int* work,
                  void* acc, cudaStream_t s) {
  constexpr int threads = kDim == 3 ? 512 : 256;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_direct_kernel<T, kMode, kDim>, threads, 0);
  if (err != cudaSuccess) return int(err);
  const int blocks = max(1, min(n_tiles, sms * max(per_sm, 1)));
  grid_direct_kernel<T, kMode, kDim><<<blocks, threads, 0, s>>>(
      p, tile_start, tile_halo, tiles, work, acc);
  return int(cudaGetLastError());
}

template <int kMode, int kDim>
struct Shape {
  static constexpr int mode = kMode, dim = kDim;
};

// go(Shape<mode, dimension>{}, n_tiles) for the modes and dimensions the
// bodies have, tiles of `tile` cells a side
template <typename T, typename Go>
int by_shape(int tile, const Cutout<T>& p, int mode, Go go) {
  const int nd = p.ndim;
  if ((nd != 2 && nd != 3) || tile != (nd == 3 ? kTile3 : kTile2))
    return int(cudaErrorInvalidValue);
  const int nt = (p.N + tile - 1) / tile;
  const int n = nd == 3 ? nt * nt * nt : nt * nt;
  if (mode == kDisplace)
    return nd == 3 ? go(Shape<kDisplace, 3>{}, n)
                   : go(Shape<kDisplace, 2>{}, n);
  if (mode == kPaint)
    return nd == 3 ? go(Shape<kPaint, 3>{}, n) : go(Shape<kPaint, 2>{}, n);
  if (mode == kAnis && nd == 2) return go(Shape<kAnis, 2>{}, n);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch(int tile, const Cutout<T>& p, int mode, const int* tile_start,
           const int* tile_halo, void* acc, void* stream) {
  return by_shape(tile, p, mode, [&](auto shape, int n_tiles) {
    using S = decltype(shape);
    return launch_tiles<T, S::mode, S::dim>(n_tiles, p, tile_start, tile_halo,
                                            acc, (cudaStream_t)stream);
  });
}

template <typename T>
int launch_direct_mode(int tile, const Cutout<T>& p, int mode,
                       const int* tile_start, const int* tile_halo,
                       const int* tiles, int* work, void* acc, void* stream) {
  return by_shape(tile, p, mode, [&](auto shape, int n_tiles) {
    using S = decltype(shape);
    return launch_direct<T, S::mode, S::dim>(n_tiles, p, tile_start,
                                             tile_halo, tiles, work, acc,
                                             (cudaStream_t)stream);
  });
}

// K22's radii pass: a block (32, 8) a halo blockIdx.x and, in 3D, a plane
// ox = blockIdx.y of its box (the rows oy by threadIdx.y, 8 apart), in 2D
// the rows ox = 8 blockIdx.y + threadIdx.y; a thread a cell of a row (the
// last axis, 32 apart); r (float64) as the tile kernel measures it into
// r[h Ns^d + the cell's row-major place in the box]
template <int kDim>
__global__ void __launch_bounds__(256)
grid_radii_kernel(int Ns, const double* __restrict__ doff, double res,
                  const double* __restrict__ rmat, double* __restrict__ r) {
  const int h = blockIdx.x;
  const int w = Ns / 2;
  const int cells = kDim == 3 ? Ns * Ns * Ns : Ns * Ns;
  double* out = r + (long long)h * cells;
  const double* dh = doff + (long long)h * kDim;
  if constexpr (kDim == 3) {
    const int ox = blockIdx.y;
    const double gx = double(ox - w) * res + dh[0];
    for (int oy = threadIdx.y; oy < Ns; oy += blockDim.y) {
      const double gy = double(oy - w) * res + dh[1];
      double* row = out + (ox * Ns + oy) * Ns;
      for (int oz = threadIdx.x; oz < Ns; oz += 32) {
        const double gz = double(oz - w) * res + dh[2];
        row[oz] = sqrt(gx * gx + gy * gy + gz * gz);
      }
    }
  } else {
    const int ox = blockIdx.y * blockDim.y + threadIdx.y;
    if (ox >= Ns) return;
    const double gx = double(ox - w) * res + dh[0];
    double* row = out + ox * Ns;
    const double* R = rmat != nullptr ? rmat + 4LL * h : nullptr;
    for (int oy = threadIdx.x; oy < Ns; oy += 32) {
      const double gy = double(oy - w) * res + dh[1];
      double r2;
      if (R != nullptr) {
        const double xe = gx * R[0] + gy * R[2];
        const double ye = gx * R[1] + gy * R[3];
        r2 = xe * xe + ye * ye;
      } else {
        r2 = gx * gx + gy * gy;
      }
      row[oy] = sqrt(r2);
    }
  }
}

}  // namespace

extern "C" {

// curves (and the displace offsets) in T; geometry, lookups and the paint
// maps in float64; tile_start (n_tiles + 1) and tile_halo, each tile's
// halos in ascending order, from ops/grid.py, with tiles of `tile` cells a
// side
#define BF_GRID_CUTOUT(T, SUF)                                                \
  int bf_grid_cutout_##SUF(                                                   \
      int ndim, int N, int Ns, int tile, int mode, const int* tile_start,     \
      const int* tile_halo, const int* cen,                                   \
      const double* doff, double res, const double* rmax,                     \
      const double* rscale, const double* rmat, const T* curves, int n_r,     \
      double ln_r0, double dlnr, int log1, const T* curves2, int n_r2,        \
      double ln_r0_2, double dlnr_2, int log2, double a, const double* mtot,  \
      const double* orig, void* acc, void* stream) {                          \
    long long nflat = 1;                                                      \
    for (int d = 0; d < ndim; ++d) nflat *= N;                                \
    Cutout<T> p{ndim,                                                         \
                N,                                                            \
                Ns,                                                           \
                nflat,                                                        \
                res,                                                          \
                cen,                                                          \
                doff,                                                         \
                rmax,                                                         \
                rscale,                                                       \
                rmat,                                                         \
                bf::Curve<T>{curves, n_r, ln_r0, dlnr, log1 != 0},            \
                bf::Curve<T>{curves2, n_r2, ln_r0_2, dlnr_2, log2 != 0},      \
                a,                                                            \
                mtot,                                                         \
                orig,                                                         \
                nullptr,                                                      \
                nullptr};                                                     \
    return launch<T>(tile, p, mode, tile_start, tile_halo, acc, stream);      \
  }

BF_GRID_CUTOUT(float, f32)
BF_GRID_CUTOUT(double, f64)
#undef BF_GRID_CUTOUT

// K22's apply: the tile body reading each (halo, cell)'s value from the
// rows vals (n, Ns^d) (T for displace, float64 otherwise; vals2 the anis
// canvas'), the halos' columns and lists those of one apply; tiles the
// touched tiles, work (2,) on the device: their number, then 0 (the
// apply's tile counter, advanced by the launch)
#define BF_GRID_DIRECT(T, SUF)                                                \
  int bf_grid_direct_##SUF(                                                   \
      int ndim, int N, int Ns, int tile, int mode, const int* tile_start,     \
      const int* tile_halo, const int* tiles, int* work,                      \
      const int* cen, const double* doff, double res, const double* rmax,     \
      const double* rmat, const void* vals, const double* vals2,              \
      const double* mtot, const double* orig, void* acc, void* stream) {      \
    long long nflat = 1, cells = 1;                                           \
    for (int d = 0; d < ndim; ++d) {                                          \
      nflat *= N;                                                             \
      cells *= Ns;                                                            \
    }                                                                         \
    Cutout<T> p{ndim, N, Ns, nflat, res, cen, doff, rmax, nullptr, rmat,      \
                bf::Curve<T>{nullptr, 2, 0.0, 1.0, false},                    \
                bf::Curve<T>{nullptr, 2, 0.0, 1.0, false},                    \
                1.0, mtot, orig, vals, vals2};                                \
    p.cells = cells;                                                          \
    return launch_direct_mode<T>(tile, p, mode, tile_start, tile_halo, tiles, \
                                 work, acc, stream);                          \
  }

BF_GRID_DIRECT(float, f32)
BF_GRID_DIRECT(double, f64)
#undef BF_GRID_DIRECT

// K22's radii pass: r (m, Ns^d) float64 for m halos' offsets doff (m,
// ndim) and shear matrices rmat ((m, 4) or null; 2D); Ns^d under 2^31, Ns
// under 2^16
int bf_grid_radii(int ndim, int Ns, int m, const double* doff, double res,
                  const double* rmat, double* r, void* stream) {
  if (m == 0 || Ns == 0) return 0;
  if ((ndim != 2 && ndim != 3) || Ns > 65535 ||
      (long long)Ns * Ns * (ndim == 3 ? Ns : 1) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 threads(32, 8);
  if (ndim == 3)
    grid_radii_kernel<3><<<dim3(unsigned(m), unsigned(Ns)), threads, 0, s>>>(
        Ns, doff, res, nullptr, r);
  else
    grid_radii_kernel<2><<<dim3(unsigned(m), unsigned((Ns + 7) / 8)), threads,
                           0, s>>>(Ns, doff, res, rmat, r);
  return int(cudaGetLastError());
}

int bf_tile_pairs(int ndim, int N, int Ns, int tile, int K, int h0, int m,
                  const int* cen, const double* doff, double res,
                  const double* rmax, int prune, int* key, int* owner,
                  void* stream) {
  const long long total =
      (long long)m * (ndim == 3 ? (long long)K * K * K : (long long)K * K);
  if (total == 0) return 0;
  if ((ndim != 2 && ndim != 3) || tile != (ndim == 3 ? kTile3 : kTile2) ||
      total > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  tile_pairs_kernel<<<unsigned((total + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(ndim, N, Ns, tile, K, h0, m,
                                               cen, doff, res, rmax, prune,
                                               key, owner);
  return int(cudaGetLastError());
}

}  // extern "C"
