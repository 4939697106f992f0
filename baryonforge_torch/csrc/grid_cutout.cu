// K15: the grid runners' per-halo cutout bodies.
//
// Replaces make_body / one_halo / body of the three Cartesian grid runners
// (baryonforge_tpu/Runners/Map2DRunner.py: BaryonifyGrid 366-434,
// PaintProfilesGrid 551-625, PaintProfilesAnisGrid 747-777, with
// _cutout_geometry 276-289). Every halo of a launch walks the same cutout
// of Ns^d cells (its size bucket's largest Ns), from -Ns/2 to Ns/2 - 1 on
// each axis around its nearest grid centre `cen`, wrapped periodically:
//   rel_d = (i_d - Ns/2) res + d_off_d (float64, as under x64),
//   r = |rel|, or |rel Rmat| for a 2D halo with ellipticity,
// and, by mode:
//   displace (T the offsets' type): d = raw curve at max(r, 1e-30) rscale,
//     0 unless r < rmax (eps_max Rcom rounded to T), rounded to T, over
//     res in float64, zeroed if not finite; per axis d T(rel_d / r) in
//     float64, zeroed if not finite, rounded to T and added atomically into
//     the (ndim, nflat) offsets (pixel widths);
//   paint: the curve (log curves exp'd) at r, over a in 2D (projected
//     curves), added into the float64 map where finite and r < rmax
//     (eps_max R_com);
//   anis: painting and canvas (two curves at r, each over a, non-finite
//     values zeroed), mfrac = canvas / Mtot[cell] (0 where Mtot <= 0) times
//     orig[cell], painting mfrac added where finite and r < rmax.
// The lookups are float64 from curves stored in T (lookup.cuh).
//
// Bound: atomics. A cell costs ~40-60 operations (a square root, a log,
// one or two lerps, an exp for log curves) and one to three atomicAdds
// into a map of 4 or 8 bytes a cell (the 3D ΔP(k) grid: 134 MB f64 map, 201
// MB f32 offsets, above the 50 MB L2). Design: blockIdx.x is the halo,
// blockIdx.y a chunk of 1024 of its cells, 256 threads of 4 cells each,
// neighbouring threads on neighbouring cells of the last axis so that a
// warp's atomics land on neighbouring addresses; the halo's columns are
// read once a block and the curve from L1. The JAX version pads a bucket's
// halos to a static batch and scans the batches; here every halo of the
// bucket is one row of the grid. Sums by atomics change order from run to
// run.

#include "healpix.cuh"
#include "lookup.cuh"

namespace {

enum Mode { kDisplace = 0, kPaint = 1, kAnis = 2 };

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 4;

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
};

template <typename T, int kMode>
__global__ void grid_cutout_kernel(Cutout<T> p, void* acc_raw) {
  const int h = blockIdx.x;
  const int nd = p.ndim, Ns = p.Ns, N = p.N, w = Ns / 2;
  int cen[3];
  double doff[3];
  for (int d = 0; d < nd; ++d) {
    cen[d] = p.cen[h * nd + d];
    doff[d] = p.doff[h * nd + d];
  }
  const double rmax = p.rmax[h];
  const bool ell = p.rmat != nullptr;
  double R00 = 0, R01 = 0, R10 = 0, R11 = 0;
  if (ell) {
    R00 = p.rmat[4 * h];
    R01 = p.rmat[4 * h + 1];
    R10 = p.rmat[4 * h + 2];
    R11 = p.rmat[4 * h + 3];
  }
  const double rscale = kMode == kDisplace ? p.rscale[h] : 1.0;
  const T* curve1 = p.c1.c + (long long)h * p.c1.n_r;
  const T* curve2 = kMode == kAnis ? p.c2.c + (long long)h * p.c2.n_r
                                   : nullptr;
  const long long n_cells =
      nd == 2 ? (long long)Ns * Ns : (long long)Ns * Ns * Ns;
  const long long per_block = (long long)kThreads * kCellsPerThread;
  for (long long c0 = (long long)blockIdx.y * per_block; c0 < n_cells;
       c0 += (long long)gridDim.y * per_block) {
    for (int k = 0; k < kCellsPerThread; ++k) {
      const long long c = c0 + (long long)k * kThreads + threadIdx.x;
      if (c >= n_cells) break;
      int o[3];
      if (nd == 2) {
        o[0] = int(c / Ns) - w;
        o[1] = int(c % Ns) - w;
      } else {
        o[0] = int(c / ((long long)Ns * Ns)) - w;
        o[1] = int((c / Ns) % Ns) - w;
        o[2] = int(c % Ns) - w;
      }
      double g[3];
      long long flat = 0;
      for (int d = 0; d < nd; ++d) {
        g[d] = double(o[d]) * p.res + doff[d];
        flat = flat * N + bf::floor_mod(cen[d] + o[d], N);
      }
      double r;
      if (nd == 3) {
        r = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
      } else if (ell) {
        const double xe = g[0] * R00 + g[1] * R10;
        const double ye = g[0] * R01 + g[1] * R11;
        r = sqrt(xe * xe + ye * ye);
      } else {
        r = sqrt(g[0] * g[0] + g[1] * g[1]);
      }
      if constexpr (kMode == kDisplace) {
        const double r_safe = r > 1e-30 ? r : 1e-30;
        double dv = bf::lookup64(curve1, p.c1, r_safe * rscale);
        if (!(r < rmax)) dv = 0.0;
        double dd = double(T(dv)) / p.res;  // pixel units
        if (!isfinite(dd)) dd = 0.0;
        T* acc = static_cast<T*>(acc_raw);
        for (int d = 0; d < nd; ++d) {
          double comp = dd * double(T(g[d] / r));
          if (!isfinite(comp)) comp = 0.0;
          atomicAdd(acc + d * p.nflat + flat, T(comp));
        }
      } else {
        double v;
        if constexpr (kMode == kPaint) {
          v = bf::lookup64(curve1, p.c1, r);
          if (nd == 2) v = v / p.a;
        } else {
          double painting = bf::lookup64(curve1, p.c1, r) / p.a;
          double canvas = bf::lookup64(curve2, p.c2, r) / p.a;
          if (!isfinite(painting)) painting = 0.0;
          if (!isfinite(canvas)) canvas = 0.0;
          const double mt = p.mtot[flat];
          v = painting * ((mt > 0.0 ? canvas / mt : 0.0) * p.orig[flat]);
        }
        if (isfinite(v) && r < rmax)
          atomicAdd(static_cast<double*>(acc_raw) + flat, v);
      }
    }
  }
}

template <typename T>
int launch(int n_h, Cutout<T> p, int mode, void* acc, void* stream) {
  if (n_h <= 0) return 0;
  if (p.ndim != 2 && p.ndim != 3) return int(cudaErrorInvalidValue);
  const long long n_cells =
      p.ndim == 2 ? (long long)p.Ns * p.Ns : (long long)p.Ns * p.Ns * p.Ns;
  long long chunks = (n_cells + kThreads * kCellsPerThread - 1) /
                     (kThreads * kCellsPerThread);
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(n_h, unsigned(chunks));
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kDisplace)
    grid_cutout_kernel<T, kDisplace><<<grid, kThreads, 0, s>>>(p, acc);
  else if (mode == kPaint)
    grid_cutout_kernel<T, kPaint><<<grid, kThreads, 0, s>>>(p, acc);
  else if (mode == kAnis)
    grid_cutout_kernel<T, kAnis><<<grid, kThreads, 0, s>>>(p, acc);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// curves (and the displace offsets) in T; geometry, lookups and the paint
// maps in float64
#define BF_GRID_CUTOUT(T, SUF)                                                \
  int bf_grid_cutout_##SUF(                                                   \
      int ndim, int N, int Ns, int n_h, int mode, const int* cen,             \
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
                orig};                                                        \
    return launch<T>(n_h, p, mode, acc, stream);                              \
  }

BF_GRID_CUTOUT(float, f32)
BF_GRID_CUTOUT(double, f64)
#undef BF_GRID_CUTOUT

}  // extern "C"
