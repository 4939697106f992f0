// K16: the grid deposit (BaryonifyGrid's regrid).
//
// Replaces baryonforge_tpu/ops/scatter.py: deposit_2d and deposit_3d, as
// BaryonifyGrid's regrid calls them (Map2DRunner.py:447-466): every cell i
// of the periodic N^d grid is a unit square (cube) moved to the lattice
// point plus its offset, pos_d = R(i_d) + R(offset_d) in the map's type R
// (a non-finite offset counts as 0), and its value is shared among the 2^d
// cells it overlaps: per axis p = pos mod N (fmod moved into [0, N), as
// jnp.mod), i0 = floor(p), frac = p - i0, i1 = (i0 + 1) mod N, i0 mod N,
// weights (1 - frac, frac); the corner gets value w_x w_y (w_z), multiplied
// left to right. The offsets are in P, component-major (ndim, N^d), as the
// cutout kernel (K15) leaves them.
//
// Bound: bytes. Per source its offsets and value read once, ~15
// operations an axis and 2^d weighted updates of the new map (134 MB in
// float64 at 256^3, above the 50 MB L2), the map written once: ~0.14 ms
// there. Design: one block a tile of sources, the last axis fastest (Tile:
// 8 x 8 x 32 in 3D, 16 x 64 in 2D), 256 threads, a warp on 32 neighbouring
// cells of a row, a thread down a column of rows. The block sums into a
// window of the tile in shared memory, grown by one cell on each side of
// each axis, its indices wrapped periodically: a source that moves by under
// one cell on every axis has floor(base + off) in [base - 1, base], so all
// its corners lie in the window. A corner outside it (a larger offset)
// adds straight into the map with a global atomic. A corner whose value is
// exactly 0 (a zero weight, the value finite) is skipped: the map starts
// at +0, and adding +-0 changes no sum, while a non-finite value times a
// zero weight is NaN and is kept, so inf and NaN spread as in JAX. On
// sm_90 a float atomicAdd into shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), so a warp first merges along its row: a
// lane's upper corner that is its right neighbour's lower one (the usual
// case: neighbouring offsets floor alike) goes over by shuffle, one atomic
// where there were two. After a barrier the block flushes each nonzero
// window entry with one global atomicAdd (neighbouring windows overlap):
// at most window / tile a source, 1.66 in 3D and 1.16 in 2D, against 2^d.
// The float64 remainders take an exact path for |pos| < 2N (no library
// fmod loop). Sums by atomics change order from run to run.

#include "healpix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;  // 64 registers a thread at most

// the tile (sources) and its window (the tile plus a cell on each side)
template <int NDIM>
struct Tile;
template <>
struct Tile<3> {
  __host__ __device__ static constexpr int ext(int d) {
    return d == 2 ? 32 : 8;
  }
  static constexpr int sources = 8 * 8 * 32;
  static constexpr int window = 10 * 10 * 34;
};
template <>
struct Tile<2> {
  __host__ __device__ static constexpr int ext(int d) {
    return d == 1 ? 64 : 16;
  }
  static constexpr int sources = 16 * 64;
  static constexpr int window = 18 * 66;
};

template <typename P, typename R, int NDIM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
grid_deposit_kernel(int N, long long nflat, const P* __restrict__ po,
                    const R* __restrict__ orig, R* __restrict__ out) {
  using TL = Tile<NDIM>;
  constexpr int X = NDIM - 1;           // the last axis, along the lanes
  constexpr int kRows = TL::sources / kThreads;
  constexpr int kOther = 1 << (NDIM - 2);  // corners of the middle axis
  __shared__ R win[TL::window];
  // this block's tile: its first cell t0 and the window's first cell org
  // (t0 - 1, wrapped), tiles numbered row-major with the last axis fastest
  int t0[NDIM], org[NDIM];
  {
    int b = blockIdx.x;
    for (int d = NDIM - 1; d >= 0; --d) {
      const int nt = (N + TL::ext(d) - 1) / TL::ext(d);
      t0[d] = (b % nt) * TL::ext(d);
      b /= nt;
      org[d] = t0[d] == 0 ? N - 1 : t0[d] - 1;
    }
  }
  for (int e = threadIdx.x; e < TL::window; e += kThreads) win[e] = R(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  auto emit = [&](R val, long long g, int w, bool in_win) {
    if (val == R(0)) return;  // +-0 changes no sum; NaN != 0 is kept
    if (in_win)
      atomicAdd(win + w, val);
    else
      atomicAdd(out + g, val);
  };
  // a thread's column: its lane's cell of the last axis, then rows of
  // axis 0 in order (3D: axis 1 from the thread's group)
  const int col = threadIdx.x % TL::ext(X), grp = threadIdx.x / TL::ext(X);

  for (int j = 0; j < kRows; ++j) {
    int base[NDIM];
    if (NDIM == 3) {
      base[0] = t0[0] + (grp / TL::ext(1)) * kRows + j;
      base[1] = t0[1] + grp % TL::ext(1);
    } else {
      base[0] = t0[0] + grp * kRows + j;
    }
    base[X] = t0[X] + col;
    bool valid = true;
    for (int d = 0; d < NDIM; ++d) valid = valid && base[d] < N;
    // per axis and corner: the weight, the share of the flat index and of
    // the window index, and whether the window holds it (an invalid
    // source: value 0, flat index shares -1)
    R wgt[NDIM][2];
    long long gd[NDIM][2];
    int wd[NDIM][2];
    bool ind[NDIM][2];
    R v = R(0);
    if (valid) {
      long long i = 0;
      for (int d = 0; d < NDIM; ++d) i = i * N + base[d];
      long long stride = 1;
      int wstride = 1;
      for (int d = NDIM - 1; d >= 0; --d) {
        P off = po[d * nflat + i];
        if (!isfinite(off)) off = P(0);
        const R pos = R(base[d]) + R(off);
        // floor_fmod(pos, N) of the plain version: in [0, N], N itself
        // when a tiny negative remainder rounds up
        R p = bf::fmod_near(pos, R(N));
        if (p != R(0) && p < R(0)) p = p + R(N);
        const int i0 = int(bf::m_floor(p));
        const R frac = p - R(i0);
        wgt[d][0] = R(1) - frac;
        wgt[d][1] = frac;
        const int idx[2] = {i0 < N ? i0 : i0 - N,
                            i0 + 1 < N ? i0 + 1 : i0 + 1 - N};
        for (int a = 0; a < 2; ++a) {
          int l = idx[a] - org[d];
          l = l < 0 ? l + N : l;  // in the window when < ext + 2
          gd[d][a] = idx[a] * stride;
          wd[d][a] = l * wstride;
          ind[d][a] = l < TL::ext(d) + 2;
        }
        stride *= N;
        wstride *= TL::ext(d) + 2;
      }
      v = orig[i];
    } else {
      for (int d = 0; d < NDIM; ++d)
        for (int a = 0; a < 2; ++a) {
          wgt[d][a] = R(0);
          gd[d][a] = -1;
          wd[d][a] = 0;
          ind[d][a] = false;
        }
    }
    for (int a0 = 0; a0 < 2; ++a0) {
      const R p0 = v * wgt[0][a0];
      for (int o = 0; o < kOther; ++o) {
        // the two corners along the last axis: (v w_0 [w_1]) w_X, the
        // plain version's left-to-right product
        R c = p0;
        long long g = gd[0][a0];
        int w = wd[0][a0];
        bool in = ind[0][a0];
        if (NDIM == 3) {
          c = c * wgt[1][o];
          g += gd[1][o];
          w += wd[1][o];
          in = in && ind[1][o];
        }
        R val[2] = {c * wgt[X][0], c * wgt[X][1]};
        // the lane to the left hands over its upper corner when it is
        // this lane's lower one (offsets under a cell, floors alike): one
        // shared atomic where there were two
        const long long g_left = __shfl_up_sync(0xffffffffu, g + gd[X][1], 1);
        const R v_left = __shfl_up_sync(0xffffffffu, val[1], 1);
        const bool take = lane > 0 && g_left == g + gd[X][0];
        const bool given = __shfl_down_sync(0xffffffffu, take, 1) && lane < 31;
        if (take) val[0] = val[0] + v_left;
        if (given) val[1] = R(0);
        for (int a = 0; a < 2; ++a)
          emit(val[a], g + gd[X][a], w + wd[X][a], in && ind[X][a]);
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < TL::window; e += kThreads) {
    const R val = win[e];
    if (val == R(0)) continue;
    long long g = 0;
    int rest = e, le[NDIM];
    for (int d = NDIM - 1; d >= 0; --d) {
      le[d] = rest % (TL::ext(d) + 2);
      rest /= (TL::ext(d) + 2);
    }
    for (int d = 0; d < NDIM; ++d) {
      int c = org[d] + le[d];
      while (c >= N) c -= N;  // once, unless N is under the window
      g = g * N + c;
    }
    atomicAdd(out + g, val);
  }
}

template <int NDIM>
long long tiles(int N) {
  long long n = 1;
  for (int d = 0; d < NDIM; ++d)
    n *= (N + Tile<NDIM>::ext(d) - 1) / Tile<NDIM>::ext(d);
  return n;
}

template <typename P, typename R>
int launch(int ndim, int N, const P* po, const R* orig, R* out,
           void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  long long nflat = 1;
  for (int d = 0; d < ndim; ++d) nflat *= N;
  if (nflat == 0) return 0;
  const long long blocks = ndim == 3 ? tiles<3>(N) : tiles<2>(N);
  if (blocks >= (1LL << 31)) return int(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    grid_deposit_kernel<P, R, 3>
        <<<int(blocks), kThreads, 0, s>>>(N, nflat, po, orig, out);
  else
    grid_deposit_kernel<P, R, 2>
        <<<int(blocks), kThreads, 0, s>>>(N, nflat, po, orig, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// offsets in the first type, the maps in the second; out starts at 0
#define BF_GRID_DEPOSIT(P, R, SUF)                                           \
  int bf_grid_deposit_##SUF(int ndim, int N, const P* po, const R* orig,     \
                            R* out, void* stream) {                          \
    return launch<P, R>(ndim, N, po, orig, out, stream);                     \
  }

BF_GRID_DEPOSIT(float, float, f32_f32)
BF_GRID_DEPOSIT(float, double, f32_f64)
BF_GRID_DEPOSIT(double, float, f64_f32)
BF_GRID_DEPOSIT(double, double, f64_f64)
#undef BF_GRID_DEPOSIT

// the kernel's tile extent along an axis (ops.scatter.TILE holds the same)
int bf_grid_deposit_tile(int ndim, int axis) {
  if (ndim == 3 && axis >= 0 && axis < 3) return Tile<3>::ext(axis);
  if (ndim == 2 && axis >= 0 && axis < 2) return Tile<2>::ext(axis);
  return 0;
}

}  // extern "C"
