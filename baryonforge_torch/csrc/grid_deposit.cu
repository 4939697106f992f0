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
// left to right, added atomically. The offsets are in P, component-major
// (ndim, N^d), as the cutout kernel (K15) leaves them.
//
// Bound: atomics to device memory. Per source ~15 operations an axis and
// 2^d atomicAdds into the new map (134 MB in float64 at 256^3, above the
// 50 MB L2); the bytes, offsets and values read once and the map written
// once, bound it at ~0.2 ms there. Design: a grid-stride loop, one source
// a thread, neighbouring threads on neighbouring cells of the last axis,
// so a warp's corner updates land on few cache lines when the offsets are
// small. Sums by atomics change order from run to run.

#include "healpix.cuh"

namespace {

template <typename P, typename R>
__global__ void grid_deposit_kernel(int ndim, int N, long long nflat,
                                    const P* __restrict__ po,
                                    const R* __restrict__ orig,
                                    R* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nflat; i += stride) {
    int idx[3][2];
    R wgt[3][2];
    long long rest = i;
    for (int d = ndim - 1; d >= 0; --d) {
      const int base = int(rest % N);
      rest /= N;
      P off = po[d * nflat + i];
      if (!isfinite(off)) off = P(0);
      const R pos = R(base) + R(off);
      const R p = bf::floor_fmod(pos, R(N));
      const int i0 = int(bf::m_floor(p));
      const R frac = p - R(i0);
      idx[d][0] = bf::floor_mod(i0, N);
      idx[d][1] = bf::floor_mod(i0 + 1, N);
      wgt[d][0] = R(1) - frac;
      wgt[d][1] = frac;
    }
    const R v = orig[i];
    if (ndim == 2) {
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          atomicAdd(out + (long long)idx[0][a] * N + idx[1][b],
                    v * wgt[0][a] * wgt[1][b]);
    } else {
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          for (int c = 0; c < 2; ++c)
            atomicAdd(out + ((long long)idx[0][a] * N + idx[1][b]) * N +
                          idx[2][c],
                      v * wgt[0][a] * wgt[1][b] * wgt[2][c]);
    }
  }
}

template <typename P, typename R>
int launch(int ndim, int N, const P* po, const R* orig, R* out,
           void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  long long nflat = 1;
  for (int d = 0; d < ndim; ++d) nflat *= N;
  if (nflat == 0) return 0;
  const int threads = 256;
  long long blocks = (nflat + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  grid_deposit_kernel<P, R><<<int(blocks), threads, 0,
                              (cudaStream_t)stream>>>(ndim, N, nflat, po,
                                                      orig, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// offsets in the first type, the maps in the second
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

}  // extern "C"
