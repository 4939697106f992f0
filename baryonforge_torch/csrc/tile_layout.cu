// K7: slot <-> RING re-layout of the sky tiling.
//
// Replaces baryonforge_tpu/ops/tiles.py: SkyTiling.flat_view and
// SkyTiling.tile_view (with slot_pix and slot_index). flat_view takes a
// tile-major (n_tiles, RB*K, C) array to RING order (npix, C): every pixel
// reads its slot. tile_view goes back: every slot reads its pixel, and a
// dead slot reads 0. C is 1 (a map) or 2 (tangent offsets).
//
// The JAX version splits the sphere: blocks whose segments are exactly K
// pixels are a pure transpose and only the caps gather, because a computed
// gather was slow on the TPU. Both halves are the same copy of ring
// segments, so here every (tile, row) takes that one path.
//
// Bound: device-memory bytes. One read and one write of C values per pixel
// (slot); the index math is a few integer operations per tile row.
// Design: a copy by (tile, row) segment, driven from the tile side for
// both views. A warp takes kRows consecutive rows (row g = tile * RB + u,
// whose slots are the K * C values at g * K * C of the tile-major array);
// lane l < kRows works out row l's segment once (its ring's first pixel,
// length and the sector's first in-ring index, tiles.cuh: tile_segment)
// and the lanes read it by shuffle. The lanes then walk the rows' values in
// order, four a lane in flight: the tile side is one contiguous run, the
// pixel side at most two runs a row (where the sector wraps past the
// ring's end). 16 rows a warp and 4 values in flight timed fastest of the
// 4-32 rows and 1-16 values tried on an H100 at the bench tiling. Every
// pixel is the live slot of exactly one row (the tiling's sectors
// partition each ring and are at most K - 2 pixels long), so flat_view,
// which writes only live slots, writes each pixel once.

#include "tiles.cuh"

namespace {

constexpr int kWarps = 8;     // warps a block
constexpr int kRows = 16;     // rows a warp
constexpr int kUnroll = 4;    // values a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

// TO_TILES: tile_view (src RING order, dst tile-major); else flat_view
template <typename T, int C, bool TO_TILES>
__global__ void __launch_bounds__(32 * kWarps)
    layout_kernel(int N, int RB, int K, int n_rows,
                  const int* __restrict__ tile_i0,
                  const int* __restrict__ tile_s,
                  const int* __restrict__ tile_S, const T* __restrict__ src,
                  T* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int g0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (g0 >= n_rows) return;                   // the whole warp

  // lane l: row g0 + l's segment; live slots 0 .. live - 1
  int sp = 0, j0 = 0, nr = 1, live = 0;
  const int g = g0 + lane;
  if (lane < kRows && g < n_rows) {
    const int t = g / RB;
    const bf::Seg s = bf::tile_segment(N, tile_i0[t], g - t * RB, tile_s[t],
                                       tile_S[t]);
    sp = s.sp;
    j0 = s.j0;
    nr = s.nr;
    live = s.ok ? min(s.len, K) : 0;
  }
  const int E = K * C;                        // values a row
  const int rows = min(kRows, n_rows - g0);
  const long long base = (long long)g0 * E;

  // value e = r * E + c of the warp's rows; this lane's are lane + 32 k
  int r = lane / E, c = lane - r * E;
  const int per_lane = (kRows * E + 31) / 32;
  for (int k0 = 0; k0 < per_lane; k0 += kUnroll) {
    long long tix[kUnroll], pix[kUnroll];
    bool in[kUnroll], ok[kUnroll];
    T val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      // row r's segment from lane r (every lane shuffles, so r is clamped
      // past the last row)
      const int rr = min(r, kRows - 1);
      const int r_sp = __shfl_sync(kFull, sp, rr);
      const int r_j0 = __shfl_sync(kFull, j0, rr);
      const int r_nr = __shfl_sync(kFull, nr, rr);
      const int r_live = __shfl_sync(kFull, live, rr);
      const int v = C == 1 ? c : c >> 1;
      const int j = r_j0 + v;
      const int jw = j < r_nr ? j : j - r_nr;
      tix[k] = base + (long long)r * E + c;
      pix[k] = (long long)(r_sp + jw) * C + (C == 1 ? 0 : (c & 1));
      in[k] = k0 + k < per_lane && r < rows;
      ok[k] = in[k] && v < r_live;
      val[k] = ok[k] ? src[TO_TILES ? pix[k] : tix[k]] : T(0);
      // this lane's next value, 32 further on
      c += 32;
      while (c >= E) c -= E, ++r;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (TO_TILES ? in[k] : ok[k]) dst[TO_TILES ? tix[k] : pix[k]] = val[k];
    }
  }
}

template <typename T, int C, bool TO_TILES>
int launch(int nside, int RB, int K, int n_tiles, const int* tile_i0,
           const int* tile_s, const int* tile_S, const T* src, T* dst,
           void* stream) {
  const int n_rows = n_tiles * RB;
  const int per_block = kRows * kWarps;       // rows a block
  layout_kernel<T, C, TO_TILES>
      <<<(n_rows + per_block - 1) / per_block, 32 * kWarps, 0,
         (cudaStream_t)stream>>>(nside, RB, K, n_rows, tile_i0, tile_s,
                                 tile_S, src, dst);
  return int(cudaGetLastError());
}

template <typename T, bool TO_TILES>
int launch_c(int nside, int RB, int K, int n_tiles, const int* tile_i0,
             const int* tile_s, const int* tile_S, int C, const T* src,
             T* dst, void* stream) {
  if (C == 1)
    return launch<T, 1, TO_TILES>(nside, RB, K, n_tiles, tile_i0, tile_s,
                                  tile_S, src, dst, stream);
  if (C == 2)
    return launch<T, 2, TO_TILES>(nside, RB, K, n_tiles, tile_i0, tile_s,
                                  tile_S, src, dst, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// both entry points take the same arguments: the tiling (nside, RB, K,
// n_tiles, per-tile i0 / s / S), the width C and the source and
// destination
#define BF_LAYOUT(T, SUF)                                                     \
  int bf_flat_view_##SUF(int nside, int RB, int K, int n_tiles,              \
                         const int* tile_i0, const int* tile_s,              \
                         const int* tile_S, int C, const T* src, T* dst,     \
                         void* stream) {                                     \
    return launch_c<T, false>(nside, RB, K, n_tiles, tile_i0, tile_s,        \
                              tile_S, C, src, dst, stream);                  \
  }                                                                          \
  int bf_tile_view_##SUF(int nside, int RB, int K, int n_tiles,              \
                         const int* tile_i0, const int* tile_s,              \
                         const int* tile_S, int C, const T* src, T* dst,     \
                         void* stream) {                                     \
    return launch_c<T, true>(nside, RB, K, n_tiles, tile_i0, tile_s, tile_S, \
                             C, src, dst, stream);                           \
  }

BF_LAYOUT(float, f32)
BF_LAYOUT(double, f64)
#undef BF_LAYOUT

}  // extern "C"
