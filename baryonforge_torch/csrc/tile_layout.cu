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
// gather was slow on the TPU. Both halves are the same closed-form gather,
// so here every pixel (or slot) takes that one path.
//
// Bound: device-memory bytes. One read and one write of C values per pixel
// (slot), plus the int32 slot math (one float64 square root in the caps).
// Design: one thread per output element, so the writes coalesce; the reads
// follow ring order within a tile row, so a warp reads a few runs of
// neighbouring addresses.

#include "tiles.cuh"

namespace {

template <typename T>
__global__ void flat_view_kernel(int N, int RB, int K,
                                 const int* __restrict__ S_blk,
                                 const int* __restrict__ tile_off, int C,
                                 const T* __restrict__ src,
                                 T* __restrict__ dst) {
  const int npx = 12 * N * N;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npx) return;
  const long long lin = bf::slot_index(N, RB, K, p, S_blk, tile_off);
  for (int c = 0; c < C; ++c)
    dst[(long long)p * C + c] = src[lin * C + c];
}

template <typename T>
__global__ void tile_view_kernel(int N, int RB, int K, int n_tiles,
                                 const int* __restrict__ tile_i0,
                                 const int* __restrict__ tile_s,
                                 const int* __restrict__ tile_S, int C,
                                 const T* __restrict__ src,
                                 T* __restrict__ dst) {
  const int P = RB * K;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_tiles * P) return;
  const int t = int(k / P);
  const int slot = int(k % P);
  const int u = slot / K, v = slot % K;
  const bf::Seg g = bf::tile_segment(N, tile_i0[t], u, tile_s[t], tile_S[t]);
  int jw, pix;
  const bool ok = bf::slot_of(g, v, jw, pix);
  for (int c = 0; c < C; ++c)
    dst[k * C + c] = ok ? src[(long long)pix * C + c] : T(0);
}

template <typename T>
int launch_flat(int nside, int RB, int K, const int* S_blk,
                const int* tile_off, int C, const T* src, T* dst,
                void* stream) {
  const int npx = 12 * nside * nside;
  const int threads = 256;
  flat_view_kernel<T><<<(npx + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(nside, RB, K, S_blk,
                                                tile_off, C, src, dst);
  return int(cudaGetLastError());
}

template <typename T>
int launch_tile(int nside, int RB, int K, int n_tiles, const int* tile_i0,
                const int* tile_s, const int* tile_S, int C, const T* src,
                T* dst, void* stream) {
  const long long total = (long long)n_tiles * RB * K;
  const int threads = 256;
  tile_view_kernel<T><<<int((total + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(nside, RB, K, n_tiles,
                                                tile_i0, tile_s, tile_S, C,
                                                src, dst);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// both entry points take the same arguments: the tiling (nside, RB, K,
// n_tiles, per-tile i0 / s / S, per-block S and tile offsets), the width C
// and the source and destination
#define BF_LAYOUT(T, SUF)                                                     \
  int bf_flat_view_##SUF(int nside, int RB, int K, int n_tiles,              \
                         const int* tile_i0, const int* tile_s,              \
                         const int* tile_S, const int* S_blk,                \
                         const int* tile_off, int C, const T* src, T* dst,   \
                         void* stream) {                                     \
    return launch_flat<T>(nside, RB, K, S_blk, tile_off, C, src, dst,        \
                          stream);                                           \
  }                                                                          \
  int bf_tile_view_##SUF(int nside, int RB, int K, int n_tiles,              \
                         const int* tile_i0, const int* tile_s,              \
                         const int* tile_S, const int* S_blk,                \
                         const int* tile_off, int C, const T* src, T* dst,   \
                         void* stream) {                                     \
    return launch_tile<T>(nside, RB, K, n_tiles, tile_i0, tile_s, tile_S, C, \
                          src, dst, stream);                                 \
  }

BF_LAYOUT(float, f32)
BF_LAYOUT(double, f64)
#undef BF_LAYOUT

}  // extern "C"
