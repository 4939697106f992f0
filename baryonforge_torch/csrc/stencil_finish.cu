// K6: the stencil regrid's scatter complement, and its source list.
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py: _get_stencil_geo and
// _get_stencil_geo_ang (the once-per-NSIDE list of the geometric tiles'
// valid slots, with each slot's pixel, theta and phi) and
// _get_stencil_finish (geo_pairs, pairs_for and scatter_all, with
// _weights_for). The stencil (K5) handles the sources of every tile that
// is not excluded; the complement scatters the sources of the excluded
// ones: the geometric tiles D_geom (polar caps, sector-count transitions,
// dilated by one tile) and the hot tiles of this call (offsets past the
// stencil's window, listed on the host). Each source moves by its tangent
// offset and shares its value among the 4 interpolation neighbours of its
// new position, added into the flat map that already holds flat_view (K7)
// of the stencil's output. An unmoved source adds its value to its own
// pixel, an exact identity.
//
// stencil_geo: a block a geometric tile; warp 0 lays out the tile's ring
// rows in shared memory (each row's valid-slot count, a shuffle prefix of
// them, its first in-ring index and its ring's start and length), then a
// thread a valid slot writes (slot id, pixel): its place in the list is
// the tile's offset (host prefix sum of the valid-slot counts) plus its
// rank in the tile, the order of the JAX nonzero. Blocks past the tiles
// fill the per-ring table (bf::RingRow, shared with K3): the target form
// (bf::ring_row: theta, phi step, clamped sin as interp_weights takes a
// target ring's) at [i], the source form (bf::source_ring_row: the
// float64 ring_theta rounded to T, as the JAX stencil takes a source's
// colatitude, and its sin) at [4 N + i], by the same device functions as
// pix2ang, so bitwise theirs. A source's phi is formed from its pixel and
// ring in float64 (jw + sh / 2) * 2 pi / nr, rounded to T, the JAX
// list's formula; so the list holds only what cannot be derived, 8 bytes
// a source.
//
// stencil_complement, one launch: a thread a source of the geometric list
// (two coalesced 4-byte reads), or, a block a hot tile, a thread a valid
// slot of the tile (its ring rows laid out as above: no thread for a dead
// slot). An unmoved source adds its value to its own pixel by one atomic;
// a moved source shares its value among 4 pixels by 4: its ring from its
// pixel, its angles as above, bf::displaced_weights reading both target
// rings' theta and phi step from the table (bf::TableRings). What the
// H100 showed (chip_probes.py K6): a thread a source beats 4 a thread
// (their moved sources' dependent table reads run in turn), the table
// beats forming the rings' angles a source, and one launch beats two as
// K3 has (the first doing the unmoved sources' adds without atomics and
// listing the moved ones): an unmoved source's atomic is a
// fire-and-forget reduction where a plain add must read first, and only
// a quarter of the sources move.
//
// Bound: bytes. The sources' offsets and values are read once and each
// touched pixel updated (667,648 geometric sources at the bench, 25.6%
// moved); the list adds 8 bytes a source. Sums by atomics change order
// from run to run.

#include "tiles.cuh"

namespace {

using bf::RingRow;
using bf::TableRings;

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;              // ring rows a tile (RB)

// a tile's valid slots by ring row: row u holds the tile's valid slots
// start[u] .. start[u + 1] - 1 (its first min(len, K) slots; none for a
// ring off the sphere), its first in-ring index j0 and its ring's first
// pixel sp and length nr
struct TileRows {
  int start[kMaxRows + 1];
  int j0[kMaxRows], sp[kMaxRows], nr[kMaxRows];
};

// warp 0 lays out tile (i0, s, S)'s RB rows, lane u row u; the caller
// syncs before reading
__device__ __forceinline__ void tile_rows(int N, int RB, int K, int i0, int s,
                                          int S, TileRows& tr) {
  if (threadIdx.x >= 32) return;
  const int u = threadIdx.x;
  int cnt = 0;
  if (u < RB) {
    const bf::Seg g = bf::tile_segment(N, i0, u, s, S);
    const int len = g.len < K ? g.len : K;
    cnt = g.ok && len > 0 ? len : 0;
    tr.j0[u] = g.j0;
    tr.sp[u] = g.sp;
    tr.nr[u] = g.nr;
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(bf::kFullMask, incl, d);
    if (u >= d) incl += y;
  }
  if (u < RB) tr.start[u + 1] = incl;
  if (u == 0) tr.start[0] = 0;
}

// the tile's e-th valid slot (e < start[RB]): its slot in the tile and
// its pixel
__device__ __forceinline__ void slot_at(const TileRows& tr, int RB, int K,
                                        int e, int& slot, int& pix) {
  int lo = 0, hi = RB - 1;        // the last row starting at or before e
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tr.start[mid] <= e) lo = mid;
    else hi = mid - 1;
  }
  const int v = e - tr.start[lo];
  const int j = tr.j0[lo] + v;
  slot = lo * K + v;
  pix = tr.sp[lo] + (j < tr.nr[lo] ? j : j - tr.nr[lo]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_geo_kernel(int N, int RB, int K, int n_g,
                   const int* __restrict__ g_tids,
                   const int* __restrict__ g_off,
                   const int* __restrict__ tile_i0,
                   const int* __restrict__ tile_s,
                   const int* __restrict__ tile_S, int* __restrict__ sf,
                   int* __restrict__ pix, RingRow<T>* __restrict__ rows) {
  if (int(blockIdx.x) >= n_g) {
    const int i = (blockIdx.x - n_g) * kThreads + threadIdx.x;
    if (i < 4 * N) {
      rows[i] = i >= 1 ? bf::ring_row<T>(N, i) : RingRow<T>{};
      rows[4 * N + i] = i >= 1 ? bf::source_ring_row<T>(N, i) : RingRow<T>{};
    }
    return;
  }
  __shared__ TileRows tr;
  const int t = g_tids[blockIdx.x];
  tile_rows(N, RB, K, tile_i0[t], tile_s[t], tile_S[t], tr);
  __syncthreads();
  const int n = tr.start[RB];
  const long long base = g_off[blockIdx.x];
  const int PS = RB * K;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    int slot, p;
    slot_at(tr, RB, K, e, slot, p);
    sf[base + e] = t * PS + slot;
    pix[base + e] = p;
  }
}

__device__ __forceinline__ void load_pair(const float* po, int slot, float& a,
                                          float& b) {
  const float2 v = reinterpret_cast<const float2*>(po)[slot];
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void load_pair(const double* po, int slot,
                                          double& a, double& b) {
  const double2 v = reinterpret_cast<const double2*>(po)[slot];
  a = v.x;
  b = v.y;
}

// a moved source's 4 shares: the source at pixel p, offset (o0, o1), value
// src; its angles from its ring (the table's source form) and its pixel,
// the target rings' from the table's target form
template <typename P, typename T>
__device__ __forceinline__ void move_source(int N, int p, P o0, P o1, T src,
                                            const RingRow<T>* rows, T* out) {
  const int i = bf::pixel_ring(N, p);
  const bf::Ring<T> ri = bf::ring_info<T>(N, i);
  const RingRow<T> row = rows[4 * N + i];
  const double sh = ri.shifted != T(0) ? 1.0 : 0.0;
  const T phi_p = T((double(p - ri.sp) + 0.5 * sh) *
                    (bf::kTwoPi / double(ri.nr)));
  int pix[4];
  T w[4];
  bf::displaced_weights<T>(N, row.theta, phi_p, row.sin_safe, T(o0), T(o1),
                           TableRings<T>{rows}, pix, w);
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(out + pix[c], w[c] * src);
}

// a source's shares: its offset and value, then one atomic to its own
// pixel where it did not move, else move_source's 4
template <typename P, typename T>
__device__ __forceinline__ void add_source(int N, int slot, int p,
                                           const P* __restrict__ acc,
                                           const T* __restrict__ orig,
                                           const RingRow<T>* rows, T* out) {
  P o0, o1;
  load_pair(acc, slot, o0, o1);
  const T v = orig[slot];
  if (o0 == P(0) && o1 == P(0)) atomicAdd(out + p, v);
  else move_source<P, T>(N, p, o0, o1, v, rows, out);
}

// The complement: a thread takes one entry of the geometric list, or, in
// the blocks after those, a block takes one hot tile (its ring rows laid
// out in shared memory, a thread only for valid slots)
template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
stencil_complement_kernel(int N, int RB, int K, int n_geo, int geo_blocks,
                          const int* __restrict__ sf,
                          const int* __restrict__ gpix,
                          const int* __restrict__ hot,
                          const int* __restrict__ tile_i0,
                          const int* __restrict__ tile_s,
                          const int* __restrict__ tile_S,
                          const P* __restrict__ acc,
                          const T* __restrict__ orig,
                          const RingRow<T>* __restrict__ rows,
                          T* __restrict__ out) {
  if (int(blockIdx.x) < geo_blocks) {
    const int k = blockIdx.x * kThreads + threadIdx.x;
    if (k < n_geo) add_source<P, T>(N, sf[k], gpix[k], acc, orig, rows, out);
    return;
  }
  __shared__ TileRows tr;
  const int t = hot[blockIdx.x - geo_blocks];
  tile_rows(N, RB, K, tile_i0[t], tile_s[t], tile_S[t], tr);
  __syncthreads();
  for (int e = threadIdx.x; e < tr.start[RB]; e += kThreads) {
    int slot, p;
    slot_at(tr, RB, K, e, slot, p);
    add_source<P, T>(N, t * RB * K + slot, p, acc, orig, rows, out);
  }
}

inline int geo_blocks_for(int n_geo) {
  return (n_geo + kThreads - 1) / kThreads;
}

bool tiling_ok(int RB) { return RB <= kMaxRows; }

template <typename T>
int launch_geo(int nside, int RB, int K, int n_g, const int* g_tids,
               const int* g_off, const int* tile_i0, const int* tile_s,
               const int* tile_S, int* sf, int* pix, void* rows,
               void* stream) {
  if (!tiling_ok(RB)) return int(cudaErrorInvalidValue);
  const int table_blocks = (4 * nside + kThreads - 1) / kThreads;
  stencil_geo_kernel<T><<<n_g + table_blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      nside, RB, K, n_g, g_tids, g_off, tile_i0, tile_s, tile_S, sf, pix,
      static_cast<RingRow<T>*>(rows));
  return int(cudaGetLastError());
}

template <typename P, typename T>
int launch(int nside, int RB, int K, int n_geo, const int* sf,
           const int* gpix, const void* rows, int n_hot, const int* hot,
           const int* tile_i0, const int* tile_s, const int* tile_S,
           const P* acc, const T* orig, T* out, void* stream) {
  if (!tiling_ok(RB)) return int(cudaErrorInvalidValue);
  const int geo_blocks = geo_blocks_for(n_geo);
  const int blocks = geo_blocks + n_hot;
  if (blocks == 0) return 0;
  stencil_complement_kernel<P, T><<<blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
      nside, RB, K, n_geo, geo_blocks, sf, gpix, hot, tile_i0, tile_s,
      tile_S, acc, orig, static_cast<const RingRow<T>*>(rows), out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// the compact list of the valid slots of tiles g_tids (n_g tiles, valid
// slots of tile b at g_off[b] ...): slot id t * RB * K + slot and pixel;
// and the ring table rows (2 x 4 nside bf::RingRow in the regrid dtype:
// the target form, then the source form)
#define BF_GEO(T, SUF)                                                        \
  int bf_stencil_geo_##SUF(int nside, int RB, int K, int n_g,                \
                           const int* g_tids, const int* g_off,              \
                           const int* tile_i0, const int* tile_s,            \
                           const int* tile_S, int* sf, int* pix, void* rows, \
                           void* stream) {                                   \
    return launch_geo<T>(nside, RB, K, n_g, g_tids, g_off, tile_i0, tile_s,  \
                         tile_S, sf, pix, rows, stream);                     \
  }

BF_GEO(float, f32)
BF_GEO(double, f64)
#undef BF_GEO

// adds the complement into out (npix,): offsets acc (n_tiles, RB*K, 2) in
// the deposit dtype (first suffix), orig (n_tiles, RB*K), out and the ring
// table rows in the regrid dtype (second suffix)
#define BF_COMPLEMENT(P, T, SUF)                                              \
  int bf_stencil_complement_##SUF(                                            \
      int nside, int RB, int K, int n_geo, const int* sf, const int* gpix,   \
      const void* rows, int n_hot, const int* hot, const int* tile_i0,       \
      const int* tile_s, const int* tile_S, const P* acc, const T* orig,     \
      T* out, void* stream) {                                                \
    return launch<P, T>(nside, RB, K, n_geo, sf, gpix, rows, n_hot, hot,     \
                        tile_i0, tile_s, tile_S, acc, orig, out, stream);    \
  }

BF_COMPLEMENT(float, float, f32_f32)
BF_COMPLEMENT(float, double, f32_f64)
BF_COMPLEMENT(double, float, f64_f32)
BF_COMPLEMENT(double, double, f64_f64)
#undef BF_COMPLEMENT

}  // extern "C"
