// K3: scatter regrid (phase B).
//
// Replaces baryonforge_tpu/Runners/HealpixRunner.py: _phase_b and
// _phase_b_sparse, with _weights_for / _weights_chunk (and
// ops/healpix.py: get_interp_weights). Each source pixel moves by its
// accumulated tangent offset (d theta, sin theta d phi), is reflected
// through the pole when it overshoots, and its value is shared among the 4
// healpy interpolation neighbours of its new position. A pixel whose offset
// is exactly zero keeps its own value, an exact identity.
//
// The JAX version passes the pixel centres in as an argument only to keep
// XLA from constant-folding them at compile time. Its sparse form (compact
// the moved pixels, scatter only those) exists because TPU scatter is
// serialised; it equals the dense form up to summation order.
//
// Bound: bytes. The offsets and the map are read once and the new map
// written once (200 MB at NSIDE 1024 in float32); the moved pixels' 4
// weighted shares are atomics into a map the size of the L2. Design, two
// launches on the stream:
//  1. init: a block a tile of kTile pixels, 4 consecutive ones a thread
//     by 16-byte accesses, writes the new map's first values, orig[p]
//     where the offset is exactly (0, 0), else 0 (the plain version's zero
//     map plus the unmoved pixel's own share, which is exact), so no
//     memset and no atomic for an unmoved pixel; and lists the tile's
//     moved pixels in order (a block scan of the threads' counts) with
//     their count, in scratch. Blocks past the tiles fill the per-ring
//     table: ring_theta, the ring's phi step 2 pi / nr and the clamped sin
//     of its colatitude, each in the map's type T by the same device
//     functions as healpix.cuh's pix2ang and interp_weights, so bitwise
//     theirs.
//  2. move: a block a tile's list, a thread a moved pixel, so no lane
//     waits on an unmoved neighbour and the offsets of unmoved pixels are
//     not read again. A warp finds its first pixel's ring once (lane 0,
//     then a shuffle), each lane steps to its own ring by integer ring
//     starts, and the source ring's and both target rings' theta, phi step
//     and sin come from the table: no pix2ang, ring_theta, asin or acos a
//     pixel. What is left a pixel is the displacement, cos theta (and the
//     half angle in the caps) for the ring above, the two rings' phi
//     brackets and 4 atomics.
// Global float atomics are native reductions on sm_90; merging a warp's
// equal targets by shuffle before them measured slower on the H100. The
// offsets come in the deposit's dtype P, the map and the weights in the
// regrid dtype T. Sums by atomics change order from run to run.

#include "healpix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // pixels a tile, 4 a thread

using bf::RingRow;
using bf::TableRings;

// The ring of a warp's first pixel p0 (< npix), found by lane 0 and
// broadcast; every lane of the warp calls it
__device__ __forceinline__ int warp_first_ring(int N, int p0, int lane) {
  int r0 = 0;
  if (lane == 0) r0 = bf::pixel_ring(N, p0);
  return __shfl_sync(bf::kFullMask, r0, 0);
}

// Pixel p's ring (index i in and out), stepping on from ring i (p's or
// one before it) by the ring starts
template <typename T>
__device__ __forceinline__ bf::Ring<T> lane_ring(int N, int p, int& i) {
  bf::Ring<T> r = bf::ring_info<T>(N, i);
  while (p >= r.sp + r.nr) r = bf::ring_info<T>(N, ++i);
  return r;
}

// 4 consecutive pixels from p0 (a multiple of 4): their offset pairs and
// values by 16-byte accesses (the wrapper aligns the arrays to 16 bytes)
__device__ __forceinline__ void load4_pairs(const float* po, int p0,
                                            float o[8]) {
  const float4* v = reinterpret_cast<const float4*>(po + 2 * p0);
  const float4 a = v[0], b = v[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

__device__ __forceinline__ void load4_pairs(const double* po, int p0,
                                            double o[8]) {
  const double2* v = reinterpret_cast<const double2*>(po + 2 * p0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double2 a = v[j];
    o[2 * j] = a.x, o[2 * j + 1] = a.y;
  }
}

__device__ __forceinline__ void load4(const float* x, int p0, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(x + p0);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* x, int p0, double v[4]) {
  const double2 a = reinterpret_cast<const double2*>(x + p0)[0];
  const double2 b = reinterpret_cast<const double2*>(x + p0)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(float* x, int p0, const float v[4]) {
  *reinterpret_cast<float4*>(x + p0) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* x, int p0, const double v[4]) {
  reinterpret_cast<double2*>(x + p0)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(x + p0)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ void load_pair(const float* po, int p, float& a,
                                          float& b) {
  const float2 v = reinterpret_cast<const float2*>(po)[p];
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void load_pair(const double* po, int p, double& a,
                                          double& b) {
  const double2 v = reinterpret_cast<const double2*>(po)[p];
  a = v.x;
  b = v.y;
}

// A moved source's 4 neighbours and shares (bf::displaced_weights times
// the value, with theta_p, its sin and the target rings from the table):
// pixel p, offset (o0, o1), value src, its ring found by stepping on from
// ring k
template <typename P, typename T>
__device__ __forceinline__ void moved_shares(
    int N, int p, P o0, P o1, T src, int& k,
    const RingRow<T>* __restrict__ rings, int pix[4], T v[4]) {
  const bf::Ring<T> rk = lane_ring<T>(N, p, k);
  const RingRow<T> row = rings[k];
  const T phi_p = bf::ring_pixel_phi<T>(N, k, p - rk.sp, rk.shifted);
  T w[4];
  bf::displaced_weights<T>(N, row.theta, phi_p, row.sin_safe, T(o0), T(o1),
                           TableRings<T>{rings}, pix, w);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = w[q] * src;
}

// 1. the new map's first values, a list of each tile's moved pixels, and
// the ring table after the tiles. A block takes a tile of kTile pixels, a
// thread 4 consecutive ones (npix is a multiple of 4); the tile's moved
// pixels go to its slots of `moved` in pixel order (a block scan of the
// threads' counts), their number to counts[tile].
template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
regrid_init_kernel(int N, int npix, int tiles, const P* __restrict__ po,
                   const T* __restrict__ orig, T* __restrict__ out,
                   int* __restrict__ moved, int* __restrict__ counts,
                   RingRow<T>* __restrict__ rings) {
  if (int(blockIdx.x) >= tiles) {
    const int i = (blockIdx.x - tiles) * kThreads + threadIdx.x;
    if (i >= 1 && i < 4 * N) rings[i] = bf::ring_row<T>(N, i);
    return;
  }
  __shared__ int wsum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;
  const int p0 = base + 4 * threadIdx.x;
  bool m[4] = {false, false, false, false};
  int cnt = 0;
  if (p0 < npix) {
    P o[8];
    T v[4];
    load4_pairs(po, p0, o);
    load4(orig, p0, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = !(o[2 * j] == P(0) && o[2 * j + 1] == P(0));
      if (m[j]) v[j] = T(0);
      cnt += m[j];
    }
    store4(out, p0, v);
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(bf::kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int at = base + incl - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    at += w < warp ? wsum[w] : 0;
    total += wsum[w];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (m[j]) moved[at++] = p0 + j;
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// 2. the moved pixels' shares: block b takes tile b's list, a thread an
// entry at a time, a warp 32 consecutive entries (ascending pixels, so it
// finds its first entry's ring and every lane steps on from it). A
// thread's first entry is read with the count, and each entry's offsets
// and value before its ring.
template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
regrid_move_kernel(int N, const P* __restrict__ po,
                   const T* __restrict__ orig,
                   const int* __restrict__ moved,
                   const int* __restrict__ counts,
                   const RingRow<T>* __restrict__ rings,
                   T* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* list = moved + blockIdx.x * kTile;
  int p = list[threadIdx.x];
  const int n = counts[blockIdx.x];
  for (int e0 = warp * 32; e0 < n; e0 += kThreads) {
    const bool live = e0 + lane < n;
    if (e0 != warp * 32 && live) p = list[e0 + lane];
    P o0 = P(0), o1 = P(0);
    T src = T(0);
    if (live) {
      load_pair(po, p, o0, o1);
      src = orig[p];
    }
    int k = warp_first_ring(N, p, lane);  // lane 0's entry is live
    if (!live) continue;
    int pix[4];
    T v[4];
    moved_shares<P, T>(N, p, o0, o1, src, k, rings, pix, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) atomicAdd(out + pix[q], v[q]);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

inline int tiles_for(int npix) { return (npix + kTile - 1) / kTile; }

// the scratch: the ring table, then the tiles' counts and lists
template <typename T>
long long scratch_bytes(int nside) {
  return 4LL * nside * sizeof(RingRow<T>) +
         4LL * tiles_for(12 * nside * nside) * (1 + kTile);
}

template <typename P, typename T>
int launch(int nside, const P* po, const T* orig, void* scratch, T* out,
           void* stream) {
  const int npix = 12 * nside * nside;
  const int tiles = tiles_for(npix);
  auto* rt = static_cast<RingRow<T>*>(scratch);
  int* counts = reinterpret_cast<int*>(rt + 4 * nside);
  int* moved = counts + tiles;
  const cudaStream_t s = (cudaStream_t)stream;
  regrid_init_kernel<P, T><<<tiles + blocks_for(4 * nside), kThreads, 0,
                             s>>>(nside, npix, tiles, po, orig, out, moved,
                                  counts, rt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  regrid_move_kernel<P, T><<<tiles, kThreads, 0, s>>>(nside, po, orig, moved,
                                                      counts, rt, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// *bytes: the scratch bf_regrid_*_<T> needs (the ring table, then the
// tiles' counts and lists of moved pixels), the map in float64 when t64
int bf_regrid_scratch_bytes(int nside, int t64, long long* bytes) {
  *bytes = t64 ? scratch_bytes<double>(nside) : scratch_bytes<float>(nside);
  return 0;
}

int bf_regrid_f32_f32(int nside, const float* po, const float* orig,
                      void* scratch, float* out, void* stream) {
  return launch<float, float>(nside, po, orig, scratch, out, stream);
}

int bf_regrid_f32_f64(int nside, const float* po, const double* orig,
                      void* scratch, double* out, void* stream) {
  return launch<float, double>(nside, po, orig, scratch, out, stream);
}

int bf_regrid_f64_f32(int nside, const double* po, const float* orig,
                      void* scratch, float* out, void* stream) {
  return launch<double, float>(nside, po, orig, scratch, out, stream);
}

int bf_regrid_f64_f64(int nside, const double* po, const double* orig,
                      void* scratch, double* out, void* stream) {
  return launch<double, double>(nside, po, orig, scratch, out, stream);
}

}  // extern "C"
