// K17: the snapshot displacement (BaryonifySnapshot).
//
// Replaces make_run / one_halo / body of
// baryonforge_tpu/Runners/SnapshotRunner.py:175-227. For every (halo,
// particle) pair of the neighbour search, with T the offsets' type and the
// JAX x64 promotions written out:
//   dx_c = p_c - h_c in float64, minus L where > L/2, plus L where < -L/2
//     (one wrap, :179-182); d = |dx| in float64 (x, y, z summed in order);
//   r = T(d > 0 ? d : 1e-30) * rscale_h in T, and the halo's curve read at
//     r by BaryonificationClass.curve_lookup in T (x = (log max(r, 1e-30) -
//     ln_r0) / dlnr with ln_r0 and dlnr rounded to T, the bracket floor(x)
//     clamped to [0, n_r - 2], the lerp c_i (1 - t) + c_{i+1} t, zero where
//     x < 0 or x > n_r - 1; BaryonCorrection.py:303-318);
//   off = that value where T(d) < eps_edge_h (:192), zeroed where not
//     finite (:198);
//   vec_c = off * T(dx_c / d_safe), d_safe = d > 0 ? d : 1 (:199), summed
//     per particle into acc[c, particle] ((ndim, n_part) in T).
// The JAX version pads each count bucket's halos to its largest count,
// scans halo batches and scatters one component at a time into a flat
// accumulator with a dummy row; the counts are exact, so none of that
// changes a sum, and none of it is here.
//
// Bound: bytes. A pair reads its row index, and a particle its position
// (float64) once and writes its ndim offsets once; the per-row records
// (20,000 of 32 or 48 bytes at the bench) and the curves (3.8 MB in
// float32) stay in L2. ~40 operations a pair, a third of them float64.
// Design: a gather, no atomics. The pairs come particle-major
// (ops.snapshot.particle_major_plain, built once per pair set): the
// particles in a space-filling order (`order`, so that a warp's particles
// share their halos in L1), each particle's halo-major rows prow[poff[s]
// .. poff[s + 1]) in ascending order. One thread a particle walks its rows
// in that order, reads each row's packed record (position, rscale,
// eps_edge: one aligned slot, built by the wrapper per call) and the
// curve's two bracketing entries from global memory, sums in registers and
// writes each component once. The sum runs in the halo-major order, the
// order of a sequential index_add_ over the halo-major pairs, the same in
// every launch. Compiled with --fmad=false, as the plain version computes
// each product and sum as its own rounded operation.
// Chunks: a snapshot's halos may come in chunks, in ascending halo order
// (the runner's PAIR_BUDGET). With `accumulate` each particle's sum starts
// from its running value in acc instead of 0 (a particle without rows in
// the chunk is left as it is), so the chunks' terms are added in the one
// chunk's order and the result is the same bit for bit.
//
// K23: the same body for models without halo_curves (the direct branch,
// off = model.displacement(d, M_h, a), SnapshotRunner.py:196). The model
// is read between two launches (ops/snapshot.py, ops/direct.py); both read
// a layout built once per pair set (ops/snapshot.direct_layout): each
// halo-major row's first slot and width in the readout's padded rows, the
// rows cut into pieces of at most `piece` pairs, and one 8-byte record
// (slot, halo) per particle-major entry.
//   radii: a warp a piece. The row's halo position is read once into
//     registers, the lanes read the piece's particles coalesced (their
//     places in K17's Morton order, where the layout keeps a copy of the
//     positions, so that a row's particles, found cell by cell, read
//     nearby positions) and write each pair's float64 minimum-image
//     distance d (as above, unclamped: the model gets d itself) coalesced
//     into the row; the row's first piece also writes its pads 0. No
//     per-pair index is formed.
//   gather: a warp 32 consecutive particles of the particle-major layout,
//     whose entries are consecutive. The lanes take the entries 32 at a
//     time, coalesced: each reads its record, finds its particle among the
//     warp's 32 (a binary search of their offsets in shared memory; its
//     position from the Morton-ordered copy, the warp's 32 side by side),
//     reads the value and forms the term off * T(dx_c / d_safe), off the value
//     in T zeroed where not finite, into shared memory; then each
//     particle's own lane adds its entries' terms one by one. So every
//     particle's sum runs in the halo-major order, term for term as the
//     plain version forms it, the same in every launch; no atomics.
// Bound: bytes. Positions and halo positions read once, per pair its
// particle (radii) and its value (gather) read, r written once, the
// offsets written once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// a row's record: the halo's position in float64 (the third entry unused
// in 2D), then rscale and eps_edge in T (ops.snapshot._records builds it)
template <typename T>
struct alignas(16) Record;
template <>
struct alignas(16) Record<float> {
  double pos[3];
  float rscale, edge;
};
template <>
struct alignas(16) Record<double> {
  double pos[3];
  double rscale, edge, unused;
};
static_assert(sizeof(Record<float>) == 32, "one 32-byte sector a record");
static_assert(sizeof(Record<double>) == 48, "three 16-byte loads a record");

template <typename T>
__device__ __forceinline__ T bf_log(T x);
template <>
__device__ __forceinline__ float bf_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double bf_log<double>(double x) { return log(x); }

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads)
snapshot_gather_kernel(int n_part, double L, const double* __restrict__ coords,
                       const int* __restrict__ order,
                       const int* __restrict__ poff,
                       const int* __restrict__ prow,
                       const int* __restrict__ halos,
                       const Record<T>* __restrict__ rec,
                       const T* __restrict__ curves, int n_r, T ln_r0, T dlnr,
                       int accumulate, T* __restrict__ acc) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_part) return;
  const int k0 = poff[s], k1 = poff[s + 1];
  if (accumulate && k0 == k1) return;  // its running sum stands
  const int p = order[s];
  double pp[NDIM];
  for (int c = 0; c < NDIM; ++c) pp[c] = coords[(long long)p * NDIM + c];
  T sum[NDIM];
  for (int c = 0; c < NDIM; ++c)
    sum[c] = accumulate ? acc[(long long)c * n_part + p] : T(0);
  const double half = L / 2;
  for (int k = k0; k < k1; ++k) {
    const int r = prow[k];
    const Record<T> h = rec[r];
    const T* curve = curves + (long long)halos[r] * n_r;
    double dx[NDIM];
    double d2 = 0.0;
    for (int c = 0; c < NDIM; ++c) {
      double v = pp[c] - h.pos[c];
      if (v > half) v -= L;
      if (v < -half) v += L;
      dx[c] = v;
      d2 = d2 + v * v;
    }
    const double d = sqrt(d2);
    const double d_safe = d > 0.0 ? d : 1.0;
    const T rr = T(d > 0.0 ? d : 1e-30) * h.rscale;
    const T x = (bf_log<T>(rr > T(1e-30) ? rr : T(1e-30)) - ln_r0) / dlnr;
    const T xf = floor(x);
    const int i = xf < T(0) ? 0 : (xf > T(n_r - 2) ? n_r - 2 : int(xf));
    const T t = x - T(i);
    T off = curve[i] * (T(1) - t) + curve[i + 1] * t;
    if (x < T(0) || x > T(n_r - 1)) off = T(0);
    if (!(T(d) < h.edge)) off = T(0);
    if (!isfinite(off)) off = T(0);
    for (int c = 0; c < NDIM; ++c) sum[c] = sum[c] + off * T(dx[c] / d_safe);
  }
  for (int c = 0; c < NDIM; ++c) acc[(long long)c * n_part + p] = sum[c];
}

constexpr int kGatherWarps = 4;    // gather: warps a block

// K23's gather: a warp 32 consecutive particles s0 .. s0 + 31 of the
// particle-major layout (order, poff), their positions coords[s] (in that
// order), its entries' records rec (slot, halo) and values vals[slot]
template <typename T, int NDIM>
__global__ void __launch_bounds__(32 * kGatherWarps)
snapshot_direct_kernel(int n_part, double L, const double* __restrict__ coords,
                       const int* __restrict__ order,
                       const int* __restrict__ poff,
                       const int2* __restrict__ rec,
                       const double* __restrict__ hpos,
                       const T* __restrict__ vals, int accumulate,
                       T* __restrict__ acc) {
  __shared__ int s_off[kGatherWarps][33];
  __shared__ T s_term[kGatherWarps][NDIM][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s0 = (blockIdx.x * kGatherWarps + w) * 32;
  if (s0 >= n_part) return;  // the whole warp
  int* off = s_off[w];
  off[lane] = poff[min(s0 + lane, n_part)];
  if (lane == 0) off[32] = poff[min(s0 + 32, n_part)];
  __syncwarp();
  const int e0 = off[0], e1 = off[32];
  const int my0 = off[lane], my1 = off[lane + 1];
  const double half = L / 2;
  const bool mine = s0 + lane < n_part;
  const long long own = mine ? order[s0 + lane] : 0;  // the lane's particle
  T sum[NDIM];
  for (int c = 0; c < NDIM; ++c)
    sum[c] = accumulate && mine ? acc[c * (long long)n_part + own] : T(0);
  for (int c0 = e0; c0 < e1; c0 += 32) {
    const int k = c0 + lane;
    if (k < e1) {
      // the entry's particle: the last of the warp's whose first entry <= k
      int i = 0;
      for (int step = 16; step > 0; step >>= 1)
        if (off[i + step] <= k) i += step;
      const long long p = s0 + i;
      const int2 e = rec[k];
      double dx[NDIM];
      double d2 = 0.0;
      for (int c = 0; c < NDIM; ++c) {
        double v = coords[p * NDIM + c] - hpos[(long long)e.y * NDIM + c];
        if (v > half) v -= L;
        if (v < -half) v += L;
        dx[c] = v;
        d2 = d2 + v * v;
      }
      const double d = sqrt(d2);
      const double d_safe = d > 0.0 ? d : 1.0;
      T val = vals[e.x];
      if (!isfinite(val)) val = T(0);
      for (int c = 0; c < NDIM; ++c)
        s_term[w][c][lane] = val * T(dx[c] / d_safe);
    }
    __syncwarp();
    const int a = max(my0, c0), b = min(my1, c0 + 32);
    for (int kk = a; kk < b; ++kk)
      for (int c = 0; c < NDIM; ++c) sum[c] = sum[c] + s_term[w][c][kk - c0];
    __syncwarp();
  }
  if (mine && !(accumulate && my0 == my1))
    for (int c = 0; c < NDIM; ++c) acc[c * (long long)n_part + own] = sum[c];
}

// K23's radii pass: a warp a piece (row, first pair j0) of the halo-major
// CSR (offsets, parts), parts the particles' places in coords, the row's
// first slot and width slots[row]; d (float64) of pair j into r[slot + j],
// the pads of the row 0
template <int NDIM>
__global__ void __launch_bounds__(256)
snapshot_radii_kernel(int n_pieces, int piece_len, double L,
                      const double* __restrict__ coords,
                      const double* __restrict__ hpos,
                      const int* __restrict__ halos,
                      const int* __restrict__ offsets,
                      const int* __restrict__ parts,
                      const int2* __restrict__ slots,
                      const int2* __restrict__ pieces,
                      double* __restrict__ r) {
  const int piece = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (piece >= n_pieces) return;
  const int2 pc = pieces[piece];
  const int row = pc.x;
  const int o0 = offsets[row], count = offsets[row + 1] - o0;
  const int2 sl = slots[row];
  const long long h = halos[row];
  double hp[NDIM];
  for (int c = 0; c < NDIM; ++c) hp[c] = hpos[h * NDIM + c];
  double* out = r + sl.x;
  const double half = L / 2;
  const int j1 = min(count, pc.y + piece_len);
  for (int j = pc.y + lane; j < j1; j += 32) {
    const long long p = parts[o0 + j];
    double d2 = 0.0;
    for (int c = 0; c < NDIM; ++c) {
      double v = coords[p * NDIM + c] - hp[c];
      if (v > half) v -= L;
      if (v < -half) v += L;
      d2 = d2 + v * v;
    }
    out[j] = sqrt(d2);
  }
  if (pc.y == 0)
    for (int j = count + lane; j < sl.y; j += 32) out[j] = 0.0;
}

template <typename T>
int launch(int ndim, int n_part, double L, const double* coords,
           const int* order, const int* poff, const int* prow,
           const int* halos, const void* rec, const T* curves, int n_r,
           double ln_r0, double dlnr, int accumulate, T* acc, void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n_part == 0) return 0;
  const int blocks = (n_part + kThreads - 1) / kThreads;
  const Record<T>* r = static_cast<const Record<T>*>(rec);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    snapshot_gather_kernel<T, 3><<<blocks, kThreads, 0, s>>>(
        n_part, L, coords, order, poff, prow, halos, r, curves, n_r,
        T(ln_r0), T(dlnr), accumulate, acc);
  else
    snapshot_gather_kernel<T, 2><<<blocks, kThreads, 0, s>>>(
        n_part, L, coords, order, poff, prow, halos, r, curves, n_r,
        T(ln_r0), T(dlnr), accumulate, acc);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// coords (n_part, ndim) float64; order (n_part,), poff (n_part + 1,), prow
// (P,) the particle-major layout; halos (R,) each halo-major row's halo;
// rec (R,) the rows' records; curves (n_halos, n_r) in T; acc (ndim,
// n_part) in T, every entry written (accumulate 0: each sum from 0) or
// each particle's sum continued from its entry (accumulate 1: a chunk of
// the halos after the earlier ones)
#define BF_SNAPSHOT(T, SUF)                                                  \
  int bf_snapshot_displace_##SUF(                                            \
      int ndim, int n_part, double L, const double* coords, const int* order, \
      const int* poff, const int* prow, const int* halos, const void* rec,   \
      const T* curves, int n_r, double ln_r0, double dlnr, int accumulate,   \
      T* acc, void* stream) {                                                \
    return launch<T>(ndim, n_part, L, coords, order, poff, prow, halos, rec, \
                     curves, n_r, ln_r0, dlnr, accumulate, acc, stream);     \
  }

BF_SNAPSHOT(float, f32)
BF_SNAPSHOT(double, f64)
#undef BF_SNAPSHOT

// K23's gather: coords (n_part, ndim) float64 the positions in `order`;
// rec (P, 2) int32 each particle-major entry's (slot in vals, halo); hpos
// (n_halos, ndim) float64; vals (n_slots,) in T; accumulate as for
// bf_snapshot_displace
#define BF_SNAPSHOT_DIRECT(T, SUF)                                           \
  int bf_snapshot_direct_##SUF(int ndim, int n_part, double L,               \
                               const double* coords, const int* order,       \
                               const int* poff, const int* rec,              \
                               const double* hpos, const T* vals,            \
                               int accumulate, T* acc, void* stream) {       \
    if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);           \
    if (n_part == 0) return 0;                                               \
    const int per = 32 * kGatherWarps;                                       \
    const int blocks = (n_part + per - 1) / per;                             \
    const int2* e = reinterpret_cast<const int2*>(rec);                      \
    cudaStream_t s = (cudaStream_t)stream;                                   \
    if (ndim == 3)                                                           \
      snapshot_direct_kernel<T, 3><<<blocks, per, 0, s>>>(                   \
          n_part, L, coords, order, poff, e, hpos, vals, accumulate, acc);   \
    else                                                                     \
      snapshot_direct_kernel<T, 2><<<blocks, per, 0, s>>>(                   \
          n_part, L, coords, order, poff, e, hpos, vals, accumulate, acc);   \
    return int(cudaGetLastError());                                          \
  }

BF_SNAPSHOT_DIRECT(float, f32)
BF_SNAPSHOT_DIRECT(double, f64)
#undef BF_SNAPSHOT_DIRECT

// K23's radii pass over n_pieces pieces of at most `piece` pairs (see
// snapshot_radii_kernel): slots (R, 2) and pieces (n_pieces, 2) int32
int bf_snapshot_radii(int ndim, int n_pieces, int piece, double L,
                      const double* coords,
                      const double* hpos, const int* halos,
                      const int* offsets, const int* parts, const int* slots,
                      const int* pieces, double* r, void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n_pieces == 0) return 0;
  const unsigned blocks = unsigned((n_pieces + 7) / 8);
  const int2* sl = reinterpret_cast<const int2*>(slots);
  const int2* pc = reinterpret_cast<const int2*>(pieces);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    snapshot_radii_kernel<3><<<blocks, 256, 0, s>>>(
        n_pieces, piece, L, coords, hpos, halos, offsets, parts, sl, pc, r);
  else
    snapshot_radii_kernel<2><<<blocks, 256, 0, s>>>(
        n_pieces, piece, L, coords, hpos, halos, offsets, parts, sl, pc, r);
  return int(cudaGetLastError());
}

int bf_snapshot_record_bytes(int f64) {
  return f64 ? int(sizeof(Record<double>)) : int(sizeof(Record<float>));
}

}  // extern "C"
