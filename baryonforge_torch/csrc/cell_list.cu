// K24: the snapshot's periodic cell list on the card (BaryonifySnapshot).
//
// The neighbour search of the snapshot runner: every (halo, particle) pair
// whose minimum-image distance is at most the halo's query radius. Its
// counterpart on the host is the port's native/cell_list.cpp (the JAX
// package's is baryonforge_tpu/native/kernels.cpp:87-164, host C++, no TPU
// kernel); this one finds the same sets where the pairs are used, so that
// a snapshot of more pairs than a host array and an upload can carry runs
// (ops/snapshot.py: cell_build, cell_count, cell_write).
//
// The arithmetic is the host list's, so that the sets are its sets:
//   * positions wrapped as np.mod(x, L): fmod (exact), a negative remainder
//     plus L, a zero one +0; so a device wrap is bitwise the host's;
//   * a particle's cell on an axis (long long)(x / cell) % ncell, the
//     negative fix; cell = L / ncell, ncell from the median query radius,
//     at most 256 an axis and about 8 a particle (ops.snapshot.cell_grid);
//   * a halo walks, on each axis, the cells within reach = (long long)(r /
//     cell) + 1 of its centre's cell (long long)(fmod(c, L) / cell), every
//     cell of the axis once when the window wraps onto itself (2 reach + 1
//     >= ncell), as axis_cells / query_range do;
//   * the distance as pdist2: per axis one wrap (> L/2 minus L, then < -L/2
//     plus L), the squares summed x, y, z in float64 from 0, the pair kept
//     where d^2 <= r^2. Compiled with --fmad=false, as the host sums.
//
// Design.
//   build: a thread a particle forms its cell and takes its place in it by
//     an atomic (bf_cell_bin); the counts are scanned into int64 starts (a
//     torch cumsum on the card); a thread a particle writes its wrapped
//     position (float64) and index (int32) at its place (bf_cell_place).
//     The order inside a cell is the atomics', so it differs between
//     builds: the kernels that read the pairs sum each particle's rows in
//     halo order, so only the sets matter.
//   query: a warp an item, an item a column of a halo's window (3D: one
//     (x, y) cell pair and its z cells, one or two runs of consecutive
//     cells; 2D: one x cell and its y cells). A column holds 3 to 2 reach
//     + 1 cells, so the largest halos are many items of about the small
//     ones' size: the load is balanced by the item, not by the halo. The
//     lanes test 32 consecutive particles of a run at a time (coalesced
//     24-byte positions) and count the hits by ballot. The count pass
//     (bf_cell_count) writes each item's hits; their int64 scan gives each
//     item's first pair and each halo's offsets; the write pass
//     (bf_cell_write), over the items of one chunk of halos, walks again
//     and writes each hit's particle at its item's offset plus its rank in
//     the ballot. An item finds its halo by a binary search of the halos'
//     first items.
// Bound: bytes. Each pass reads every tested particle's position once (24
// bytes in 3D) and the write pass writes 4 bytes a pair; the cell starts,
// centres and windows are small and stay in L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// np.mod(x, L) for L > 0, bit for bit (numpy's npy_divmod remainder)
__device__ __forceinline__ double wrap_mod(double x, double L) {
  double m = fmod(x, L);
  if (m != 0.0) {
    if (m < 0.0) m += L;
  } else {
    m = 0.0;
  }
  return m;
}

__device__ __forceinline__ long long axis_cell(double x, double cell,
                                               long long ncell) {
  const long long c = (long long)(x / cell) % ncell;
  return c < 0 ? c + ncell : c;
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
cell_bin_kernel(long long n, double L, double cell, int ncell,
                const double* __restrict__ pos, int* __restrict__ cid,
                int* __restrict__ rank, int* __restrict__ count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long c = 0;
  for (int d = 0; d < NDIM; ++d)
    c = c * ncell + axis_cell(wrap_mod(pos[i * NDIM + d], L), cell, ncell);
  cid[i] = int(c);
  rank[i] = atomicAdd(&count[c], 1);
}

template <int NDIM>
__global__ void __launch_bounds__(kThreads)
cell_place_kernel(long long n, double L, const double* __restrict__ pos,
                  const int* __restrict__ cid, const int* __restrict__ rank,
                  const long long* __restrict__ start,
                  double* __restrict__ cpos, int* __restrict__ orig) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = start[cid[i]] + rank[i];
  for (int d = 0; d < NDIM; ++d)
    cpos[k * NDIM + d] = wrap_mod(pos[i * NDIM + d], L);
  orig[k] = int(i);
}

// the window of one axis: its first cell and its length (every cell, from
// 0, when it wraps onto itself)
__device__ __forceinline__ void axis_window(int c, int reach, int ncell,
                                            int* first, int* len) {
  if (2 * reach + 1 >= ncell) {
    *first = 0;
    *len = ncell;
  } else {
    *first = ((c - reach) % ncell + ncell) % ncell;
    *len = 2 * reach + 1;
  }
}

// one pass over the items [t0, t1) of the halos [h0, h1): the count pass
// writes each item's hits to out[t - t0]; the write pass writes each hit's
// particle to out[item_off[t] - base + its rank]
template <int NDIM, bool WRITE>
__global__ void __launch_bounds__(kThreads)
cell_query_kernel(long long t0, long long t1, int h0, int h1, double L,
                  int ncell, const long long* __restrict__ start,
                  const double* __restrict__ cpos,
                  const int* __restrict__ orig,
                  const double* __restrict__ centers,
                  const double* __restrict__ radii,
                  const int4* __restrict__ win,
                  const long long* __restrict__ item_start,
                  const long long* __restrict__ item_off, long long base,
                  int* __restrict__ out) {
  const long long t =
      t0 + (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (t >= t1) return;  // the whole warp
  // the item's halo: the last h of [h0, h1) with item_start[h] <= t
  int lo = h0, hi = h1 - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (item_start[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int h = lo;
  const int4 w = win[h];
  const int cw[3] = {w.x, w.y, w.z};
  int first[NDIM], len[NDIM];
  for (int d = 0; d < NDIM; ++d)
    axis_window(cw[d], w.w, ncell, &first[d], &len[d]);
  const long long local = t - item_start[h];
  long long col;  // the column's first cell
  if (NDIM == 3) {
    const int a = int(local / len[1]), b = int(local % len[1]);
    col = ((long long)((first[0] + a) % ncell) * ncell
           + (first[1] + b) % ncell) * ncell;
  } else {
    col = (long long)((first[0] + int(local)) % ncell) * ncell;
  }
  double c[NDIM];
  for (int d = 0; d < NDIM; ++d) c[d] = centers[(long long)h * NDIM + d];
  const double r = radii[h];
  const double r2 = r * r;
  const double half = L / 2;
  const int zf = first[NDIM - 1], zl = len[NDIM - 1];
  const long long o = WRITE ? item_off[t] - base : 0;
  int hits = 0;
  for (int run = 0; run < 2; ++run) {
    int za, zb;
    if (run == 0) {
      za = zf;
      zb = min(zf + zl, ncell);
    } else {
      za = 0;
      zb = zf + zl - ncell;
      if (zb <= 0) break;
    }
    const long long k0 = start[col + za], k1 = start[col + zb];
    for (long long kb = k0; kb < k1; kb += 32) {
      const long long k = kb + lane;
      bool in = false;
      if (k < k1) {
        double d2 = 0.0;
        for (int d = 0; d < NDIM; ++d) {
          double v = cpos[k * NDIM + d] - c[d];
          if (v > half) v -= L;
          if (v < -half) v += L;
          d2 = d2 + v * v;
        }
        in = d2 <= r2;
      }
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (WRITE && in)
        out[o + hits + __popc(m & ((1u << lane) - 1u))] = orig[k];
      hits += __popc(m);
    }
  }
  if (!WRITE && lane == 0) out[t - t0] = hits;
}

unsigned blocks_of(long long threads) {
  return unsigned((threads + kThreads - 1) / kThreads);
}

template <bool WRITE>
int query(int ndim, long long t0, long long t1, int h0, int h1, double L,
          int ncell, const long long* start, const double* cpos,
          const int* orig, const double* centers, const double* radii,
          const int* win, const long long* item_start,
          const long long* item_off, long long base, int* out,
          void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (t1 <= t0 || h1 <= h0) return 0;
  const unsigned blocks = blocks_of((t1 - t0) * 32);
  const int4* w = reinterpret_cast<const int4*>(win);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    cell_query_kernel<3, WRITE><<<blocks, kThreads, 0, s>>>(
        t0, t1, h0, h1, L, ncell, start, cpos, orig, centers, radii, w,
        item_start, item_off, base, out);
  else
    cell_query_kernel<2, WRITE><<<blocks, kThreads, 0, s>>>(
        t0, t1, h0, h1, L, ncell, start, cpos, orig, centers, radii, w,
        item_start, item_off, base, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// build, first launch: pos (n, ndim) float64 (any values: wrapped here);
// cid (n,) each particle's cell, rank (n,) its place in it, count
// (ncell^ndim,) int32 zeroed by the caller, the particles a cell
int bf_cell_bin(int ndim, long long n, double L, double cell, int ncell,
                const double* pos, int* cid, int* rank, int* count,
                void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    cell_bin_kernel<3><<<blocks_of(n), kThreads, 0, s>>>(
        n, L, cell, ncell, pos, cid, rank, count);
  else
    cell_bin_kernel<2><<<blocks_of(n), kThreads, 0, s>>>(
        n, L, cell, ncell, pos, cid, rank, count);
  return int(cudaGetLastError());
}

// build, second launch: start (ncell^ndim + 1,) int64 the cells' first
// places; cpos (n, ndim) the wrapped positions and orig (n,) int32 the
// particles' indices, cell by cell
int bf_cell_place(int ndim, long long n, double L, const double* pos,
                  const int* cid, const int* rank, const long long* start,
                  double* cpos, int* orig, void* stream) {
  if (ndim != 2 && ndim != 3) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3)
    cell_place_kernel<3><<<blocks_of(n), kThreads, 0, s>>>(
        n, L, pos, cid, rank, start, cpos, orig);
  else
    cell_place_kernel<2><<<blocks_of(n), kThreads, 0, s>>>(
        n, L, pos, cid, rank, start, cpos, orig);
  return int(cudaGetLastError());
}

// the count pass over the items [t0, t1) of the halos [h0, h1): centers
// (n_h, ndim) float64 wrapped, radii (n_h,) float64, win (n_h, 4) int32
// (the centre's cell on each axis, reach clamped to ncell), item_start
// (n_h + 1,) int64; count (t1 - t0,) int32 each item's hits
int bf_cell_count(int ndim, long long t0, long long t1, int h0, int h1,
                  double L, int ncell, const long long* start,
                  const double* cpos, const double* centers,
                  const double* radii, const int* win,
                  const long long* item_start, int* count, void* stream) {
  return query<false>(ndim, t0, t1, h0, h1, L, ncell, start, cpos, nullptr,
                      centers, radii, win, item_start, nullptr, 0, count,
                      stream);
}

// the write pass: item_off (T + 1,) int64 each item's first pair over all
// halos, base the first pair of halo h0; parts the pairs of halos [h0,
// h1), each halo's in its row
int bf_cell_write(int ndim, long long t0, long long t1, int h0, int h1,
                  double L, int ncell, const long long* start,
                  const double* cpos, const int* orig, const double* centers,
                  const double* radii, const int* win,
                  const long long* item_start, const long long* item_off,
                  long long base, int* parts, void* stream) {
  return query<true>(ndim, t0, t1, h0, h1, L, ncell, start, cpos, orig,
                     centers, radii, win, item_start, item_off, base, parts,
                     stream);
}

}  // extern "C"
