// K1: per-halo curve collapse.
//
// Replaces baryonforge_tpu/ops/interp.py: collapse_curves (reached through
// Profiles/BaryonCorrection.py: halo_curves). The table is laid out as the
// JAX function lays it out: (n_z, n_M, n_r, n_p1, ..., n_pP), radial axis
// at index 2. Each halo's (ln 1/a, ln M, p1, ..., pP) is located on the
// table's non-radial axes (searchsorted side="right", minus one, clamped to
// [0, n-2]; the p values are raw per-halo values, not logs); the 2^(2+P)
// corner rows are blended into one radial curve, corner bit d for axis d in
// the order z, M, p1, ..., with the weight built as w = w * (bit ? t : 1-t)
// in that order, and the corners summed in their order; halos with any
// coordinate outside its axis get `fill`.
//
// The axes come by pointer and size (CurveAxes, built once a table by the
// wrapper); each axis' value comes per halo or as one scalar for all
// (CurveHalos, a call's), so a caller's single a is never expanded. Both
// hold kAxesCap axes: z, M and up to 27 parameter axes, as many as a table
// of fewer than 2^31 values can have with 2 points on every axis (the
// wrapper, ops/interp.py, raises where the output or the table holds 2^31
// values or more: int32 index math).
//
// Bound: device-memory bytes: each output value written once; the table
// sits in L2 (the bench table is 8x20x64, 40 KB in float32). Design: a warp
// a halo. Up to 4 parameter axes (collapse_curves_kernel) the number of
// axes is a template argument. Lane d locates axis d (a bisection; the
// lanes search together) and the warp shares the brackets and fractions by
// shuffle, so a halo's searches and logs are done once, not once a radius;
// lane c forms corner c's weight and row offset into the warp's shared
// memory; then the lanes sweep the radii 32 at a time, each loading up to 8
// corner rows at its radius before summing them in corner order, so a
// corner row is read as a coalesced run (without parameter axes, whose
// radial stride is 1) and the output written so. Past 4 parameter axes
// (collapse_curves_wide, one kernel for every P >= 5) the wrapper hands
// over its copy of the table with the radial axis last, (z, M, p1, ...,
// pP, r), set up once a table, so that a corner row is a contiguous run
// there too (with r at index 2 its radial stride is the whole parameter
// block, and every lane's load a sector of its own); lane d keeps axis d's
// bracket, stride and fractions in shared memory, and the corners go in
// groups of kGroup: the lanes form a group's weights and offsets (each
// weight from all the axes in order, as above), then sweep the radii, each
// lane carrying its radii's sums in the output row from one group to the
// next, so the corners are still added in corner order and shared memory
// holds one group whatever P is. Host columns come as the caller's doubles
// and are rounded to T here, as the host's cast would round them.

#include "healpix.cuh"

namespace {

// axes a CurveAxes / CurveHalos holds: z, M and 27 parameter axes (a table
// with 2 points on each of 30 axes holds 2^30 values; one more axis passes
// 2^31)
constexpr int kAxesCap = 29;
constexpr int kMaxAxes = 6;  // collapse_curves_kernel's: z, M, 4 p axes
constexpr int kWarps = 8;    // halos a block, one a warp
constexpr int kGroup = 64;   // collapse_curves_wide's corners a group

// a table's axes, as the host fills them (grids: device pointers)
struct CurveAxes {
  const void* grid[kAxesCap];  // z, M, p1, ... grids
  int size[kAxesCap];
  int n;                       // 2 + P
  int nr;                      // radii
};

// a call's halos, as the host fills them: axis d's values (a for z, M,
// p1, ...) at col[d] (device), halo h's at col[d][h * step[d]] (step 0: one
// value for all), in double where f64[d] (host columns staged as they
// came) else in the table's type; or val[d] for every halo where col[d] is
// null
struct CurveHalos {
  const void* col[kAxesCap];
  int step[kAxesCap];
  int f64[kAxesCap];
  double val[kAxesCap];
};

// the kernels' copies, K axes
template <typename T, int K>
struct Axes {
  const T* grid[K];
  int size[K];
  int stride[K];  // row-major strides of (z, M, r, p1, ..., pP)
  int nr, stride_r;
};

template <typename T, int K>
struct Halos {
  const void* col[K];
  int step[K];
  bool f64[K];
  T val[K];
};

// number of axis values <= x (searchsorted side="right"), by bisection
template <typename T>
__device__ __forceinline__ int count_le(const T* ax, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ax[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// axis d's value of halo h, in T (a double column rounded once, as the
// host's cast of the same value); d a lane's own, picked by selects
template <typename T, int K>
__device__ __forceinline__ T halo_value(const Halos<T, K>& hs, int d, int h) {
  const void* col = hs.col[0];
  int step = hs.step[0];
  bool f64 = hs.f64[0];
  T val = hs.val[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == d) col = hs.col[k], step = hs.step[k], f64 = hs.f64[k],
                val = hs.val[k];
  if (!col) return val;
  return f64 ? T(static_cast<const double*>(col)[h * step])
             : static_cast<const T*>(col)[h * step];
}

// NA axes besides r (2 + P): 2^NA corners
template <typename T, int NA>
__global__ void __launch_bounds__(32 * kWarps)
collapse_curves_kernel(const T* __restrict__ table, Axes<T, kMaxAxes> ax,
                       Halos<T, kMaxAxes> hs, int n_h, T fill,
                       T* __restrict__ out) {
  constexpr int kCorners = 1 << NA;
  constexpr int kChunk = kCorners < 8 ? kCorners : 8;  // loads in flight
  __shared__ T w_s[kWarps][kCorners];
  __shared__ int off_s[kWarps][kCorners];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * kWarps + warp;
  if (h >= n_h) return;                   // the whole warp
  // lane d < NA: axis d's bracket, fraction and range test, the lanes
  // together (each its own axis' value, grid and size picked first)
  int idx = 0;
  T frac = T(0);
  bool oob = false;
  if (lane < NA) {
    const T* g = ax.grid[0];
    int n = ax.size[0];
#pragma unroll
    for (int d = 1; d < NA; ++d)
      if (d == lane) g = ax.grid[d], n = ax.size[d];
    const T v = halo_value(hs, lane, h);
    const T x = lane >= 2 ? v : bf::m_log(lane == 0 ? T(1) / v : v);
    idx = bf::clampi(count_le(g, n, x) - 1, 0, n - 2);
    frac = (x - g[idx]) / (g[idx + 1] - g[idx]);
    oob = x < g[0] || x > g[n - 1];
  }
  T* row = out + h * ax.nr;
  if (__any_sync(bf::kFullMask, oob)) {
    for (int r = lane; r < ax.nr; r += 32) row[r] = fill;
    return;
  }
  // lane c: corner c's (c + 32's) weight and row offset, for the warp
  int i_d[NA];
  T t_d[NA];
#pragma unroll
  for (int d = 0; d < NA; ++d) {
    i_d[d] = __shfl_sync(bf::kFullMask, idx, d);
    t_d[d] = __shfl_sync(bf::kFullMask, frac, d);
  }
  for (int c = lane; c < kCorners; c += 32) {
    T w = T(1);
    int off = 0;
#pragma unroll
    for (int d = 0; d < NA; ++d) {
      const int bit = (c >> d) & 1;
      off += (i_d[d] + bit) * ax.stride[d];
      w = w * (bit ? t_d[d] : T(1) - t_d[d]);
    }
    w_s[warp][c] = w;
    off_s[warp][c] = off;
  }
  __syncwarp();
  // the radii, 32 at a time: kChunk corner rows loaded, then summed in
  // corner order
  for (int r = lane; r < ax.nr; r += 32) {
    const T* at = table + r * ax.stride_r;
    T c = T(0);
#pragma unroll
    for (int c0 = 0; c0 < kCorners; c0 += kChunk) {
      T v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) v[j] = at[off_s[warp][c0 + j]];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) c = c + w_s[warp][c0 + j] * v[j];
    }
    row[r] = c;
  }
}

// P >= 5 parameter axes, na = 2 + P axes besides r (7 <= na <= kAxesCap),
// the table laid out (z, M, p1, ..., pP, r): the corners in groups of
// kGroup (2^na is a multiple of it), each group's sums carried in the
// output row
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
collapse_curves_wide(const T* __restrict__ table, Axes<T, kAxesCap> ax,
                     Halos<T, kAxesCap> hs, int na, int n_h, T fill,
                     T* __restrict__ out) {
  __shared__ T w_s[kWarps][kGroup];
  __shared__ int off_s[kWarps][kGroup];
  // axis d's bracket offset i_d stride_d, stride_d, t_d and 1 - t_d
  __shared__ int base_s[kWarps][32], step_s[kWarps][32];
  __shared__ T t_s[kWarps][32], u_s[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * kWarps + warp;
  if (h >= n_h) return;                   // the whole warp
  bool oob = false;
  if (lane < na) {
    const T* g = ax.grid[0];
    int n = ax.size[0], stride = ax.stride[0];
#pragma unroll
    for (int d = 1; d < kAxesCap; ++d)
      if (d == lane) g = ax.grid[d], n = ax.size[d], stride = ax.stride[d];
    const T v = halo_value(hs, lane, h);
    const T x = lane >= 2 ? v : bf::m_log(lane == 0 ? T(1) / v : v);
    const int idx = bf::clampi(count_le(g, n, x) - 1, 0, n - 2);
    const T frac = (x - g[idx]) / (g[idx + 1] - g[idx]);
    oob = x < g[0] || x > g[n - 1];
    base_s[warp][lane] = idx * stride;
    step_s[warp][lane] = stride;
    t_s[warp][lane] = frac;
    u_s[warp][lane] = T(1) - frac;
  }
  T* row = out + h * ax.nr;
  if (__any_sync(bf::kFullMask, oob)) {
    for (int r = lane; r < ax.nr; r += 32) row[r] = fill;
    return;
  }
  __syncwarp();
  const int corners = 1 << na;
  for (int c0 = 0; c0 < corners; c0 += kGroup) {
    // lane j: corners c0 + j and c0 + j + 32, weights built axis by axis
    for (int j = lane; j < kGroup; j += 32) {
      const int c = c0 + j;
      T w = T(1);
      int off = 0;
      for (int d = 0; d < na; ++d) {
        const bool bit = (c >> d) & 1;
        off += base_s[warp][d] + (bit ? step_s[warp][d] : 0);
        w = w * (bit ? t_s[warp][d] : u_s[warp][d]);
      }
      w_s[warp][j] = w;
      off_s[warp][j] = off;
    }
    __syncwarp();
    // each lane's radii: the sum so far (0 before the first group), plus
    // this group's corners in order, 8 rows loaded at a time
    for (int r = lane; r < ax.nr; r += 32) {
      const T* at = table + r * ax.stride_r;
      T acc = c0 == 0 ? T(0) : row[r];
#pragma unroll
      for (int j0 = 0; j0 < kGroup; j0 += 8) {
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = at[off_s[warp][j0 + j]];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = acc + w_s[warp][j0 + j] * v[j];
      }
      row[r] = acc;
    }
    __syncwarp();  // the group's weights are read before the next's land
  }
}

template <typename T, int NA>
void launch_na(int blocks, cudaStream_t s, const T* table,
               const Axes<T, kMaxAxes>& ax, const Halos<T, kMaxAxes>& hs,
               int n_h, T fill, T* out) {
  collapse_curves_kernel<T, NA><<<blocks, 32 * kWarps, 0, s>>>(
      table, ax, hs, n_h, fill, out);
}

// the kernels' copies of a table's axes and a call's halos (the first K
// of na axes; strides row-major over (z, M, r, p1, ..., pP), or over (z, M,
// p1, ..., pP, r) where radial_last)
template <typename T, int K>
void fill_axes(const CurveAxes* axes, const CurveHalos* halos, int na,
               bool radial_last, Axes<T, K>& ax, Halos<T, K>& hs) {
  ax.nr = axes->nr;
  for (int d = 0; d < K; ++d) {
    const bool on = d < na;
    ax.grid[d] = on ? static_cast<const T*>(axes->grid[d]) : nullptr;
    ax.size[d] = on ? axes->size[d] : 0;
    hs.col[d] = on ? halos->col[d] : nullptr;
    hs.step[d] = on ? halos->step[d] : 0;
    hs.f64[d] = on && halos->f64[d] != 0;
    hs.val[d] = on ? T(halos->val[d]) : T(0);
  }
  int s = radial_last ? ax.nr : 1;
  for (int d = na - 1; d >= 2; --d) {
    ax.stride[d] = s;
    s *= ax.size[d];
  }
  if (radial_last) {
    ax.stride_r = 1;
  } else {
    ax.stride_r = s;
    s *= ax.nr;
  }
  ax.stride[1] = s;
  ax.stride[0] = s * ax.size[1];
  for (int d = na; d < K; ++d) ax.stride[d] = 0;
}

template <typename T>
int launch(const T* table, const CurveAxes* axes, const CurveHalos* halos,
           int n_h, T fill, T* out, void* stream) {
  const int na = axes->n;
  if (na < 2 || na > kAxesCap) return int(cudaErrorInvalidValue);
  if (n_h == 0) return 0;
  const int blocks = (n_h + kWarps - 1) / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (na > kMaxAxes) {
    Axes<T, kAxesCap> ax;
    Halos<T, kAxesCap> hs;
    fill_axes(axes, halos, na, true, ax, hs);
    collapse_curves_wide<T><<<blocks, 32 * kWarps, 0, st>>>(
        table, ax, hs, na, n_h, fill, out);
    return int(cudaGetLastError());
  }
  Axes<T, kMaxAxes> ax;
  Halos<T, kMaxAxes> hs;
  fill_axes(axes, halos, na, false, ax, hs);
  switch (na) {
    case 2: launch_na<T, 2>(blocks, st, table, ax, hs, n_h, fill, out); break;
    case 3: launch_na<T, 3>(blocks, st, table, ax, hs, n_h, fill, out); break;
    case 4: launch_na<T, 4>(blocks, st, table, ax, hs, n_h, fill, out); break;
    case 5: launch_na<T, 5>(blocks, st, table, ax, hs, n_h, fill, out); break;
    default: launch_na<T, 6>(blocks, st, table, ax, hs, n_h, fill, out);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: (z, M, r, p1, ..., pP), or (z, M, p1, ..., pP, r) for P > 4;
// axes: a CurveAxes on the host, built once a table; halos: a CurveHalos on
// the host, a call's (void pointers here: a type of this file's unnamed
// namespace in the signature would keep the symbol from being exported);
// out: (n_h, nr)
int bf_collapse_curves_f32(const float* table, const void* axes,
                           const void* halos, int n_h, float fill,
                           float* out, void* stream) {
  return launch<float>(table, static_cast<const CurveAxes*>(axes),
                       static_cast<const CurveHalos*>(halos), n_h, fill, out,
                       stream);
}

int bf_collapse_curves_f64(const double* table, const void* axes,
                           const void* halos, int n_h, double fill,
                           double* out, void* stream) {
  return launch<double>(table, static_cast<const CurveAxes*>(axes),
                        static_cast<const CurveHalos*>(halos), n_h, fill, out,
                        stream);
}

// the axes a CurveAxes and a CurveHalos hold (ops.interp sizes its ctypes
// copies by MAX_P_AXES + 2, which must equal it)
int bf_collapse_curves_axes(void) { return kAxesCap; }

}  // extern "C"
