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
// (CurveHalos, a call's), so a caller's single a is never expanded. The
// number of axes is bounded by kMaxAxes: z, M and up to 4 parameter axes.
// The wrapper (ops/interp.py) raises above that, and where the output or
// the table holds 2^31 values or more (int32 index math).
//
// Bound: device-memory bytes: each output value written once; the table
// sits in L2 (the bench table is 8x20x64, 40 KB in float32). Design: a warp
// a halo, the number of axes a template argument. Lane d locates axis d (a
// bisection; the lanes search together) and the warp shares the brackets
// and fractions by shuffle, so a halo's searches and logs are done once,
// not once a radius; lane c forms corner c's weight and row offset into
// the warp's shared memory; then the
// lanes sweep the radii 32 at a time, each loading up to 8 corner rows at
// its radius before summing them in corner order, so a corner row is read
// as a coalesced run (without parameter axes, whose radial stride is 1)
// and the output written so. Host columns come as the caller's doubles
// and are rounded to T here, as the host's cast would round them.

#include "healpix.cuh"

namespace {

constexpr int kMaxAxes = 6;
constexpr int kWarps = 8;  // halos a block, one a warp

// a table's axes, as the host fills them (grids: device pointers)
struct CurveAxes {
  const void* grid[kMaxAxes];  // z, M, p1, ... grids
  int size[kMaxAxes];
  int n;                       // 2 + P
  int nr;                      // radii
};

// a call's halos, as the host fills them: axis d's values (a for z, M,
// p1, ...) at col[d] (device), halo h's at col[d][h * step[d]] (step 0: one
// value for all), in double where f64[d] (host columns staged as they
// came) else in the table's type; or val[d] for every halo where col[d] is
// null
struct CurveHalos {
  const void* col[kMaxAxes];
  int step[kMaxAxes];
  int f64[kMaxAxes];
  double val[kMaxAxes];
};

template <typename T>
struct Axes {
  const T* grid[kMaxAxes];
  int size[kMaxAxes];
  int stride[kMaxAxes];  // row-major strides of (z, M, r, p1, ..., pP)
  int nr, stride_r;
};

template <typename T>
struct Halos {
  const void* col[kMaxAxes];
  int step[kMaxAxes];
  bool f64[kMaxAxes];
  T val[kMaxAxes];
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
template <typename T>
__device__ __forceinline__ T halo_value(const Halos<T>& hs, int d, int h) {
  const void* col = hs.col[0];
  int step = hs.step[0];
  bool f64 = hs.f64[0];
  T val = hs.val[0];
#pragma unroll
  for (int k = 1; k < kMaxAxes; ++k)
    if (k == d) col = hs.col[k], step = hs.step[k], f64 = hs.f64[k],
                val = hs.val[k];
  if (!col) return val;
  return f64 ? T(static_cast<const double*>(col)[h * step])
             : static_cast<const T*>(col)[h * step];
}

// NA axes besides r (2 + P): 2^NA corners
template <typename T, int NA>
__global__ void __launch_bounds__(32 * kWarps)
collapse_curves_kernel(const T* __restrict__ table, Axes<T> ax, Halos<T> hs,
                       int n_h, T fill, T* __restrict__ out) {
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

template <typename T, int NA>
void launch_na(int blocks, cudaStream_t s, const T* table, const Axes<T>& ax,
               const Halos<T>& hs, int n_h, T fill, T* out) {
  collapse_curves_kernel<T, NA><<<blocks, 32 * kWarps, 0, s>>>(
      table, ax, hs, n_h, fill, out);
}

template <typename T>
int launch(const T* table, const CurveAxes* axes, const CurveHalos* halos,
           int n_h, T fill, T* out, void* stream) {
  const int na = axes->n;
  if (na < 2 || na > kMaxAxes) return int(cudaErrorInvalidValue);
  if (n_h == 0) return 0;
  Axes<T> ax;
  Halos<T> hs;
  ax.nr = axes->nr;
  for (int d = 0; d < kMaxAxes; ++d) {
    const bool on = d < na;
    ax.grid[d] = on ? static_cast<const T*>(axes->grid[d]) : nullptr;
    ax.size[d] = on ? axes->size[d] : 0;
    hs.col[d] = on ? halos->col[d] : nullptr;
    hs.step[d] = on ? halos->step[d] : 0;
    hs.f64[d] = on && halos->f64[d] != 0;
    hs.val[d] = on ? T(halos->val[d]) : T(0);
  }
  int s = 1;
  for (int d = na - 1; d >= 2; --d) {
    ax.stride[d] = s;
    s *= ax.size[d];
  }
  ax.stride_r = s;
  s *= ax.nr;
  ax.stride[1] = s;
  ax.stride[0] = s * ax.size[1];
  for (int d = na; d < kMaxAxes; ++d) ax.stride[d] = 0;
  const int blocks = (n_h + kWarps - 1) / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
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

}  // extern "C"
