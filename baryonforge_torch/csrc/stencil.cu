// K5: stencil regrid (tiled phase B) and its hot-tile test.
//
// Replaces baryonforge_tpu/ops/tiles.py: make_stencil_regrid (one_tile and
// row_geometry) and the hot-tile test of Runners/HealpixRunner.py:
// _get_stencil_combo (combo). The regrid is computed from the target side:
// every target slot sums, over a (2W+1) x (2Wc+1) window of source cells
// around it, the theta-hat weight times the phi-hat weight (in column
// units) times the source value. A source tile is excluded (its sources
// go through the scatter complement, K6) when its largest |offset|
// exceeds its block's thresholds or it lies in the geometric set D_geom.
//
// stencil_hot: one warp per tile (kHotTiles tiles a block) reads the
// tile's offsets in 16-byte vectors, reduces max |d theta| and max
// |tangent phi| by shuffles and compares them, in float64, with the
// thresholds.
//
// stencil: one block per target tile (kThreads threads). The slab of
// (RB + 2W) x (K + 2Wc) source cells that the tile's window needs is read
// from its 3 x 3 neighbour tiles: rows come from the tile above (its last
// W rows), its own row of tiles, the tile below (first W rows); on each
// row, slab column q is in-ring index j0 + q - Wc, read from the left
// neighbour's segment, the tile's own or the right neighbour's by direct
// index (the JAX version places the segments with a one-hot contraction,
// because the TPU has no per-lane gather). Sources of excluded or missing
// tiles carry value 0. The ring data of the slab's rows (theta, dphi,
// colscale, nr, shifted) come from a per-NSIDE table
// (ops.stencil.stencil_tables); only the tile's own segment starts
// (sector_j0, integer math) are worked out here.
// Every weight that does not depend on the target column is formed once a
// tile, in shared memory: for target row u and tap row du the float64
// column relations r0 = (phi0[row] - phi0[u]) / dphi[u] and rat =
// dphi[row] / dphi[u] (rounded to T); for each slab cell (row, q) its
// theta_src and c_src; and for each tap row that can carry weight and each
// column q the theta-hat weight wth(u, du, q) (one division) and y(u, du,
// q) = r0 + c_src * rat. A tap of target column vt is then x = y - vt, wph
// = max(0, 1 - |x|), acc = acc + (wth wph) v: the JAX order of operations
// (rows outer, columns inner), so with --fmad=false each slot's sum is
// bitwise the plain version's. A tap thread takes kV consecutive slots of
// one row and slides over the 2Wc + kV cells of each tap row, loading each
// cell's wth, y and v once for up to kV slots. Tap rows whose wth are all
// 0 (the range of the row's theta_src shows it) get no table and no taps
// (a term 0 * wph * v adds nothing to a finite sum): a source that did not
// move gives wth exactly 0 one row away, so at rest one tap row in five
// runs. The staging pass (kCellsAhead cells a thread, their loads first)
// keeps each slab row's least and largest theta_src; the tap rows those
// do not rule out are listed, and the table pass runs over them only.
//
// Bound: bytes (offsets and the tiled map read, the output written; ~60
// operations a pixel for the regrid itself). The work here is ~6 float32
// instructions a tap, 55 taps a slot (fewer where tap rows are skipped),
// and up to ~3,400 divisions a tile for the weight tables, of which only
// those of sources that moved towards another row are made (a zero
// numerator skips its division too). The block holds more threads than it
// has tap threads, for the latency of its loads and divisions. Table
// strides are odd, so that a warp's four (kV = 4) or eight target rows
// fall in distinct banks.
//
// Precision: ring thetas are float64 rounded to the regrid dtype T; the
// per-row column origin phi0 and step dphi stay float64, and r0, rat are
// formed in float64 then rounded (tiles.py:1521-1569), so that the
// zero-offset neighbour separation is an exact integer.

#include "tiles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHotTiles = 8;  // tiles a block of the hot test, a warp each
constexpr int kV = 4;         // consecutive slots a thread of the stencil
constexpr int kThreads = 256; // threads a block of the stencil
constexpr int kCellsAhead = 4; // slab cells a thread loads before using

template <typename P>
__device__ __forceinline__ void max_into(P& m, P x) {
  x = bf::m_fabs(x);
  m = x > m ? x : m;
}

// a 16-byte vector of offsets: d theta and d phi alternate
__device__ __forceinline__ void max_vec(const float* a, int i, float& m0,
                                        float& m1) {
  const float4 x = reinterpret_cast<const float4*>(a)[i];
  max_into(m0, x.x);
  max_into(m1, x.y);
  max_into(m0, x.z);
  max_into(m1, x.w);
}

__device__ __forceinline__ void max_vec(const double* a, int i, double& m0,
                                        double& m1) {
  const double2 x = reinterpret_cast<const double2*>(a)[i];
  max_into(m0, x.x);
  max_into(m1, x.y);
}

template <typename P>
__global__ void __launch_bounds__(32 * kHotTiles)
stencil_hot_kernel(int n_tiles, int P_slots, int vec,
                   const P* __restrict__ acc,
                   const double* __restrict__ th_theta,
                   const double* __restrict__ th_phi,
                   const bool* __restrict__ d_geom, bool* __restrict__ excl) {
  const int t = blockIdx.x * kHotTiles + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;
  const P* a = acc + (long long)t * P_slots * 2;
  P m0 = P(0), m1 = P(0);
  if (vec) {
    const int nv = 2 * P_slots * int(sizeof(P)) / 16;
    for (int i = lane; i < nv; i += 32) max_vec(a, i, m0, m1);
  } else {
    for (int k = lane; k < P_slots; k += 32) {
      max_into(m0, a[2 * k]);
      max_into(m1, a[2 * k + 1]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const P y0 = __shfl_xor_sync(kFull, m0, o);
    const P y1 = __shfl_xor_sync(kFull, m1, o);
    m0 = y0 > m0 ? y0 : m0;
    m1 = y1 > m1 ? y1 : m1;
  }
  if (lane == 0)
    excl[t] = double(m0) > th_theta[t] || double(m1) > th_phi[t] || d_geom[t];
}

struct TileArgs {
  int N, RB, K, W, Wc;
  const int* i0;
  const int* s;
  const int* S;
  const int* nbr;  // (n_tiles, 9): rows above / same / below, cols L C R
  // per ring i = 1 .. 4N - 1, at i - 1
  const double* ring_theta;
  const double* ring_dphi;
  const int* ring_nr;
  const int* ring_sh;
};

// the block's shared-memory layout
struct Layout {
  int R, Q, D, TPR, Qp, Qv, Su;
  __host__ __device__ Layout(int RB, int K, int W, int Wc) {
    R = RB + 2 * W;
    Q = K + 2 * Wc;
    D = 2 * W + 1;
    TPR = (K + kV - 1) / kV;     // threads a target row
    Qp = TPR * kV + 2 * Wc;      // columns a (u, du) weight row, >= Q
    Qv = Qp | 1;                 // odd strides: see the note above
    Su = (D * Qp) | 1;
  }
  template <typename T>
  __host__ __device__ size_t bytes(int RB) const {
    return size_t(R) * 2 * sizeof(double) +
           (size_t(R) * (4 + 2 * Q + Qv) + size_t(RB) * (2 + 2 * D) +
            size_t(RB) * 2 * Su) * sizeof(T) +
           (size_t(R) * 3 + size_t(RB) * D * 2 + 19) * sizeof(int);
  }
};

// integer keys that order as their floats do (NaN aside), for shared
// atomicMin / atomicMax
template <typename T>
struct KeyOf;
template <>
struct KeyOf<float> {
  using type = int;
};
template <>
struct KeyOf<double> {
  using type = long long;
};

__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ long long order_key(double x) {
  const long long i = __double_as_longlong(x);
  return i >= 0 ? i : i ^ 0x7fffffffffffffffLL;
}

template <typename T>
__device__ __forceinline__ T from_key(typename KeyOf<T>::type k);

template <>
__device__ __forceinline__ float from_key<float>(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <>
__device__ __forceinline__ double from_key<double>(long long k) {
  return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffLL);
}

// a target row's theta step to the row above or below, kept off 0
template <typename T>
__device__ __forceinline__ T theta_step(T a) {
  return a > T(1e-30) ? a : T(1e-30);
}

template <typename T>
__device__ __forceinline__ void tap(T& acc, T w, T y, T v, T vt) {
  const T x = y - vt;
  T wph = T(1) - bf::m_fabs(x);
  wph = wph > T(0) ? wph : T(0);
  acc = acc + w * wph * v;
}

// one slab cell: its source's offsets and value (0 where it has none)
template <typename P, typename T>
struct Cell {
  P p0, p1;
  T og;
};

template <typename P, typename T>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(TileArgs ta, const T* __restrict__ colscale_r,
               const P* __restrict__ po, const T* __restrict__ orig,
               const bool* __restrict__ excl, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RB = ta.RB, K = ta.K, W = ta.W, Wc = ta.Wc, PS = RB * K;
  const Layout lay(RB, K, W, Wc);
  const int R = lay.R, Q = lay.Q, D = lay.D, Qp = lay.Qp, Qv = lay.Qv,
            Su = lay.Su;
  double* phi0 = reinterpret_cast<double*>(smem_raw);     // (R,)
  double* dphi = phi0 + R;                                 // (R,)
  T* th = reinterpret_cast<T*>(dphi + R);                  // (R,)
  T* colscale = th + R;                                    // (R,)
  using Key = typename KeyOf<T>::type;
  Key* rlo = reinterpret_cast<Key*>(colscale + R);         // (R,)
  Key* rhi = rlo + R;                                      // (R,)
  T* ts = reinterpret_cast<T*>(rhi + R);                   // (R, Q)
  T* cs = ts + R * Q;                                      // (R, Q)
  T* vs = cs + R * Q;                                      // (R, Qv)
  T* dm = vs + R * Qv;                                     // (RB,)
  T* dpp = dm + RB;                                        // (RB,)
  T* r0 = dpp + RB;                                        // (RB, D)
  T* rat = r0 + RB * D;                                    // (RB, D)
  T* wth = rat + RB * D;                                   // (RB, Su)
  T* yt = wth + RB * Su;                                   // (RB, Su)
  int* segL = reinterpret_cast<int*>(yt + RB * Su);        // (R,)
  int* segC = segL + R;                                    // (R,)
  int* r_ok = segC + R;                                    // (R,)
  int* live = r_ok + R;                                    // (RB, D)
  int* rows = live + RB * D;               // (RB * D,): u << 8 | du, listed
  int* nbs = rows + RB * D;                                // (9,)
  int* gone = nbs + 9;                                     // (9,)
  int* n_rows = gone + 9;                                  // (1,)

  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int i0 = ta.i0[t], s = ta.s[t], S = ta.S[t];
  // 1. the slab rows' ring data and segment starts; the 3 x 3 neighbours
  //    and whether their sources are out (missing or excluded)
  for (int rho = tid; rho < R; rho += blockDim.x) {
    const int r = i0 - W + rho;
    r_ok[rho] = r >= 1 && r <= 4 * ta.N - 1;
    const int rc = bf::clampi(r, 1, 4 * ta.N - 1) - 1;
    const int nr = ta.ring_nr[rc], sh = ta.ring_sh[rc];
    const int sm = bf::floor_mod(s - 1, S);
    const int j0c = bf::sector_j0(s, nr, sh, S);
    segC[rho] = bf::sector_j0(s + 1, nr, sh, S) - j0c;
    segL[rho] = bf::floor_mod(j0c - bf::sector_j0(sm, nr, sh, S), nr);
    const double dp = ta.ring_dphi[rc];
    dphi[rho] = dp;
    phi0[rho] = (double(j0c) + 0.5 * double(sh)) * dp;
    th[rho] = T(ta.ring_theta[rc]);
    colscale[rho] = colscale_r[rc];
  }
  {
    const int j = tid - (blockDim.x - 9);
    if (j >= 0) {
      const int nb = ta.nbr[9 * (long long)t + j];
      nbs[j] = nb > 0 ? nb : 0;
      gone[j] = nb < 0 || excl[nb > 0 ? nb : 0];
    }
  }
  if (tid == 0) *n_rows = 0;
  for (int rho = tid; rho < R; rho += blockDim.x) {
    rlo[rho] = order_key(T(INFINITY));
    rhi[rho] = order_key(T(-INFINITY));
  }
  __syncthreads();
  // 2. per target row u: its theta steps; per (u, du): the float64 column
  //    relations. Then the slab, kCellsAhead cells a thread at once (all
  //    their loads before any use): each cell's theta_src, c_src and
  //    value, and each row's least and largest theta_src (shared atomics on
  //    order-preserving integer keys; NaN left out)
  for (int i = tid; i < RB * D; i += blockDim.x) {
    const int u = i / D, row = u + i % D;
    const double dphi_t = dphi[W + u], phi0_t = phi0[W + u];
    r0[i] = T((phi0[row] - phi0_t) / dphi_t);
    rat[i] = T(dphi[row] / dphi_t);
  }
  for (int u = tid; u < RB; u += blockDim.x) {
    dm[u] = theta_step(th[W + u] - th[W + u - 1]);
    dpp[u] = theta_step(th[W + u + 1] - th[W + u]);
  }
  {
    const float invQ = 1.0f / float(Q);
    for (int c00 = tid; c00 < R * Q; c00 += kCellsAhead * blockDim.x) {
      Cell<P, T> c[kCellsAhead];
      int cr[kCellsAhead], cq[kCellsAhead];
#pragma unroll
      for (int j = 0; j < kCellsAhead; ++j) {
        const int cell = c00 + j * blockDim.x;
        int rho = int(float(cell) * invQ);
        rho -= rho * Q > cell;
        rho += (rho + 1) * Q <= cell;
        const int q = cell - rho * Q;
        cr[j] = rho;
        cq[j] = q;
        c[j] = Cell<P, T>{P(0), P(0), T(0)};
        if (cell >= R * Q) continue;
        const int db = rho < W ? 0 : (rho < W + RB ? 1 : 2);
        const int us = rho < W ? RB - W + rho
                               : (rho < W + RB ? rho - W : rho - W - RB);
        const int jr = q - Wc, sc = segC[rho];
        int col, vv;
        bool okv;
        if (jr < 0) {
          col = 0;
          vv = segL[rho] + jr;
          okv = vv >= 0;
        } else if (jr < sc) {
          col = 1;
          vv = jr;
          okv = vv < K;
        } else {
          col = 2;
          vv = jr - sc;
          okv = vv < K;
        }
        if (okv) {
          const long long idx =
              (long long)nbs[db * 3 + col] * PS + us * K + vv;
          c[j].p0 = po[2 * idx];
          c[j].p1 = po[2 * idx + 1];
          if (!gone[db * 3 + col] && r_ok[rho]) c[j].og = orig[idx];
        }
      }
#pragma unroll
      for (int j = 0; j < kCellsAhead; ++j) {
        const int rho = cr[j], q = cq[j];
        if (c00 + j * blockDim.x >= R * Q) continue;
        vs[rho * Qv + q] = c[j].og;
        // 0 / x is that zero: no division
        const T p1 = T(c[j].p1), x = th[rho] + T(c[j].p0);
        ts[rho * Q + q] = x;
        cs[rho * Q + q] = T(q - Wc) + (p1 == T(0) ? p1 : p1 / colscale[rho]);
        if (x == x) {
          atomicMin(&rlo[rho], order_key(x));
          atomicMax(&rhi[rho], order_key(x));
        }
      }
    }
    // the padding columns of vs
    for (int i = tid; i < R * (Qv - Q); i += blockDim.x) {
      const int rho = i / (Qv - Q);
      vs[rho * Qv + Q + i - rho * (Qv - Q)] = T(0);
    }
  }
  __syncthreads();
  // the tap rows (u, du) that can carry weight, listed. The theta-hat
  // weight is 0 where d = theta_src - theta_u <= -dm or >= dpp (then d / dm
  // <= -1 or d / dpp >= 1 before rounding, so after), and d is monotonic in
  // theta_src: a tap row whose least and largest d both fall there (or
  // whose sources are all NaN) is left out, no table and no taps. A source
  // that did not move has d = -dm or dpp one row away.
  for (int r = tid; r < RB * D; r += blockDim.x) {
    const int u = r / D, du = r - u * D;
    const T th_t = th[W + u];
    const T lo = from_key<T>(rlo[u + du]), hi = from_key<T>(rhi[u + du]);
    const bool keep = !(hi - th_t <= -dm[u] || lo - th_t >= dpp[u]);
    live[r] = keep;
    if (keep) rows[atomicAdd(n_rows, 1)] = u << 8 | du;
  }
  __syncthreads();
  // 3. wth and y of the listed tap rows, every column: wth is 1 where d = 0
  //    (1 + 0 / dm), 0 in the zero range, else one division; y is only
  //    formed where wth is not 0 (a tap of wth 0 adds 0 whatever its y)
  {
    const int n = *n_rows * Qp;
    const float inv = 1.0f / float(Qp);
    for (int e = tid; e < n; e += blockDim.x) {
      int k = int(float(e) * inv);
      k -= k * Qp > e;
      k += (k + 1) * Qp <= e;
      const int q = e - k * Qp, u = rows[k] >> 8, du = rows[k] & 255;
      const int r = u * D + du, row = u + du;
      T w = T(0), y = T(0);
      if (q < Q) {
        const T d = ts[row * Q + q] - th[W + u];
        if (d == T(0)) {
          w = T(1);
        } else if (d <= -dm[u] || d >= dpp[u]) {
          w = T(0);
        } else if (d < T(0)) {
          w = T(1) + d / dm[u];
        } else {
          w = T(1) - d / dpp[u];
        }
        w = w > T(0) ? w : T(0);
        if (w != T(0)) y = r0[r] + cs[row * Q + q] * rat[r];
      }
      wth[u * Su + du * Qp + q] = w;
      yt[u * Su + du * Qp + q] = y;
    }
  }
  __syncthreads();
  // 4. the taps: kV consecutive slots of row u, from vt0
  const int u = tid / lay.TPR, vt0 = (tid - u * lay.TPR) * kV;
  if (u >= RB) return;
  T acc[kV], vtk[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    acc[k] = T(0);
    vtk[k] = T(vt0 + k);
  }
  for (int du = 0; du < D; ++du) {
    if (!live[u * D + du]) continue;
    const T* wq = wth + u * Su + du * Qp + vt0;
    const T* yq = yt + u * Su + du * Qp + vt0;
    const T* vq = vs + (u + du) * Qv + vt0;
    // cell j feeds slot k at column offset dv = j - k, 0 <= dv <= 2 Wc:
    // cells 0 .. kV - 2 the first slots, kV - 1 .. 2 Wc every slot, then
    // the last slots; each slot sees its cells in dv order
#pragma unroll
    for (int j = 0; j < kV - 1; ++j) {
      const T w = wq[j], y = yq[j], v = vq[j];
#pragma unroll
      for (int k = 0; k <= j; ++k) tap(acc[k], w, y, v, vtk[k]);
    }
    for (int j = kV - 1; j <= 2 * Wc; ++j) {
      const T w = wq[j], y = yq[j], v = vq[j];
#pragma unroll
      for (int k = 0; k < kV; ++k) tap(acc[k], w, y, v, vtk[k]);
    }
#pragma unroll
    for (int j = 1; j < kV; ++j) {
      const int c = 2 * Wc + j;
      const T w = wq[c], y = yq[c], v = vq[c];
#pragma unroll
      for (int k = j; k < kV; ++k) tap(acc[k], w, y, v, vtk[k]);
    }
  }
  T* o = out + (long long)t * PS + u * K + vt0;
#pragma unroll
  for (int k = 0; k < kV; ++k)
    if (vt0 + k < K) o[k] = acc[k];
}

template <typename P>
int launch_hot(int n_tiles, int P_slots, const P* acc, const double* th_theta,
               const double* th_phi, const bool* d_geom, bool* excl,
               void* stream) {
  if (n_tiles == 0) return 0;
  const int vec = reinterpret_cast<size_t>(acc) % 16 == 0 &&
                  (2 * size_t(P_slots) * sizeof(P)) % 16 == 0;
  stencil_hot_kernel<P><<<(n_tiles + kHotTiles - 1) / kHotTiles,
                          32 * kHotTiles, 0, (cudaStream_t)stream>>>(
      n_tiles, P_slots, vec, acc, th_theta, th_phi, d_geom, excl);
  return int(cudaGetLastError());
}

template <typename P, typename T>
int launch(int nside, int RB, int K, int n_tiles, int W, int Wc,
           const int* tile_i0, const int* tile_s, const int* tile_S,
           const int* nbr, const double* ring_theta, const double* ring_dphi,
           const int* ring_nr, const int* ring_sh, const T* ring_colscale,
           const P* po, const T* orig, const bool* excl, T* out,
           void* stream) {
  const Layout lay(RB, K, W, Wc);
  // kThreads stage the slab and form the weight tables, RB * TPR of them
  // then run the taps
  const int threads = kThreads;
  const size_t smem = lay.bytes<T>(RB);
  // the tap loop's split of cells needs kV <= 2 Wc + 1; the row list packs
  // du in 8 bits
  if (W < 1 || 2 * W + 1 > 256 || RB * lay.TPR > kThreads ||
      kV > 2 * Wc + 1)
    return int(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  TileArgs ta{nside,  RB,  K,          W,         Wc,      tile_i0, tile_s,
              tile_S, nbr, ring_theta, ring_dphi, ring_nr, ring_sh};
  stencil_kernel<P, T><<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      ta, ring_colscale, po, orig, excl, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// excl[t] = max|acc[t, :, 0]| > th_theta[t] or max|acc[t, :, 1]| >
// th_phi[t] or d_geom[t]; acc is (n_tiles, P_slots, 2)
int bf_stencil_hot_f32(int n_tiles, int P_slots, const float* acc,
                       const double* th_theta, const double* th_phi,
                       const bool* d_geom, bool* excl, void* stream) {
  return launch_hot<float>(n_tiles, P_slots, acc, th_theta, th_phi, d_geom,
                           excl, stream);
}

int bf_stencil_hot_f64(int n_tiles, int P_slots, const double* acc,
                       const double* th_theta, const double* th_phi,
                       const bool* d_geom, bool* excl, void* stream) {
  return launch_hot<double>(n_tiles, P_slots, acc, th_theta, th_phi, d_geom,
                            excl, stream);
}

// offsets po (n_tiles, RB*K, 2) in the deposit dtype (first suffix), map
// orig and result out (n_tiles, RB*K) in the regrid dtype (second suffix);
// the ring table (4 nside - 1 rings): theta and dphi float64, nr and
// shifted int32, colscale in the regrid dtype
#define BF_STENCIL(P, T, SUF)                                                \
  int bf_stencil_##SUF(int nside, int RB, int K, int n_tiles, int W, int Wc, \
                       const int* tile_i0, const int* tile_s,                \
                       const int* tile_S, const int* nbr,                    \
                       const double* ring_theta, const double* ring_dphi,    \
                       const int* ring_nr, const int* ring_sh,               \
                       const T* ring_colscale, const P* po, const T* orig,   \
                       const bool* excl, T* out, void* stream) {             \
    return launch<P, T>(nside, RB, K, n_tiles, W, Wc, tile_i0, tile_s,       \
                        tile_S, nbr, ring_theta, ring_dphi, ring_nr,         \
                        ring_sh, ring_colscale, po, orig, excl, out,         \
                        stream);                                             \
  }

// the stencil's dynamic shared memory a block (bytes), float64 regrid or
// float32
int bf_stencil_smem_bytes(int RB, int K, int W, int Wc, int f64) {
  const Layout lay(RB, K, W, Wc);
  return int(f64 ? lay.bytes<double>(RB) : lay.bytes<float>(RB));
}

BF_STENCIL(float, float, f32_f32)
BF_STENCIL(float, double, f32_f64)
BF_STENCIL(double, float, f64_f32)
BF_STENCIL(double, double, f64_f64)
#undef BF_STENCIL

}  // extern "C"
