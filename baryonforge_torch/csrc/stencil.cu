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
// stencil_hot: one block per tile reduces max |d theta| and max |tangent
// phi| over its slots and compares them, in float64, with the thresholds.
//
// stencil: one block per target tile and one thread per target slot. The
// block first stages the slab of (RB + 2W) x (K + 2Wc) source cells that
// its window needs (theta_src, column c_src and value) in shared memory,
// from its 3 x 3 neighbour tiles: rows come from the tile above (its last
// W rows), its own row of tiles, the tile below (first W rows); on each
// row, slab column q is in-ring index j0 + q - Wc, read from the left
// neighbour's segment, the tile's own or the right neighbour's by direct
// index (the JAX version places the segments with a one-hot contraction,
// because the TPU has no per-lane gather). Then every thread sweeps its 55
// taps in the JAX order (rows outer, columns inner). Sources of excluded
// or missing tiles carry value 0.
//
// Bound: shared-memory reads and arithmetic: 55 taps of ~12 flops and 3
// shared loads per slot, ~17.4M slots at the bench shapes. The staging
// reads each source cell once per tile from device memory (1.6x the tile:
// the 20 x 42 slab over 16 x 32 slots). Design: the slab is built once per
// block, and the per-row float64 grid relations r0 and rat are formed once
// per tap row, outside the column loop.
//
// Precision: ring thetas are float64 rounded to the regrid dtype T; the
// per-row column origin phi0 and step dphi stay float64, and r0, rat are
// formed in float64 then rounded (tiles.py:1521-1569), so that the
// zero-offset neighbour separation is an exact integer.

#include "tiles.cuh"

namespace {

template <typename P>
__global__ void stencil_hot_kernel(int P_slots, const P* __restrict__ acc,
                                   const double* __restrict__ th_theta,
                                   const double* __restrict__ th_phi,
                                   const bool* __restrict__ d_geom,
                                   bool* __restrict__ excl) {
  __shared__ P m0s[256], m1s[256];
  const int t = blockIdx.x;
  const P* a = acc + (long long)t * P_slots * 2;
  P m0 = P(0), m1 = P(0);
  for (int k = threadIdx.x; k < P_slots; k += blockDim.x) {
    const P x0 = bf::m_fabs(a[2 * k]), x1 = bf::m_fabs(a[2 * k + 1]);
    m0 = x0 > m0 ? x0 : m0;
    m1 = x1 > m1 ? x1 : m1;
  }
  m0s[threadIdx.x] = m0;
  m1s[threadIdx.x] = m1;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const P y0 = m0s[threadIdx.x + w], y1 = m1s[threadIdx.x + w];
      if (y0 > m0s[threadIdx.x]) m0s[threadIdx.x] = y0;
      if (y1 > m1s[threadIdx.x]) m1s[threadIdx.x] = y1;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    excl[t] = double(m0s[0]) > th_theta[t] || double(m1s[0]) > th_phi[t] ||
              d_geom[t];
}

struct TileArgs {
  int N, RB, K, W, Wc;
  const int* i0;
  const int* s;
  const int* S;
  const int* nbr;  // (n_tiles, 9): rows above / same / below, cols L C R
};

template <typename P, typename T>
__global__ void stencil_kernel(TileArgs ta, const P* __restrict__ po,
                               const T* __restrict__ orig,
                               const bool* __restrict__ excl,
                               T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int RB = ta.RB, K = ta.K, W = ta.W, Wc = ta.Wc;
  const int R = RB + 2 * W, Q = K + 2 * Wc, PS = RB * K;
  double* phi0 = reinterpret_cast<double*>(smem_raw);     // (R,)
  double* dphi = phi0 + R;                                 // (R,)
  T* th = reinterpret_cast<T*>(dphi + R);                  // (R,)
  T* colscale = th + R;                                    // (R,)
  T* ts = colscale + R;                                    // (R, Q)
  T* cs = ts + R * Q;                                      // (R, Q)
  T* vs = cs + R * Q;                                      // (R, Q)
  int* segL = reinterpret_cast<int*>(vs + R * Q);          // (R,)
  int* segC = segL + R;                                    // (R,)
  int* r_ok = segC + R;                                    // (R,)

  const int t = blockIdx.x;
  const int i0 = ta.i0[t], s = ta.s[t], S = ta.S[t];
  for (int rho = threadIdx.x; rho < R; rho += blockDim.x) {
    const int r = i0 - W + rho;
    r_ok[rho] = r >= 1 && r <= 4 * ta.N - 1;
    const int rc = bf::clampi(r, 1, 4 * ta.N - 1);
    const bf::Ring<double> ri = bf::ring_info<double>(ta.N, rc);
    const int sh = ri.shifted != 0.0 ? 1 : 0;
    const T theta = T(bf::ring_theta<double>(ta.N, rc));
    const int sm = bf::floor_mod(s - 1, S);
    const int j0c = bf::sector_j0(s, ri.nr, sh, S);
    segC[rho] = bf::sector_j0(s + 1, ri.nr, sh, S) - j0c;
    segL[rho] = bf::floor_mod(j0c - bf::sector_j0(sm, ri.nr, sh, S), ri.nr);
    const double dp = bf::kTwoPi / double(ri.nr);
    dphi[rho] = dp;
    phi0[rho] = (double(j0c) + 0.5 * double(sh)) * dp;
    th[rho] = theta;
    const T sin_r = bf::m_sin(theta);
    colscale[rho] = (sin_r > T(1e-12) ? sin_r : T(1)) * T(dp);
  }
  __syncthreads();
  const int* nb9 = ta.nbr + 9 * (long long)t;
  for (int cell = threadIdx.x; cell < R * Q; cell += blockDim.x) {
    const int rho = cell / Q, q = cell % Q;
    const int jr = q - Wc;
    const int db = rho < W ? 0 : (rho < W + RB ? 1 : 2);
    const int us = rho < W ? RB - W + rho : (rho < W + RB ? rho - W
                                                          : rho - W - RB);
    int col, vv;
    bool okv;
    if (jr < 0) {
      col = 0;
      vv = segL[rho] + jr;
      okv = vv >= 0;
    } else if (jr < segC[rho]) {
      col = 1;
      vv = jr;
      okv = vv < K;
    } else {
      col = 2;
      vv = jr - segC[rho];
      okv = vv < K;
    }
    const int nb = nb9[db * 3 + col];
    const long long nbc = nb > 0 ? nb : 0;
    P p0 = P(0), p1 = P(0);
    T og = T(0);
    if (okv) {
      const long long idx = nbc * PS + us * K + vv;
      p0 = po[2 * idx];
      p1 = po[2 * idx + 1];
      og = (nb < 0 || excl[nbc]) ? T(0) : orig[idx];
    }
    vs[cell] = r_ok[rho] ? og : T(0);
    ts[cell] = th[rho] + T(p0);
    cs[cell] = T(jr) + T(p1) / colscale[rho];
  }
  __syncthreads();
  const int slot = threadIdx.x;
  if (slot >= PS) return;
  const int u = slot / K, vt = slot % K;
  const T th_t = th[W + u];
  T dm = th_t - th[W + u - 1];
  dm = dm > T(1e-30) ? dm : T(1e-30);
  T dpp = th[W + u + 1] - th_t;
  dpp = dpp > T(1e-30) ? dpp : T(1e-30);
  const double dphi_t = dphi[W + u], phi0_t = phi0[W + u];
  T acc = T(0);
  for (int du = 0; du <= 2 * W; ++du) {
    const int row = u + du;
    const T r0 = T((phi0[row] - phi0_t) / dphi_t);
    const T rat = T(dphi[row] / dphi_t);
    for (int dv = 0; dv <= 2 * Wc; ++dv) {
      const int cell = row * Q + vt + dv;
      const T d = ts[cell] - th_t;
      T wth;
      if (d <= T(0)) {
        wth = T(1) + d / dm;
      } else {
        wth = T(1) - d / dpp;
      }
      wth = wth > T(0) ? wth : T(0);
      const T x = r0 + cs[cell] * rat - T(vt);
      T wph = T(1) - bf::m_fabs(x);
      wph = wph > T(0) ? wph : T(0);
      acc = acc + wth * wph * vs[cell];
    }
  }
  out[(long long)t * PS + slot] = acc;
}

template <typename P>
int launch_hot(int n_tiles, int P_slots, const P* acc, const double* th_theta,
               const double* th_phi, const bool* d_geom, bool* excl,
               void* stream) {
  stencil_hot_kernel<P><<<n_tiles, 256, 0, (cudaStream_t)stream>>>(
      P_slots, acc, th_theta, th_phi, d_geom, excl);
  return int(cudaGetLastError());
}

template <typename T>
size_t smem_bytes(int R, int Q) {
  return size_t(R) * 2 * sizeof(double) + size_t(R) * 2 * sizeof(T) +
         size_t(R) * Q * 3 * sizeof(T) + size_t(R) * 3 * sizeof(int);
}

template <typename P, typename T>
int launch(int nside, int RB, int K, int n_tiles, int W, int Wc,
           const int* tile_i0, const int* tile_s, const int* tile_S,
           const int* nbr, const P* po, const T* orig, const bool* excl,
           T* out, void* stream) {
  const int PS = RB * K;
  const size_t smem = smem_bytes<T>(RB + 2 * W, K + 2 * Wc);
  if (PS > 1024 || smem > 48 * 1024) return int(cudaErrorInvalidValue);
  TileArgs ta{nside, RB, K, W, Wc, tile_i0, tile_s, tile_S, nbr};
  stencil_kernel<P, T><<<n_tiles, (PS + 31) / 32 * 32, smem,
                         (cudaStream_t)stream>>>(ta, po, orig, excl, out);
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
// orig and result out (n_tiles, RB*K) in the regrid dtype (second suffix)
#define BF_STENCIL(P, T, SUF)                                                \
  int bf_stencil_##SUF(int nside, int RB, int K, int n_tiles, int W, int Wc, \
                       const int* tile_i0, const int* tile_s,                \
                       const int* tile_S, const int* nbr, const P* po,       \
                       const T* orig, const bool* excl, T* out,              \
                       void* stream) {                                       \
    return launch<P, T>(nside, RB, K, n_tiles, W, Wc, tile_i0, tile_s,       \
                        tile_S, nbr, po, orig, excl, out, stream);           \
  }

BF_STENCIL(float, float, f32_f32)
BF_STENCIL(float, double, f32_f64)
BF_STENCIL(double, float, f64_f32)
BF_STENCIL(double, double, f64_f64)
#undef BF_STENCIL

}  // extern "C"
