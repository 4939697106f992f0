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
// new position, added by atomics into the flat map that already holds
// flat_view (K7) of the stencil's output. An unmoved source adds its value
// to its own pixel, an exact identity.
//
// stencil_geo: one block per geometric tile, one thread per slot; a valid
// slot's place in the compact list is its tile's offset (host prefix sum of
// the valid-slot counts) plus its rank in the tile (the valid slots of a
// ring row are its first ones), which is the order of the JAX nonzero.
//
// stencil_complement: one thread per source: the geometric list first,
// then every slot of every hot tile (dead slots return at once). The hot
// tiles come as a variable-length list; the JAX version pads them to
// chunks of 512 tiles for static shapes.
//
// Bound: atomics to device memory, as K3: ~10 transcendentals and 4
// atomicAdds per moved source, 1 per unmoved one; 667,648 geometric
// sources at the bench shapes. Design: consecutive threads take
// consecutive slots, whose targets are neighbouring pixels.

#include "tiles.cuh"

namespace {

template <typename T>
__global__ void stencil_geo_kernel(int N, int RB, int K,
                                   const int* __restrict__ g_tids,
                                   const int* __restrict__ g_off,
                                   const int* __restrict__ tile_i0,
                                   const int* __restrict__ tile_s,
                                   const int* __restrict__ tile_S,
                                   int* __restrict__ sf,
                                   int* __restrict__ pix,
                                   T* __restrict__ theta,
                                   T* __restrict__ phi) {
  const int PS = RB * K;
  const int slot = threadIdx.x;
  if (slot >= PS) return;
  const int t = g_tids[blockIdx.x];
  const int u = slot / K, v = slot % K;
  const bf::Seg g = bf::tile_segment(N, tile_i0[t], u, tile_s[t], tile_S[t]);
  int jw, p;
  if (!bf::slot_of(g, v, jw, p)) return;
  int rank = v;
  for (int uu = 0; uu < u; ++uu) {
    const bf::Seg gg = bf::tile_segment(N, tile_i0[t], uu, tile_s[t],
                                        tile_S[t]);
    if (gg.ok) rank += gg.len < K ? gg.len : K;
  }
  const long long k = (long long)g_off[blockIdx.x] + rank;
  sf[k] = t * PS + slot;
  pix[k] = p;
  theta[k] = T(bf::ring_theta<double>(N, g.i_c));
  phi[k] = T((double(jw) + 0.5 * double(g.sh)) * (bf::kTwoPi / double(g.nr)));
}

template <typename P, typename T>
__global__ void stencil_complement_kernel(
    int N, int RB, int K, int n_geo, const int* __restrict__ sf,
    const int* __restrict__ gpix, const T* __restrict__ gth,
    const T* __restrict__ gph, int n_hot, const int* __restrict__ hot,
    const int* __restrict__ tile_i0, const int* __restrict__ tile_s,
    const int* __restrict__ tile_S, const P* __restrict__ acc,
    const T* __restrict__ orig, T* __restrict__ out) {
  const int PS = RB * K;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_geo + (long long)n_hot * PS) return;
  long long slot;
  int self;
  T theta_p, phi_p;
  if (k < n_geo) {
    slot = sf[k];
    self = gpix[k];
    theta_p = gth[k];
    phi_p = gph[k];
  } else {
    const long long kk = k - n_geo;
    const int t = hot[kk / PS];
    const int sl = int(kk % PS);
    const bf::Seg g = bf::tile_segment(N, tile_i0[t], sl / K, tile_s[t],
                                       tile_S[t]);
    int jw;
    if (!bf::slot_of(g, sl % K, jw, self)) return;
    slot = (long long)t * PS + sl;
    theta_p = T(bf::ring_theta<double>(N, g.i_c));
    phi_p = T((double(jw) + 0.5 * double(g.sh)) *
              (bf::kTwoPi / double(g.nr)));
  }
  const P o0 = acc[2 * slot], o1 = acc[2 * slot + 1];
  const T src = orig[slot];
  if (o0 == P(0) && o1 == P(0)) {
    atomicAdd(out + self, src);
    return;
  }
  int pix[4];
  T w[4];
  bf::displaced_weights<T>(N, theta_p, phi_p, T(o0), T(o1), pix, w);
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(out + pix[c], w[c] * src);
}

template <typename T>
int launch_geo(int nside, int RB, int K, int n_g, const int* g_tids,
               const int* g_off, const int* tile_i0, const int* tile_s,
               const int* tile_S, int* sf, int* pix, T* theta, T* phi,
               void* stream) {
  const int PS = RB * K;
  if (PS > 1024) return int(cudaErrorInvalidValue);
  if (n_g == 0) return 0;
  stencil_geo_kernel<T><<<n_g, (PS + 31) / 32 * 32, 0,
                          (cudaStream_t)stream>>>(nside, RB, K, g_tids, g_off,
                                                  tile_i0, tile_s, tile_S, sf,
                                                  pix, theta, phi);
  return int(cudaGetLastError());
}

template <typename P, typename T>
int launch(int nside, int RB, int K, int n_geo, const int* sf,
           const int* gpix, const T* gth, const T* gph, int n_hot,
           const int* hot, const int* tile_i0, const int* tile_s,
           const int* tile_S, const P* acc, const T* orig, T* out,
           void* stream) {
  const long long total = n_geo + (long long)n_hot * RB * K;
  if (total == 0) return 0;
  const int threads = 256;
  stencil_complement_kernel<P, T><<<int((total + threads - 1) / threads),
                                    threads, 0, (cudaStream_t)stream>>>(
      nside, RB, K, n_geo, sf, gpix, gth, gph, n_hot, hot, tile_i0, tile_s,
      tile_S, acc, orig, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// the compact list of the valid slots of tiles g_tids (n_g tiles, valid
// slots of tile b at g_off[b] ...): slot id t * RB * K + slot, pixel,
// theta and phi in the regrid dtype
#define BF_GEO(T, SUF)                                                        \
  int bf_stencil_geo_##SUF(int nside, int RB, int K, int n_g,                \
                           const int* g_tids, const int* g_off,              \
                           const int* tile_i0, const int* tile_s,            \
                           const int* tile_S, int* sf, int* pix, T* theta,   \
                           T* phi, void* stream) {                           \
    return launch_geo<T>(nside, RB, K, n_g, g_tids, g_off, tile_i0, tile_s,  \
                         tile_S, sf, pix, theta, phi, stream);               \
  }

BF_GEO(float, f32)
BF_GEO(double, f64)
#undef BF_GEO

// adds the complement into out (npix,): offsets acc (n_tiles, RB*K, 2) in
// the deposit dtype (first suffix), orig (n_tiles, RB*K) and out in the
// regrid dtype (second suffix)
#define BF_COMPLEMENT(P, T, SUF)                                              \
  int bf_stencil_complement_##SUF(                                            \
      int nside, int RB, int K, int n_geo, const int* sf, const int* gpix,   \
      const T* gth, const T* gph, int n_hot, const int* hot,                 \
      const int* tile_i0, const int* tile_s, const int* tile_S, const P* acc,\
      const T* orig, T* out, void* stream) {                                 \
    return launch<P, T>(nside, RB, K, n_geo, sf, gpix, gth, gph, n_hot, hot, \
                        tile_i0, tile_s, tile_S, acc, orig, out, stream);    \
  }

BF_COMPLEMENT(float, float, f32_f32)
BF_COMPLEMENT(float, double, f32_f64)
BF_COMPLEMENT(double, float, f64_f32)
BF_COMPLEMENT(double, double, f64_f64)
#undef BF_COMPLEMENT

}  // extern "C"
