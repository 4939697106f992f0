// K20: disc radii, and K21: disc apply -- the shell runners' direct readout
// for models without halo_curves.
//
// Replace the direct branches of baryonforge_tpu/Runners/HealpixRunner.py:
// BaryonifyShell's _make_body_factory (one_halo with
// model.displacement, :866-934), PaintProfilesShell._paint_device's
// make_body (model.projected, :1949-1980) and PaintProfilesAnisShell's
// scatter body (model.projected and tracer.projected, :2379-2419). There
// the model is called on each halo's padded window of pixels under
// jax.vmap; here the port splits the body around that call
// (ops/direct.py): K20 lays each halo's member pixels and their comoving r
// out in rows, the model is read on the rows by torch.func.vmap, and K21
// turns its values into the body's sums.
//
// K20 walks every disc on K2's flat walk (healpix.cuh: the member set of
// the JAX window) in two launches: the first counts each disc's members,
// the second, given each halo's first slot (ops/direct.row_layout groups
// the halos by count and pads the rows), writes member k of halo h, in the
// walk's flat (ring, dp) order, to slot base[h] + k: its pixel, its halo
// and its r, and for the displacement its tangent geometry. The geometry
// is each JAX body's own, in T with the x64 promotions written out:
//   displace: r = 2 sin(d/2) D / a in T, the tangent factors ct0 sin_t -
//     st0 cos_t cos dphi and st0 sin dphi, and D chord_safe; a disc of
//     fewer than 4 members is replaced by the 4 interpolation neighbours
//     of its centre (the float64 phi offset and haversine of K2's
//     fallback);
//   paint: r = 2 sin(d/2) D / a in T, no fallback;
//   anis: r = |pix2vec(pix) - vec_h| D / a in float64 (the unit vectors in
//     T, a and D in float64), the member set of disc_pixels.
// K21 takes one slot a thread: pad slots (pixel -1) add nothing;
//   displace: d = T(value a) (value in float64, as value * a_h promotes
//     under x64), zeroed if not finite, amp = d / (D chord_safe), the two
//     tangent components zeroed if not finite and added into (npix, 2);
//   paint: the value in T, zeroed if not finite, times T(pixarea D^2) when
//     asked, added into the (npix,) map of type A;
//   anis: painting and canvas in float64, zeroed if not finite, mfrac =
//     canvas / Mtot[pix] (0 where Mtot <= 0) times orig[pix], the painting
//     times pixarea D^2 when asked, painting mfrac added into a float64
//     map.
//
// Bound: K20 by K2's walk (three float64 transcendentals a ring, ~30
// operations a candidate pixel) and by its writes, 20 bytes a member in
// float32 (pixel, halo, r and three geometry values for the displacement);
// K21 by its reads (the same bytes) and one or two atomics a slot into a
// map of 50-100 MB at NSIDE 1024. Design: K20 is K2's walk, 8 halos a
// block, one a warp, the whole block for a disc of more than 32 rings; a
// member's rank in its row is the count before it, from a ballot over the
// warp (and, on the block route, the warps' counts in shared memory), so
// the rows are in walk order and every launch writes the same slots. K21 is
// a flat pass in slot order, so that neighbouring threads add into
// neighbouring pixels of one disc. Sums by atomics change order from run to
// run.

#include "healpix.cuh"

namespace {

constexpr int kWarps = 8;  // halos a block takes, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kDisplace = 0, kPaint = 1, kAnis = 2 };

struct HaloIn {
  const double* theta;
  const double* phi;
  const double* radius;
  const double* D;
  const double* a;
};

// K20's outputs: each slot's pixel and halo, its r (T, or float64 for
// anis) and, for the displacement, 3 geometry values in T
template <typename T>
struct RowsOut {
  int* pix;
  int* hid;
  void* r;
  T* geo;
};

// the values of one halo that its members use
template <typename T>
struct DirectHalo {
  int hid;
  double th_h, ph_h, D64, a64;
  T theta0, ct0, st0, D, a;
  T vh0, vh1, vh2;  // anis: the unit vector, float64 rounded to T
};

template <typename T>
__device__ __forceinline__ DirectHalo<T> direct_halo(const HaloIn& in,
                                                     int hid,
                                                     const bf::DiscWalk<T>& w) {
  DirectHalo<T> h;
  h.hid = hid;
  h.th_h = in.theta[hid];
  h.ph_h = in.phi[hid];
  h.D64 = in.D[hid];
  h.a64 = in.a[hid];
  h.theta0 = w.theta0;
  h.ct0 = T(w.cos_th);
  h.st0 = T(w.sin_th);
  h.D = T(h.D64);
  h.a = T(h.a64);
  h.vh0 = T(sin(h.th_h) * cos(h.ph_h));
  h.vh1 = T(sin(h.th_h) * sin(h.ph_h));
  h.vh2 = T(cos(h.th_h));
  return h;
}

// slot s of a displacement row: pixel pix with its ring's cos/sin, its phi
// minus the centre's and sin(d/2)
template <typename T>
__device__ __forceinline__ void emit_displace(const DirectHalo<T>& h, int pix,
                                              T cos_t, T sin_t, T dphi_pix,
                                              T sinhd, long long s,
                                              const RowsOut<T>& o) {
  const T chord = T(2) * sinhd;
  o.pix[s] = pix;
  o.hid[s] = h.hid;
  static_cast<T*>(o.r)[s] = chord * h.D / h.a;
  o.geo[3 * s] = h.ct0 * sin_t - h.st0 * cos_t * bf::m_cos(dphi_pix);
  o.geo[3 * s + 1] = h.st0 * bf::m_sin(dphi_pix);
  o.geo[3 * s + 2] = h.D * (chord > T(0) ? chord : T(1));
}

template <typename T>
__device__ __forceinline__ void emit(int mode, int N, const DirectHalo<T>& h,
                                     const bf::DiscPixel<T>& p, long long s,
                                     const RowsOut<T>& o) {
  if (mode == kDisplace) {
    emit_displace(h, p.pix, p.cos_t, p.sin_t, p.dphi_pix, p.sinhd, s, o);
    return;
  }
  o.pix[s] = p.pix;
  o.hid[s] = h.hid;
  if (mode == kPaint) {
    static_cast<T*>(o.r)[s] = T(2) * p.sinhd * h.D / h.a;
    return;
  }
  // anis: the pixel's unit vector from its ring's cos/sin theta (pix2ang's
  // bit for bit, as K13) and its own phi
  const T ph = bf::ring_pixel_phi<T>(N, p.ring, p.j, p.shifted);
  const double d0 = double(p.sin_t * bf::m_cos(ph) - h.vh0) * h.D64;
  const double d1 = double(p.sin_t * bf::m_sin(ph) - h.vh1) * h.D64;
  const double d2 = double(p.cos_t - h.vh2) * h.D64;
  static_cast<double*>(o.r)[s] = sqrt(d0 * d0 + d1 * d1 + d2 * d2) / h.a64;
}

// the fallback of a displacement disc of fewer than 4 members: slot s gets
// the centre's k-th interpolation neighbour (K2's deposit_fallback)
template <typename T>
__device__ void emit_fallback(int N, const DirectHalo<T>& h, int k,
                              long long s, const RowsOut<T>& o) {
  int pix4[4];
  T w4[4];
  const T phi_w = T(bf::floor_fmod(h.ph_h, bf::kTwoPi));
  bf::interp_weights<T>(N, h.theta0, phi_w, pix4, w4);
  const int pix = pix4[k];
  T t4, p4;
  bf::pix2ang<T>(N, pix, t4, p4);
  const T cos_t = bf::m_cos(t4), sin_t = bf::m_sin(t4);
  const T dphi_pix = T(double(p4) - h.ph_h);
  const T sdp = bf::m_sin(T(0.5) * dphi_pix);
  const double sdt = sin(0.5 * (double(t4) - h.th_h));
  double hav = sdt * sdt + double(sin_t * h.st0 * (sdp * sdp));
  hav = hav < 0.0 ? 0.0 : (hav > 1.0 ? 1.0 : hav);
  emit_displace(h, pix, cos_t, sin_t, dphi_pix, T(sqrt(hav)), s, o);
}

struct Pass {
  int mode;
  bool write;               // false: count the members into count[]
  int* count;               // (n,) members a disc (written, or read)
  const long long* base;    // write: each halo's first slot, < 0 for none
};

// A block takes kWarps halos on K2's flat walk, one a warp; a disc of more
// than kSplitRings rings is walked by the whole block (its members are at
// least 4: see csrc/deposit.cu).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    disc_radii_kernel(int N, int n_h, HaloIn in, Pass ps, RowsOut<T> o) {
  __shared__ bf::FlatDiscs<T, kWarps> s;
  __shared__ int wcnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  bf::flat_disc_walks<kWarps>(
      N, n_h, in.theta, in.phi, in.radius, s,
      [&](int hid, const bf::DiscWalk<T>& walk, bf::DiscRing<T>* rings,
          int* first) {
        long long b = 0;
        bool fallback = false;
        if (ps.write) {
          b = ps.base[hid];
          if (b < 0) return;
          fallback = ps.mode == kDisplace && ps.count[hid] < 4;
        }
        const DirectHalo<T> h = direct_halo(in, hid, walk);
        int count = 0;  // members so far, the same in every lane
        bf::warp_walk(walk, rings, first,
                      [&](bool m, int, const bf::DiscPixel<T>& p) {
          const unsigned mask = __ballot_sync(kFull, m);
          if (ps.write && m && !fallback)
            emit(ps.mode, N, h, p, b + count + __popc(mask & lt), o);
          count += __popc(mask);
        });
        if (!ps.write && lane == 0) ps.count[hid] = count;
        if (fallback && lane < 4) emit_fallback(N, h, lane, b + lane, o);
      },
      [&](int hid, const bf::DiscWalk<T>& walk) {
        long long b = 0;
        if (ps.write) {
          b = ps.base[hid];
          if (b < 0) return;  // the same in every thread of the block
        }
        const DirectHalo<T> h = direct_halo(in, hid, walk);
        const int tid = threadIdx.x;
        int count = 0;
        for (int r0 = walk.ring_first; r0 <= walk.ring_last; r0 += kThreads) {
          const int n = min(kThreads, walk.ring_last - r0 + 1);
          int len = 0;
          if (tid < n) {
            s.rings[tid] = walk.ring(r0 + tid);
            len = s.rings[tid].hi - s.rings[tid].lo + 1;
          }
          int incl = len;
          for (int o2 = 1; o2 < 32; o2 <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o2);
            if (lane >= o2) incl += y;
          }
          if (lane == 31) s.wsum[warp] = incl;
          __syncthreads();
          int before = 0, total = 0;
          for (int w = 0; w < kWarps; ++w) {
            before += w < warp ? s.wsum[w] : 0;
            total += s.wsum[w];
          }
          if (tid < n) s.first[tid] = before + incl - len;
          __syncthreads();
          for (int q0 = 0; q0 < total; q0 += kThreads) {
            const int q = q0 + tid;
            bf::DiscPixel<T> p;
            const bool m = q < total &&
                           bf::flat_candidate(walk, s.rings, s.first, n, q, p);
            const unsigned mask = __ballot_sync(kFull, m);
            if (lane == 0) wcnt[warp] = __popc(mask);
            __syncthreads();
            int mb = 0, mt = 0;
            for (int w = 0; w < kWarps; ++w) {
              mb += w < warp ? wcnt[w] : 0;
              mt += wcnt[w];
            }
            if (ps.write && m)
              emit(ps.mode, N, h, p, b + count + mb + __popc(mask & lt), o);
            count += mt;
            __syncthreads();  // wcnt is read before the next step writes it
          }
        }
        if (!ps.write && threadIdx.x == 0) ps.count[hid] = count;
      });
}

template <typename T>
int launch_radii(int mode, int nside, int n_h, HaloIn in, int write,
                 int* count, const long long* base, RowsOut<T> o,
                 void* stream) {
  if (mode < kDisplace || mode > kAnis) return int(cudaErrorInvalidValue);
  if (n_h == 0) return 0;
  disc_radii_kernel<T>
      <<<(n_h + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
          nside, n_h, in, Pass{mode, write != 0, count, base}, o);
  return int(cudaGetLastError());
}

// K21, displacement: a thread a slot
template <typename T>
__global__ void apply_displace_kernel(long long n, const int* __restrict__ pix,
                                      const int* __restrict__ hid,
                                      const T* __restrict__ geo,
                                      const double* __restrict__ vals,
                                      const double* __restrict__ a,
                                      T* __restrict__ acc) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int p = pix[s];
  if (p < 0) return;
  T d = T(vals[s] * a[hid[s]]);
  if (!isfinite(d)) d = T(0);
  const T amp = d / geo[3 * s + 2];
  T t_th = amp * geo[3 * s];
  T t_ph = amp * geo[3 * s + 1];
  if (!isfinite(t_th)) t_th = T(0);
  if (!isfinite(t_ph)) t_ph = T(0);
  atomicAdd(acc + 2 * (long long)p, t_th);
  atomicAdd(acc + 2 * (long long)p + 1, t_ph);
}

// K21, paint: values in T, the map in A
template <typename T, typename A>
__global__ void apply_paint_kernel(long long n, const int* __restrict__ pix,
                                   const int* __restrict__ hid,
                                   const T* __restrict__ vals,
                                   const double* __restrict__ D,
                                   bool pixel_size, double pixarea,
                                   A* __restrict__ acc) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int p = pix[s];
  if (p < 0) return;
  T v = vals[s];
  if (!isfinite(v)) v = T(0);
  if (pixel_size) {
    const double D64 = D[hid[s]];
    v = v * T(pixarea * (D64 * D64));
  }
  atomicAdd(acc + p, A(v));
}

// K21, anis: everything in float64
__global__ void apply_anis_kernel(long long n, const int* __restrict__ pix,
                                  const int* __restrict__ hid,
                                  const double* __restrict__ painting_v,
                                  const double* __restrict__ canvas_v,
                                  const double* __restrict__ D,
                                  const double* __restrict__ mtot,
                                  const double* __restrict__ orig,
                                  bool pixel_size, double pixarea,
                                  double* __restrict__ acc) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int p = pix[s];
  if (p < 0) return;
  double painting = painting_v[s], canvas = canvas_v[s];
  if (!isfinite(painting)) painting = 0.0;
  if (!isfinite(canvas)) canvas = 0.0;
  const double mt = mtot[p];
  const double mfrac = (mt > 0.0 ? canvas / mt : 0.0) * orig[p];
  if (pixel_size) {
    const double D64 = D[hid[s]];
    painting = painting * (pixarea * (D64 * D64));
  }
  atomicAdd(acc + p, painting * mfrac);
}

constexpr int kApplyThreads = 256;

inline unsigned apply_blocks(long long n) {
  return unsigned((n + kApplyThreads - 1) / kApplyThreads);
}

}  // namespace

extern "C" {

// mode 0 displace, 1 paint, 2 anis; write 0 counts each disc's members into
// count, write 1 writes the rows from count and base; r in T (float64 for
// anis), geo (3 a slot, displace) in T
#define BF_DISC_RADII(T, SUF)                                                 \
  int bf_disc_radii_##SUF(int mode, int nside, int n_h, const double* theta,  \
                          const double* phi, const double* radius,            \
                          const double* D, const double* a, int write,        \
                          int* count, const long long* base, int* pix,        \
                          int* hid, void* r, T* geo, void* stream) {          \
    return launch_radii<T>(mode, nside, n_h, HaloIn{theta, phi, radius, D, a}, \
                           write, count, base,                                \
                           RowsOut<T>{pix, hid, r, geo}, stream);             \
  }

BF_DISC_RADII(float, f32)
BF_DISC_RADII(double, f64)
#undef BF_DISC_RADII

#define BF_APPLY_DISPLACE(T, SUF)                                            \
  int bf_disc_apply_displace_##SUF(long long n, const int* pix,             \
                                   const int* hid, const T* geo,            \
                                   const double* vals, const double* a,     \
                                   T* acc, void* stream) {                  \
    if (n == 0) return 0;                                                   \
    apply_displace_kernel<T><<<apply_blocks(n), kApplyThreads, 0,           \
                               (cudaStream_t)stream>>>(n, pix, hid, geo,    \
                                                       vals, a, acc);       \
    return int(cudaGetLastError());                                         \
  }

BF_APPLY_DISPLACE(float, f32)
BF_APPLY_DISPLACE(double, f64)
#undef BF_APPLY_DISPLACE

// values in the first type, the map in the second
#define BF_APPLY_PAINT(T, A, SUF)                                             \
  int bf_disc_apply_paint_##SUF(long long n, const int* pix, const int* hid, \
                                const T* vals, const double* D,              \
                                int pixel_size, double pixarea, A* acc,      \
                                void* stream) {                              \
    if (n == 0) return 0;                                                    \
    apply_paint_kernel<T, A><<<apply_blocks(n), kApplyThreads, 0,            \
                               (cudaStream_t)stream>>>(                      \
        n, pix, hid, vals, D, pixel_size != 0, pixarea, acc);                \
    return int(cudaGetLastError());                                          \
  }

BF_APPLY_PAINT(float, float, f32_f32)
BF_APPLY_PAINT(float, double, f32_f64)
BF_APPLY_PAINT(double, float, f64_f32)
BF_APPLY_PAINT(double, double, f64_f64)
#undef BF_APPLY_PAINT

int bf_disc_apply_anis(long long n, const int* pix, const int* hid,
                       const double* painting, const double* canvas,
                       const double* D, const double* mtot,
                       const double* orig, int pixel_size, double pixarea,
                       double* acc, void* stream) {
  if (n == 0) return 0;
  apply_anis_kernel<<<apply_blocks(n), kApplyThreads, 0,
                      (cudaStream_t)stream>>>(n, pix, hid, painting, canvas,
                                              D, mtot, orig, pixel_size != 0,
                                              pixarea, acc);
  return int(cudaGetLastError());
}

}  // extern "C"
