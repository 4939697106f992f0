// HEALPix RING-scheme geometry as device functions, templated on the float
// type T (float or double). The same equations, in the same order of
// operations, as the plain versions in baryonforge_torch/ops/healpix.py,
// which port baryonforge_tpu/ops/healpix.py.
//
// Precision: the JAX package runs with x64 enabled, so a Python float met
// with an int32 array is a weak float64 there. The few "float32" values
// it thereby computes in float64 and rounds once are computed the same way
// here: the ring step dphi = 2 pi / nr, the cap ring index of pix2ang
// (float64 square root) and its j + 0.5. Integer floor-division and
// floor-mod follow jnp (C's / and % truncate); jnp.round is rint.
// Pixel math is int32, valid up to NSIDE 8192 (the wrappers check).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bf {

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;

#define BF_MATH1(name, f32, f64)                                          \
  __device__ __forceinline__ float name(float x) { return f32(x); }      \
  __device__ __forceinline__ double name(double x) { return f64(x); }

BF_MATH1(m_sin, sinf, sin)
BF_MATH1(m_cos, cosf, cos)
BF_MATH1(m_asin, asinf, asin)
BF_MATH1(m_acos, acosf, acos)
BF_MATH1(m_sqrt, sqrtf, sqrt)
BF_MATH1(m_floor, floorf, floor)
BF_MATH1(m_rint, rintf, rint)
BF_MATH1(m_log, logf, log)
BF_MATH1(m_exp, expf, exp)
BF_MATH1(m_fabs, fabsf, fabs)
#undef BF_MATH1

__device__ __forceinline__ float m_fmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double m_fmod(double a, double b) { return fmod(a, b); }

template <typename T>
__device__ __forceinline__ T clampf(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// jnp.mod on floats: fmod, moved into the divisor's sign
template <typename T>
__device__ __forceinline__ T floor_fmod(T a, T b) {
  T r = m_fmod(a, b);
  return (r != T(0) && ((r < T(0)) != (b < T(0)))) ? r + b : r;
}

// fmod(a, n), n > 0, without the library's loop for -2 n < a < 2 n: a, a -
// n or a + n, each exact (Sterbenz), so bitwise fmod's (a = -n, whose fmod
// is -0, and anything else goes to the library). K4 and K16.
template <typename R>
__device__ __forceinline__ R fmod_near(R a, R n) {
  if (a > -n && a < n) return a;
  if (a >= n && a < R(2) * n) return a - n;
  if (a < -n && a > R(-2) * n) return a + n;
  return m_fmod(a, n);
}

// floor_fmod by way of fmod_near: bitwise floor_fmod's
template <typename R>
__device__ __forceinline__ R floor_fmod_near(R a, R n) {
  const R r = fmod_near(a, n);
  return (r != R(0) && ((r < R(0)) != (n < R(0)))) ? r + n : r;
}

template <typename T>
__device__ __forceinline__ T rt6N(int N) {
  return m_sqrt(T(6)) * T(N);
}

template <typename T>
struct Ring {
  int sp;      // first pixel of the ring
  int nr;      // pixels in the ring
  T shifted;   // 1 where centres sit at (j + 0.5) dphi
};

template <typename T>
__device__ __forceinline__ Ring<T> ring_info(int N, int i) {
  Ring<T> r;
  if (i < N) {
    r.nr = 4 * i;
    r.sp = 2 * i * (i - 1);
    r.shifted = T(1);
  } else if (i > 3 * N) {
    int is = 4 * N - i;
    r.nr = 4 * is;
    r.sp = 12 * N * N - 2 * is * (is + 1);
    r.shifted = T(1);
  } else {
    r.nr = 4 * N;
    r.sp = 2 * N * (N - 1) + (i - N) * 4 * N;
    r.shifted = floor_mod(i - N, 2) == 0 ? T(1) : T(0);
  }
  return r;
}

// 2 pi / nr in float64, rounded once to T
template <typename T>
__device__ __forceinline__ T ring_dphi(int nr) {
  return T(kTwoPi / double(nr));
}

template <typename T>
__device__ __forceinline__ T ring_theta(int N, int i) {
  if (i < N)
    return T(2) * m_asin(clampf(T(i) / rt6N<T>(N), T(0), T(1)));
  if (i > 3 * N)
    return T(kPi) - T(2) * m_asin(clampf(T(4 * N - i) / rt6N<T>(N), T(0), T(1)));
  T z = T(4.0 / 3.0) - T(2) * T(i) / T(3.0 * N);
  return m_acos(clampf(z, T(-1), T(1)));
}

template <typename T>
__device__ __forceinline__ int ring_above_theta(int N, T theta) {
  T z = m_cos(theta);
  if (m_fabs(z) > T(2.0 / 3.0)) {
    if (z > T(0)) return int(m_floor(rt6N<T>(N) * m_sin(T(0.5) * theta)));
    return 4 * N - int(m_floor(rt6N<T>(N) * m_cos(T(0.5) * theta))) - 1;
  }
  return int(m_floor(T(N) * (T(2) - T(1.5) * z)));
}

// cap ring i with 2 i (i-1) <= p < 2 i (i+1)
__device__ __forceinline__ int cap_ring(int p) {
  int i = int((1.0 + sqrt(1.0 + 2.0 * double(p))) / 2.0);
  if (2 * i * (i - 1) > p) i -= 1;
  if (2 * i * (i + 1) <= p) i += 1;
  return i;
}

template <typename T>
__device__ __forceinline__ void pix2ang(int N, int p, T& theta, T& phi) {
  int ncap = 2 * N * (N - 1);
  int npx = 12 * N * N;
  if (p < ncap) {
    int i = cap_ring(p);
    int j = p - 2 * i * (i - 1);
    theta = T(2) * m_asin(clampf(T(i) / rt6N<T>(N), T(0), T(1)));
    phi = (T(kPi) / (T(2) * T(i))) * T(double(j) + 0.5);
  } else if (p >= npx - ncap) {
    int ps = npx - 1 - p;
    int i = cap_ring(ps);
    int j = 4 * i - 1 - (ps - 2 * i * (i - 1));
    theta = T(kPi) - T(2) * m_asin(clampf(T(i) / rt6N<T>(N), T(0), T(1)));
    phi = (T(kPi) / (T(2) * T(i))) * T(double(j) + 0.5);
  } else {
    int pe = p - ncap;
    int i = N + floor_div(pe, 4 * N);
    int j = floor_mod(pe, 4 * N);
    T z = T(4.0 / 3.0) - T(2) * T(i) / T(3.0 * N);
    T s = floor_mod(i - N, 2) == 0 ? T(1) : T(0);
    theta = m_acos(clampf(z, T(-1), T(1)));
    phi = T(kPi / (2.0 * N)) * (T(j) + T(0.5) * s);
  }
}

// A ring's colatitude and phi step as pix2ang and get_interp_weights form
// them. K3 and K6 pass TableRings, with the same two members, reading
// them from a table filled with these functions, so both give the same
// bits.
template <typename T>
struct RingAngles {
  int N;
  __device__ __forceinline__ T theta(int i) const {
    return ring_theta<T>(N, i);
  }
  __device__ __forceinline__ T dphi(int, int nr) const {
    return ring_dphi<T>(nr);
  }
};

// One ring of a per-ring table (K3, K6): theta, the phi step and
// sin(theta) (1 where sin(theta) <= 1e-12), each in T, 16 (32) bytes.
// ring_row is the target form, each value as pix2ang and interp_weights
// form it (the same functions, so the same bits); source_ring_row is K6's
// source form, whose theta is the float64 ring_theta rounded to T (the
// JAX stencil's source colatitude) and whose sin is taken of that. The two
// forms differ in float32 only.
template <typename T>
struct RingRow {
  T theta, dphi, sin_safe, pad;
};

template <typename T>
__device__ __forceinline__ RingRow<T> ring_row_of(int N, int i, T theta) {
  RingRow<T> r;
  r.theta = theta;
  r.dphi = ring_dphi<T>(ring_info<T>(N, i).nr);
  const T s = m_sin(r.theta);
  r.sin_safe = s > T(1e-12) ? s : T(1);
  r.pad = T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ RingRow<T> ring_row(int N, int i) {
  return ring_row_of<T>(N, i, ring_theta<T>(N, i));
}

template <typename T>
__device__ __forceinline__ RingRow<T> source_ring_row(int N, int i) {
  return ring_row_of<T>(N, i, T(ring_theta<double>(N, i)));
}

// ring of pixel p (pix2ang's: the cap's float64 square root, the belt's
// integer division)
__device__ __forceinline__ int pixel_ring(int N, int p) {
  const int ncap = 2 * N * (N - 1);
  const int npx = 12 * N * N;
  if (p < ncap) return cap_ring(p);
  if (p >= npx - ncap) return 4 * N - cap_ring(npx - 1 - p);
  return N + floor_div(p - ncap, 4 * N);
}

// the two pixels of ring `ring` bracketing phi, the phi weight, the ring's
// colatitude
template <typename T, typename Rings>
__device__ __forceinline__ void ring_phi_neighbors(int N, int ring, T phi,
                                                   const Rings& rings,
                                                   int& pa, int& pb, T& w,
                                                   T& theta_ring) {
  Ring<T> r = ring_info<T>(N, ring);
  T dphi = rings.dphi(ring, r.nr);
  int i1 = int(m_floor(phi / dphi - T(0.5) * r.shifted));
  w = (phi - (T(i1) + T(0.5) * r.shifted) * dphi) / dphi;
  pa = r.sp + floor_mod(i1, r.nr);
  pb = r.sp + floor_mod(i1 + 1, r.nr);
  theta_ring = rings.theta(ring);
}

// healpy get_interp_weights: 4 neighbours and bilinear weights of
// (theta, phi), phi already wrapped into [0, 2 pi) by the caller
template <typename T, typename Rings>
__device__ __forceinline__ void interp_weights(int N, T theta, T phi,
                                               const Rings& rings,
                                               int pix[4], T wgt[4]) {
  int ir1 = ring_above_theta<T>(N, theta);
  int ir2 = ir1 + 1;
  int p0, p1, p2, p3;
  T w1, w2, theta1, theta2;
  ring_phi_neighbors<T>(N, clampi(ir1, 1, 4 * N - 1), phi, rings, p0, p1, w1,
                        theta1);
  ring_phi_neighbors<T>(N, clampi(ir2, 1, 4 * N - 1), phi, rings, p2, p3, w2,
                        theta2);
  T wgt0 = T(1) - w1, wgt1 = w1, wgt2 = T(1) - w2, wgt3 = w2;
  if (ir1 == 0) {                              // north of ring 1
    T wt = theta / theta2;
    T fac = (T(1) - wt) * T(0.25);
    pix[0] = (p2 + 2) % 4;
    pix[1] = (p3 + 2) % 4;
    pix[2] = p2;
    pix[3] = p3;
    wgt[0] = fac;
    wgt[1] = fac;
    wgt[2] = wgt2 * wt + fac;
    wgt[3] = wgt3 * wt + fac;
  } else if (ir2 == 4 * N) {                   // south of ring 4N-1
    T wt = (theta - theta1) / (T(kPi) - theta1);
    T fac = wt * T(0.25);
    int npx = 12 * N * N;
    pix[0] = p0;
    pix[1] = p1;
    pix[2] = (p0 + 2) % 4 + npx - 4;
    pix[3] = (p1 + 2) % 4 + npx - 4;
    wgt[0] = wgt0 * (T(1) - wt) + fac;
    wgt[1] = wgt1 * (T(1) - wt) + fac;
    wgt[2] = fac;
    wgt[3] = fac;
  } else {
    T wt = (theta - theta1) / (theta2 - theta1);
    pix[0] = p0;
    pix[1] = p1;
    pix[2] = p2;
    pix[3] = p3;
    wgt[0] = wgt0 * (T(1) - wt);
    wgt[1] = wgt1 * (T(1) - wt);
    wgt[2] = wgt2 * wt;
    wgt[3] = wgt3 * wt;
  }
}

template <typename T>
__device__ __forceinline__ void interp_weights(int N, T theta, T phi,
                                               int pix[4], T wgt[4]) {
  interp_weights<T>(N, theta, phi, RingAngles<T>{N}, pix, wgt);
}

// a table of ring_row's (indexed by ring) as interp_weights reads rings:
// the same bits as RingAngles
template <typename T>
struct TableRings {
  const RingRow<T>* __restrict__ rows;
  __device__ __forceinline__ T theta(int i) const { return rows[i].theta; }
  __device__ __forceinline__ T dphi(int i, int) const { return rows[i].dphi; }
};

// phi of pixel j of ring i (shifted as ring_info gives it), with
// pix2ang's operations: the cap rings' pi / (2 i) (j + 0.5), the belt's
// pi / (2 N) (j + s / 2)
template <typename T>
__device__ __forceinline__ T ring_pixel_phi(int N, int i, int j, T shifted) {
  if (i < N || i > 3 * N) {
    const int ic = i < N ? i : 4 * N - i;
    return (T(kPi) / (T(2) * T(ic))) * T(double(j) + 0.5);
  }
  return T(kPi / (2.0 * N)) * (T(j) + T(0.5) * shifted);
}

// One ring of a disc walk: the ring's index, first pixel, length, shift
// and phi step, the in-ring index jc of the column nearest the disc
// centre, the span lo .. hi of offsets from jc that can hold members, and
// the ring centre's cos/sin colatitude and sin((theta_r - theta0) / 2).
template <typename T>
struct DiscRing {
  int i, sp, nr, jc, lo, hi;
  T shifted, dphi, cos_t, sin_t, sdt;
};

// Every pixel whose centre lies inside the disc of angular radius rad_h
// around (th_h, ph_h) (the haversine test sin(d/2) <= sin(rad/2) of
// ops/healpix.py: disc_candidates, in T), each once. The constructor does
// the per-disc set-up once; ring() and pixel() are the per-ring and
// per-pixel halves, which the flat walk below (K2, K11, K13) lays out.
//
// The JAX version walks a padded (K_ring, K_phi) window whose size is
// fixed per size bucket, because XLA needs static shapes. Here each disc
// walks its own rings (from the ring below ring_above(theta0 - radius) to
// two rings past theta0 + radius) and, on each ring, its own phi span (the
// exact disc/ring half-width in float64 plus two pixels, cut to the
// no-duplicate range [-(nr-1)/2, nr/2] around the centre column). Every
// pixel that can pass the test lies in that span, and no pixel appears
// twice, so the member set is the JAX window's.
template <typename T>
struct DiscWalk {
  int N, ring_first, ring_last;
  T theta0, phi0, sin_t0, crit;
  double cos_rad, sin_th, cos_th;

  __device__ __forceinline__ DiscWalk(int nside, double th_h, double ph_h,
                                      double rad_h)
      : N(nside), theta0(T(th_h)), phi0(T(ph_h)) {
    sin_t0 = m_sin(theta0);
    const T rad = T(rad_h);
    crit = m_sin(T(0.5) * rad);
    const T top = theta0 - rad;
    ring_first =
        clampi(ring_above_theta<T>(N, top > T(0) ? top : T(0)), 0, 4 * N - 1) +
        1;
    const T bot = theta0 + rad;
    ring_last = clampi(ring_above_theta<T>(N, bot < T(kPi) ? bot : T(kPi)) + 2,
                       1, 4 * N - 1);
    cos_rad = cos(rad_h);
    sin_th = sin(th_h);
    cos_th = cos(th_h);
  }

  __device__ __forceinline__ DiscRing<T> ring(int i) const {
    DiscRing<T> d;
    const Ring<T> ri = ring_info<T>(N, i);
    const T theta_r = ring_theta<T>(N, i);
    d.i = i;
    d.sp = ri.sp;
    d.nr = ri.nr;
    d.shifted = ri.shifted;
    d.dphi = ring_dphi<T>(ri.nr);
    d.jc = int(m_rint(phi0 / d.dphi - T(0.5) * ri.shifted));
    d.lo = -((ri.nr - 1) / 2);
    d.hi = ri.nr / 2;
    const double s = sin(double(theta_r)) * sin_th;
    if (s > 1e-12) {
      const double c = (cos_rad - cos(double(theta_r)) * cos_th) / s;
      if (c > -1.0) {
        const double half = acos(c < 1.0 ? c : 1.0);
        const int hw = int(ceil(half / double(d.dphi))) + 2;
        d.lo = max(d.lo, -hw);
        d.hi = min(d.hi, hw);
      }
    }
    d.cos_t = m_cos(theta_r);
    d.sin_t = m_sin(theta_r);
    d.sdt = m_sin(T(0.5) * (theta_r - theta0));
    return d;
  }

  // offset dp of ring r: true for a member, with its pixel, phi minus the
  // centre's and sin(d/2)
  __device__ __forceinline__ bool pixel(const DiscRing<T>& r, int dp,
                                        int& pix, T& dphi_pix,
                                        T& sinhd) const {
    const int jw = floor_mod(r.jc + dp, r.nr);
    dphi_pix = (T(jw) + T(0.5) * r.shifted) * r.dphi - phi0;
    const T sdp = m_sin(T(0.5) * dphi_pix);
    const T hav = r.sdt * r.sdt + r.sin_t * sin_t0 * (sdp * sdp);
    sinhd = m_sqrt(clampf(hav, T(0), T(1)));
    pix = r.sp + jw;
    return sinhd <= crit;
  }
};

// The flat disc walk of K2, K11 and K13. A disc's rings are worked out once
// (DiscWalk::ring, one thread a ring) into shared memory, a scan of their
// phi span lengths lays the disc out as one flat (ring, dp) index, and the
// threads walk that index: every lane holds a candidate pixel whatever the
// rings' lengths, and neighbouring lanes land on neighbouring pixels. A
// block of kWarps warps takes kWarps discs, one a warp (warp_walk); a disc
// of more than kSplitRings rings is walked by the whole block (block_walk),
// after the warps' own discs (flat_disc_walks).
constexpr int kSplitRings = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// a candidate pixel of the flat walk: the pixel, its ring, its index j in
// the ring, the ring's shift and cos/sin colatitude, and as DiscWalk::pixel
// gives them its phi minus the disc centre's and sin(d/2)
template <typename T>
struct DiscPixel {
  int pix, ring, j;
  T shifted, cos_t, sin_t, dphi_pix, sinhd;
};

// the shared memory of a block that walks discs flat
template <typename T, int kWarps>
struct FlatDiscs {
  DiscRing<T> rings[32 * kWarps];
  int first[32 * kWarps];
  int wsum[kWarps];
  bool big[kWarps];
};

// Flat candidate q of n rings laid out in shared memory (ring k holds the
// candidates first[k] .. first[k] + hi - lo): true for a member
template <typename T>
__device__ __forceinline__ bool flat_candidate(const DiscWalk<T>& walk,
                                               const DiscRing<T>* rings,
                                               const int* first, int n, int q,
                                               DiscPixel<T>& p) {
  int lo = 0, hi = n - 1;          // the last ring with first <= q
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= q)
      lo = mid;
    else
      hi = mid - 1;
  }
  const DiscRing<T>& r = rings[lo];
  p.ring = r.i;
  p.shifted = r.shifted;
  p.cos_t = r.cos_t;
  p.sin_t = r.sin_t;
  const bool member =
      walk.pixel(r, r.lo + (q - first[lo]), p.pix, p.dphi_pix, p.sinhd);
  p.j = p.pix - r.sp;
  return member;
}

// A disc of at most kSplitRings rings, on one warp: lane k lays out ring
// k, a warp scan of the span lengths gives the flat index, and the lanes
// walk it 32 candidates at a time. Every lane runs visit(member, q, p) for
// each of its candidates q (member false past the last), so visit may use
// the warp's collectives.
template <typename T, typename Visit>
__device__ void warp_walk(const DiscWalk<T>& walk, DiscRing<T>* rings,
                          int* first, Visit&& visit) {
  const int lane = threadIdx.x & 31;
  const int n = walk.ring_last - walk.ring_first + 1;  // may be 0
  int len = 0;
  if (lane < n) {
    rings[lane] = walk.ring(walk.ring_first + lane);
    len = rings[lane].hi - rings[lane].lo + 1;
  }
  int incl = len;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane < n) first[lane] = incl - len;
  const int total = __shfl_sync(kFullMask, incl, 31);
  __syncwarp();
  for (int base = 0; base < total; base += 32) {
    const int q = base + lane;
    DiscPixel<T> p;
    p.pix = 0;
    const bool m = q < total && flat_candidate(walk, rings, first, n, q, p);
    visit(m, q, p);
    __syncwarp();
  }
}

// A disc of more than kSplitRings rings, on the whole block: 32 kWarps
// rings at a time, one a thread, a block scan of their span lengths, and
// the block's threads over the flat index; visit(p) for each member.
// Every thread of the block calls it.
template <int kWarps, typename T, typename Visit>
__device__ void block_walk(const DiscWalk<T>& walk, DiscRing<T>* rings,
                           int* first, int* wsum, Visit&& visit) {
  constexpr int kThreads = 32 * kWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r0 = walk.ring_first; r0 <= walk.ring_last; r0 += kThreads) {
    const int n = min(kThreads, walk.ring_last - r0 + 1);
    int len = 0;
    if (tid < n) {
      rings[tid] = walk.ring(r0 + tid);
      len = rings[tid].hi - rings[tid].lo + 1;
    }
    int incl = len;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    if (tid < n) first[tid] = before + incl - len;
    __syncthreads();
    for (int q = tid; q < total; q += kThreads) {
      DiscPixel<T> p;
      if (flat_candidate(walk, rings, first, n, q, p)) visit(p);
    }
    __syncthreads();               // before the next chunk's rings
  }
}

// Discs d = blockIdx.x kWarps + warp of n (centres and radii in float64):
// each warp runs on_warp(d, walk, rings, first) for its own disc of at
// most kSplitRings rings, with its 32 entries of s; then the whole block
// runs on_block(d, walk) for each of its discs of more rings, in turn.
template <int kWarps, typename T, typename OnWarp, typename OnBlock>
__device__ void flat_disc_walks(int N, int n, const double* theta,
                                const double* phi, const double* radius,
                                FlatDiscs<T, kWarps>& s, OnWarp&& on_warp,
                                OnBlock&& on_block) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarps + warp;
  bool big = false;
  if (d < n) {
    const DiscWalk<T> walk(N, theta[d], phi[d], radius[d]);
    big = walk.ring_last - walk.ring_first + 1 > kSplitRings;
    if (!big) on_warp(d, walk, s.rings + 32 * warp, s.first + 32 * warp);
  }
  if (lane == 0) s.big[warp] = big;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (!s.big[w]) continue;
    const int bd = blockIdx.x * kWarps + w;
    on_block(bd, DiscWalk<T>(N, theta[bd], phi[bd], radius[bd]));
  }
}

// 4 neighbours and weights of a source at pixel centre (theta_p, phi_p),
// sin_safe its sin(theta_p) (1 where that is not above 1e-12), moved by
// the tangent offset (o0, o1) = (d theta, sin theta d phi): a pole
// overshoot passes through the pole (theta reflected, phi turned by pi).
// The caller handles an unmoved source (o0 == o1 == 0: itself, weight 1).
template <typename T, typename Rings>
__device__ __forceinline__ void displaced_weights(int N, T theta_p, T phi_p,
                                                  T sin_safe, T o0, T o1,
                                                  const Rings& rings,
                                                  int pix[4], T wgt[4]) {
  T theta = theta_p + o0;
  T phi = phi_p + o1 / sin_safe;
  const bool over = theta < T(0) || theta > T(kPi);
  theta = m_fabs(theta);
  if (theta > T(kPi)) theta = T(kTwoPi) - theta;
  if (over) phi = phi + T(kPi);
  phi = floor_fmod(phi, T(kTwoPi));
  interp_weights<T>(N, theta, phi, rings, pix, wgt);
}

template <typename T>
__device__ __forceinline__ void displaced_weights(int N, T theta_p, T phi_p,
                                                  T o0, T o1, int pix[4],
                                                  T wgt[4]) {
  const T sin_t = m_sin(theta_p);
  displaced_weights<T>(N, theta_p, phi_p, sin_t > T(1e-12) ? sin_t : T(1),
                       o0, o1, RingAngles<T>{N}, pix, wgt);
}

}  // namespace bf
