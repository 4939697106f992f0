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

// the two pixels of ring `ring` bracketing phi, the phi weight, the ring's
// colatitude
template <typename T>
__device__ __forceinline__ void ring_phi_neighbors(int N, int ring, T phi,
                                                   int& pa, int& pb, T& w,
                                                   T& theta_ring) {
  Ring<T> r = ring_info<T>(N, ring);
  T dphi = ring_dphi<T>(r.nr);
  int i1 = int(m_floor(phi / dphi - T(0.5) * r.shifted));
  w = (phi - (T(i1) + T(0.5) * r.shifted) * dphi) / dphi;
  pa = r.sp + floor_mod(i1, r.nr);
  pb = r.sp + floor_mod(i1 + 1, r.nr);
  theta_ring = ring_theta<T>(N, ring);
}

// healpy get_interp_weights: 4 neighbours and bilinear weights of
// (theta, phi), phi already wrapped into [0, 2 pi) by the caller
template <typename T>
__device__ __forceinline__ void interp_weights(int N, T theta, T phi,
                                               int pix[4], T wgt[4]) {
  int ir1 = ring_above_theta<T>(N, theta);
  int ir2 = ir1 + 1;
  int p0, p1, p2, p3;
  T w1, w2, theta1, theta2;
  ring_phi_neighbors<T>(N, clampi(ir1, 1, 4 * N - 1), phi, p0, p1, w1, theta1);
  ring_phi_neighbors<T>(N, clampi(ir2, 1, 4 * N - 1), phi, p2, p3, w2, theta2);
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

// 4 neighbours and weights of a source at pixel centre (theta_p, phi_p)
// moved by the tangent offset (o0, o1) = (d theta, sin theta d phi): a pole
// overshoot passes through the pole (theta reflected, phi turned by pi).
// The caller handles an unmoved source (o0 == o1 == 0: itself, weight 1).
template <typename T>
__device__ __forceinline__ void displaced_weights(int N, T theta_p, T phi_p,
                                                  T o0, T o1, int pix[4],
                                                  T wgt[4]) {
  const T sin_t = m_sin(theta_p);
  const T sin_safe = sin_t > T(1e-12) ? sin_t : T(1);
  T theta = theta_p + o0;
  T phi = phi_p + o1 / sin_safe;
  const bool over = theta < T(0) || theta > T(kPi);
  theta = m_fabs(theta);
  if (theta > T(kPi)) theta = T(kTwoPi) - theta;
  if (over) phi = phi + T(kPi);
  phi = floor_fmod(phi, T(kTwoPi));
  interp_weights<T>(N, theta, phi, pix, wgt);
}

}  // namespace bf
