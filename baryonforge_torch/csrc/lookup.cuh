// The per-halo curve lookup of the runners' bodies in float64, from curves
// stored in T: TabulatedProfile.curve_lookup (log curves, exp'd) and
// BaryonificationClass.curve_lookup (raw curves) of the JAX package as they
// run there under x64 with a float64 radius, the curve values rounded to
// the runner's dtype.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bf {

// a set of per-halo curves on one log-uniform grid ln r = ln_r0 + i dlnr
template <typename T>
struct Curve {
  const T* c;      // (n_halos, n_r)
  int n_r;
  double ln_r0, dlnr;
  bool log_curve;  // the curves hold logs: exp after the lerp
};

// one halo's curve (its row of g.c) at radius r: x = (ln max(r, 1e-30) -
// ln_r0) / dlnr, the bracket floor(x) clamped to [0, n_r - 2], the lerp in
// float64, exp for log curves, and zero off the grid
template <typename T>
__device__ __forceinline__ double lookup64(const T* curve, const Curve<T>& g,
                                           double r) {
  const double x = (log(r > 1e-30 ? r : 1e-30) - g.ln_r0) / g.dlnr;
  const double xf = floor(x);
  const int i = xf < 0.0 ? 0 : (xf > double(g.n_r - 2) ? g.n_r - 2 : int(xf));
  const double t = x - double(i);
  double v = double(curve[i]) * (1.0 - t) + double(curve[i + 1]) * t;
  if (g.log_curve) v = exp(v);
  return (x < 0.0 || x > double(g.n_r - 1)) ? 0.0 : v;
}

}  // namespace bf
