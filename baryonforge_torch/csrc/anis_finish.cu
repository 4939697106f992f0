// K14: the anisotropic paint's finish, one elementwise pass over the map.
//
// Replaces the three jitted finishing passes of the JAX package's
// anisotropic runners, which weight the halo sum by the per-pixel tracer
// mass fraction and add the uniform-background tracer term:
//   tiled shell (baryonforge_tpu/Runners/HealpixRunner.py:2349-2360, fin):
//     mt2 = double(mt) + add, good = mt2 > 0,
//     out = (good ? double(hs) og / mt2 : 0) + bgw (good ? add / mt2 : 0) og;
//   scatter shell (:2440-2443, add_bg) and grid (Map2DRunner.py:792-796,
//   fin), where the halo sum is already a float64 map and mt already holds
//   the background:
//     out = hs scale + bgw (mt > 0 ? add / mt : 0) og,
//   with scale = res^2 for a grid painted with include_pixel_size and 1
//   otherwise (a product by 1 is exact).
// hs and mt are in T (the tiled shell's maps are in the runner's dtype),
// og and the output in float64.
//
// Bound: bytes. Per pixel 2 sizeof(T) + 16 bytes, ~6 operations: at NSIDE
// 1024 ~25-40 MB, ~10 us at 3.35 TB/s. Design: a grid-stride loop, one
// pixel a thread, neighbouring threads on neighbouring pixels.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void anis_finish_kernel(long long n, const T* __restrict__ hs,
                                   const T* __restrict__ mt,
                                   const double* __restrict__ og, double add,
                                   double bgw, double scale, bool tiled,
                                   double* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double o = og[i];
    if (tiled) {
      const double mt2 = double(mt[i]) + add;
      const bool good = mt2 > 0.0;
      const double base = good ? double(hs[i]) * o / mt2 : 0.0;
      const double bg = (good ? add / mt2 : 0.0) * o;
      out[i] = base + bgw * bg;
    } else {
      const double m = double(mt[i]);
      const double bg = (m > 0.0 ? add / m : 0.0) * o;
      out[i] = double(hs[i]) * scale + bgw * bg;
    }
  }
}

template <typename T>
int launch(long long n, const T* hs, const T* mt, const double* og,
           double add, double bgw, double scale, int tiled, double* out,
           void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  anis_finish_kernel<T><<<int(blocks), threads, 0, (cudaStream_t)stream>>>(
      n, hs, mt, og, add, bgw, scale, tiled != 0, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BF_ANIS_FINISH(T, SUF)                                                \
  int bf_anis_finish_##SUF(long long n, const T* hs, const T* mt,             \
                           const double* og, double add, double bgw,          \
                           double scale, int tiled, double* out,              \
                           void* stream) {                                    \
    return launch<T>(n, hs, mt, og, add, bgw, scale, tiled, out, stream);     \
  }

BF_ANIS_FINISH(float, f32)
BF_ANIS_FINISH(double, f64)
#undef BF_ANIS_FINISH

}  // extern "C"
