// Sky-tiling slot geometry as device functions: the integer ring/segment
// math of baryonforge_torch/ops/tiles.py (SkyTiling._segments, slot_pix),
// which ports baryonforge_tpu/ops/tiles.py:285-330.
//
// Tile (b, s) covers rings i0 .. i0 + RB - 1 and, on each ring, the pixels
// j0(s) .. j0(s+1) - 1 of sector s of S, with j0(s) = ceil(s nr / S - sh/2)
// written as integer math; slot (u, v) is ring i0 + u, pixel j0(s) + v, and
// is dead when v is past the segment or the ring is off the sphere. Slot
// ids are int32 (NSIDE <= 8192, checked by the wrappers).
#pragma once

#include "healpix.cuh"

namespace bf {

// first in-ring index of sector s (the numerator is positive)
__device__ __forceinline__ int sector_j0(int s, int nr, int sh, int S) {
  return (2 * s * nr - sh * S + 2 * S - 1) / (2 * S);
}

// one ring row of a tile
struct Seg {
  bool ok;   // ring on the sphere
  int i_c;   // ring, clamped to [1, 4N - 1]
  int sp;    // first pixel of the ring
  int nr;    // pixels in the ring
  int sh;    // 1 where centres sit at (j + 0.5) dphi
  int j0;    // first in-ring index of the segment
  int len;   // segment length (may exceed K; slots past K do not exist)
};

__device__ __forceinline__ Seg tile_segment(int N, int i0, int u, int s,
                                            int S) {
  Seg g;
  const int i = i0 + u;
  g.ok = i >= 1 && i <= 4 * N - 1;
  g.i_c = clampi(i, 1, 4 * N - 1);
  Ring<double> r = ring_info<double>(N, g.i_c);
  g.sp = r.sp;
  g.nr = r.nr;
  g.sh = r.shifted != 0.0 ? 1 : 0;
  g.j0 = sector_j0(s, g.nr, g.sh, S);
  g.len = sector_j0(s + 1, g.nr, g.sh, S) - g.j0;
  return g;
}

// slot v of a ring row: valid, and its in-ring index and pixel
__device__ __forceinline__ bool slot_of(const Seg& g, int v, int& jw,
                                        int& pix) {
  const int j = g.j0 + v;
  jw = j < g.nr ? j : j - g.nr;
  pix = g.sp + jw;
  return g.ok && v < g.len;
}

}  // namespace bf
