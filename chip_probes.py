"""Design probes of kernels K4 (tile deposit), K10 and K12 (tile paint and
paint2, K4's template in its paint modes), K11 (disc paint), K3 (scatter
regrid) and K1 (curve collapse) on the card, at the bench inputs of
chip_smoke.py.

    python3 chip_probes.py [K4] [K3] [K1]   # one card; builds included
    python3 chip_probes.py --tree DIR calls

With no argument it runs the variant sections: K4 (tile_deposit.cu with
K10, K12, and disc_paint.cu), K3 (regrid.cu), K1 (curves.cu). The
section ``calls`` builds no variant: it times K1 and K3 as the scatter
shell runner calls them, with the ``baryonforge_torch`` package of the
tree DIR (this checkout's by default; another one, such as a ``git
archive`` of an earlier commit, for a like-for-like comparison of two
trees in one chip call, each in a process of its own). Each variant is
a kernel's source in baryonforge_torch/csrc/ with a few text replacements,
compiled with the build's own nvcc flags into a library of its own (one
nvcc per variant, all started together). The wrappers run unchanged with
that library in place of the build's. Every variant that keeps the
kernel's results is first held against the plain version, as
chip_smoke.py holds the kernel; then the variants of a kernel are timed by
CUDA events (chip_smoke.time_ms: the mean of 20 wrapper calls after a
warm-up; K3 and K1 also chip_smoke.graph_ms, the device alone) in turns,
forward and back, twice, and each variant's four readings are printed.
The variants:

tile_deposit.cu (K4 at the shell bench, K10 at the paint bench, K12 at
the anisotropic paint's, the tSZ table as both curves):
  kernel       the kernel as it stands: a warp a tile, 2 slots a thread,
               halos staged 16 a chunk, sincosf, a slot's row by a float
               reciprocal
  tw2, tw8     2 or 8 warps a tile (8: the whole 16 x 32 tile in one pass,
               a block barrier between staging and the pairs)
  slots1, slots4  1 or 4 slots a thread
  chunk64      halos staged 64 a chunk (more shared memory a block)
  zero_div     the zero blocks' elements in one loop, the tile of each by
               an integer division
  zero_vec     the zero blocks' stores 16 bytes each (every tile here is
               a multiple of 16 bytes)
  vec_out      a slot's two values by one 8-byte (16-byte) store
  the next three, and zero_div, zero_vec and vec_out above, are held equal
  to the kernel's results bit for bit:
  unroll2      the halo loop unrolled by 2
  int_div      a slot's row and column by integer division
  sin_cos      the slot's sin and cos of d/2 by sinf and cosf
  timing only, each leaving out a part of the work:
  no_row_trig  each row's float64 ring_theta, sin and cos (a stand-in
               instead), which bounds what a per-NSIDE table of those
               values could save
  no_rows      the rows' values altogether
  no_slot_geometry  each slot's geometry (a stand-in from its row)
  no_stage     the staging of the halos
  no_zero      the zero blocks (untouched tiles not written)
  no_pairs     the pair loop (the per-tile work alone)
disc_paint.cu (K11 at the paint bench):
  l1           the kernel as it stands: the halo's curve read through L1
  staged       the curve staged a warp in shared memory (n_r <= 64)
regrid.cu (K3 at the shell bench: K2's offsets, the float32 map):
  kernel       the kernel as it stands: the init launch writes the unmoved
               pixels' values, each tile's list of moved pixels and the
               ring table; the move launch a thread a listed pixel, the
               rings from the table
  timing only:
  no_move      no move launch (the init launch alone)
  init_plain   no move launch, and the init launch writes no list
  move_list    the move launch reads its list and finds the entries'
               rings, then stores one value each
  move_gathers the same, with each entry's offsets and value read
  no_geometry  the 4 neighbours and weights a stand-in (p, p + 1 and the
               next ring's), the atomics kept
  no_atomics   the shares stored, not added (a plain store each)
curves.cu (K1 at the shell bench, the S19 table in float32; the wrapper
called on float32 halo columns on the card and on the device alone, then
the runner's call (its float64 columns on the card), a call from host
columns and the wrapper's host parts apart):
  kernel       the kernel as it stands: a warp a halo, 8 a block, the
               corners' weights and offsets in shared memory, 8 rows loaded
               before they are summed
  timing only:
  no_search    the axes' bisections a stand-in
  no_corners   the corner rows' reads left out

calls (the package of --tree; the shell runner on the scatter path at
the bench, float32; CUDA events, the mean of 50 calls, in turns):
  halo columns to curves   _halo_tensors then _halo_curves, as the tree's
                           process() calls them (from its host halo data)
  _halo_curves from host arrays   the runner's K1 call given the host halo
                           data (the call both trees can make)
  K3 regrid                the wrapper on K2's offsets at the bench
  and the medians of 8 process() calls' host_prep and curves phases.

The last lines are one JSON object of the readings (ms) and the card's
nvidia-smi name and power limit.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import chip_smoke as cs

def _const(name, value, new):
    return (f"constexpr int {name} = {value};",
            f"constexpr int {name} = {new};")


VARIANTS = {
    "tile_deposit.cu": {
        "kernel": [],
        "tw2": [_const("kTileWarps", 1, 2)],
        "tw8": [_const("kTileWarps", 1, 8)],
        "slots1": [_const("kSlots", 2, 1)],
        "slots4": [_const("kSlots", 2, 4)],
        "chunk64": [_const("kChunk", 16, 64)],
        "zero_div": [(
            "  for (int k = 0; k < nt; ++k) {\n"
            "    if (touched >> k & 1u) continue;\n"
            "    T* tile = acc + (long long)(t0 + k) * per_tile;\n"
            "    for (int e = threadIdx.x; e < per_tile; e += blockDim.x) "
            "tile[e] = T(0);\n  }\n",
            "  T* base = acc + (long long)t0 * per_tile;\n"
            "  for (int e = threadIdx.x; e < nt * per_tile; e += blockDim.x)\n"
            "    if (!(touched >> (e / per_tile) & 1u)) base[e] = T(0);\n")],
        "zero_vec": [(
            "    for (int e = threadIdx.x; e < per_tile; e += blockDim.x) "
            "tile[e] = T(0);\n",
            "    for (int e = threadIdx.x; e < per_tile * int(sizeof(T)) / 16;"
            "\n         e += blockDim.x)\n"
            "      reinterpret_cast<uint4*>(tile)[e] = make_uint4(0, 0, 0, 0);"
            "\n")],
        "vec_out": [(
            "        T* out = acc + ((long long)t * P + slot) * 2;\n"
            "        out[0] = o0;\n"
            "        out[1] = o1;\n",
            "        T* out = acc + ((long long)t * P + slot) * 2;\n"
            "        if constexpr (sizeof(T) == 4)\n"
            "          *reinterpret_cast<float2*>(out) = make_float2(o0, o1);\n"
            "        else\n"
            "          *reinterpret_cast<double2*>(out) = make_double2(o0, o1);"
            "\n")],
        "unroll2": [("      for (int k = 0; k < nh; ++k) {",
                     "#pragma unroll 2\n      for (int k = 0; k < nh; ++k) {")],
        "int_div": [("      const int u = int((float(sl) + 0.5f) * inv_K);\n"
                     "      slot_geometry<T>(rows[u], sl - u * tl.K, csc[4], "
                     "sphc, cphc, q[j]);\n",
                     "      slot_geometry<T>(rows[sl / tl.K], sl % tl.K, "
                     "csc[4], sphc, cphc, q[j]);\n")],
        "sin_cos": [("  T s2, c2;\n  m_sincos(T(0.5) * d32, s2, c2);\n",
                     "  const T s2 = bf::m_sin(T(0.5) * d32);\n"
                     "  const T c2 = bf::m_cos(T(0.5) * d32);\n")],
        "no_row_trig": [(
            "  const double theta_r = bf::ring_theta<double>(tl.N, g.i_c);\n"
            "  const double sth_r = sin(theta_r), cth_r = cos(theta_r);\n",
            "  const double sth_r = double(g.i_c) * 7.7e-4;\n"
            "  const double cth_r = 1.0 - sth_r;\n")],
        "no_rows": [("    for (int u = lane; u < tl.RB; u += 32)\n"
                     "      rows[u] = row_geometry<T>(tl, t, u, csc);\n",
                     "    ;\n")],
        "no_slot_geometry": [(
            "      slot_geometry<T>(rows[u], sl - u * tl.K, csc[4], sphc, cphc,"
            " q[j]);\n",
            "      q[j] = Slot<T>{rows[u].dsin, T(sl), T(0), T(1), T(0), T(0), "
            "T(0), T(1), T(0), T(0), T(0), true};\n")],
        "no_stage": [("  if (one_chunk) stage(first, last - first, n_warps > 1"
                      " ? 1 : 0);\n", "")],
        "no_zero": [("  const int blocks = n_touched + (n_tiles + kZeroTiles"
                     " - 1) / kZeroTiles;", "  const int blocks = n_touched;")],
        "no_pairs": [("      for (int k = 0; k < nh; ++k) {",
                      "      for (int k = 0; k < nh * 0; ++k) {")],
    },
    "disc_paint.cu": {
        "l1": [],
        "staged": [(
            "                  Paint<T> pt, A* __restrict__ acc) {\n"
            "  __shared__ bf::FlatDiscs<T, kWarps> s;\n",
            "                  Paint<T> pt, A* __restrict__ acc) {\n"
            "  __shared__ bf::FlatDiscs<T, kWarps> s;\n"
            "  __shared__ T sh_curve[kWarps][64];\n"), (
            "        const PaintHalo<T> h = halo(hid);\n"
            "        bf::warp_walk(walk, rings, first,\n",
            "        PaintHalo<T> h = halo(hid);\n"
            "        if (pt.n_r <= 64) {\n"
            "          T* c = sh_curve[threadIdx.x >> 5];\n"
            "          for (int k = threadIdx.x & 31; k < pt.n_r; k += 32)\n"
            "            c[k] = h.curve[k];\n"
            "          __syncwarp();\n"
            "          h.curve = c;\n"
            "        }\n"
            "        bf::warp_walk(walk, rings, first,\n")],
    },
}
_REGRID_MOVE = ("  regrid_move_kernel<P, T><<<tiles, kThreads, 0, s>>>(nside, po, "
                "orig, moved,\n" + " " * 54 + "counts, rt, out);\n")
_REGRID_SHARES = (
    "    moved_shares<P, T>(N, p, o0, o1, src, k, rings, pix, v);\n"
    "#pragma unroll\n"
    "    for (int q = 0; q < 4; ++q) atomicAdd(out + pix[q], v[q]);\n")
_REGRID_STORE = "    out[p] = src + T(o0) + T(o1) + T(k);\n"
VARIANTS["regrid.cu"] = {
    "kernel": [],
    "no_move": [(_REGRID_MOVE, "")],
    "init_plain": [(_REGRID_MOVE, ""),
                   ("    if (m[j]) moved[at++] = p0 + j;\n", "    ;\n")],
    "move_list": [(_REGRID_SHARES, _REGRID_STORE), (
        "    if (live) {\n"
        "      load_pair(po, p, o0, o1);\n"
        "      src = orig[p];\n"
        "    }\n", "")],
    "move_gathers": [(_REGRID_SHARES, _REGRID_STORE)],
    "no_geometry": [(
        "  bf::displaced_weights<T>(N, row.theta, phi_p, row.sin_safe, T(o0), "
        "T(o1),\n"
        "                           TableRings<T>{rings}, pix, w);\n",
        "#pragma unroll\n"
        "  for (int q = 0; q < 4; ++q) {\n"
        "    pix[q] = min(p + (q & 1) + (q >> 1) * 4 * N, 12 * N * N - 1);\n"
        "    w[q] = T(0.25) + T(0) * (row.theta + phi_p);\n"
        "  }\n")],
    "no_atomics": [(
        "    for (int q = 0; q < 4; ++q) atomicAdd(out + pix[q], v[q]);\n",
        "    for (int q = 0; q < 4; ++q) out[pix[q]] = v[q];\n")],
}
VARIANTS["curves.cu"] = {
    "kernel": [],
    "no_search": [("    idx = bf::clampi(count_le(g, n, x) - 1, 0, n - 2);\n",
                   "    idx = bf::clampi(int(x) & 1, 0, n - 2);\n")],
    "no_corners": [(
        "      for (int j = 0; j < kChunk; ++j) v[j] = at[off_s[warp][c0 + j]];"
        "\n",
        "      for (int j = 0; j < kChunk; ++j) v[j] = T(off_s[warp][c0 + j]);"
        "\n")],
}
_K6_GEO = ("    const int k = blockIdx.x * kThreads + threadIdx.x;\n"
           "    if (k < n_geo) add_source<P, T>(N, sf[k], gpix[k], acc, orig, "
           "rows, out);\n    return;\n")
# K6 as two launches, as K3 is: the
# complement kernel adds the unmoved geometric sources' values by plain
# read-modify-writes and lists each block's moved ones (ballot/popc) in a
# static buffer; a second launch takes the lists, a thread a moved source
_K6_SPLIT = [
    ("// The complement: a thread takes one entry",
     "constexpr int kSplitBlocks = 8192;\n"
     "__device__ int2 g_moved[kSplitBlocks * kThreads];\n"
     "__device__ int g_counts[kSplitBlocks];\n\n"
     "// The complement: a thread takes one entry"),
    (_K6_GEO,
     "    const int k = blockIdx.x * kThreads + threadIdx.x;\n"
     "    int slot = 0, p = 0;\n"
     "    bool m = false;\n"
     "    if (k < n_geo) {\n"
     "      slot = sf[k];\n"
     "      p = gpix[k];\n"
     "      P o0, o1;\n"
     "      load_pair(acc, slot, o0, o1);\n"
     "      if (o0 == P(0) && o1 == P(0)) out[p] += orig[slot];\n"
     "      else m = true;\n"
     "    }\n"
     "    __shared__ int wsum[kThreads / 32];\n"
     "    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
     "    const unsigned b = __ballot_sync(bf::kFullMask, m);\n"
     "    if (lane == 0) wsum[warp] = __popc(b);\n"
     "    __syncthreads();\n"
     "    int at = __popc(b & ((1u << lane) - 1u)), total = 0;\n"
     "    for (int w = 0; w < kThreads / 32; ++w) {\n"
     "      at += w < warp ? wsum[w] : 0;\n"
     "      total += wsum[w];\n"
     "    }\n"
     "    if (m) g_moved[(long long)blockIdx.x * kThreads + at] = "
     "make_int2(slot, p);\n"
     "    if (threadIdx.x == 0) g_counts[blockIdx.x] = total;\n"
     "    return;\n"),
    ("inline int geo_blocks_for(int n_geo) {",
     "template <typename P, typename T>\n"
     "__global__ void __launch_bounds__(kThreads)\n"
     "split_move_kernel(int N, const P* __restrict__ acc,\n"
     "                  const T* __restrict__ orig,\n"
     "                  const RingRow<T>* __restrict__ rows,\n"
     "                  T* __restrict__ out) {\n"
     "  if (int(threadIdx.x) < g_counts[blockIdx.x]) {\n"
     "    const int2 sp = g_moved[(long long)blockIdx.x * kThreads + "
     "threadIdx.x];\n"
     "    P o0, o1;\n"
     "    load_pair(acc, sp.x, o0, o1);\n"
     "    move_source<P, T>(N, sp.y, o0, o1, orig[sp.x], rows, out);\n"
     "  }\n}\n\n"
     "inline int geo_blocks_for(int n_geo) {"),
    ("  if (blocks == 0) return 0;\n",
     "  if (blocks == 0) return 0;\n"
     "  if (geo_blocks > kSplitBlocks) return int(cudaErrorInvalidValue);\n"),
    ("      tile_S, acc, orig, static_cast<const RingRow<T>*>(rows), out);\n"
     "  return int(cudaGetLastError());\n",
     "      tile_S, acc, orig, static_cast<const RingRow<T>*>(rows), out);\n"
     "  const cudaError_t e = cudaGetLastError();\n"
     "  if (e != cudaSuccess || geo_blocks == 0) return int(e);\n"
     "  split_move_kernel<P, T><<<geo_blocks, kThreads, 0, "
     "(cudaStream_t)stream>>>(\n"
     "      nside, acc, orig, static_cast<const RingRow<T>*>(rows), out);\n"
     "  return int(cudaGetLastError());\n")]
# 4 geometric sources a thread (16-byte list reads), their offsets' and
# values' loads issued together, then each handled in turn
_K6_PER4 = [
    (_K6_GEO,
     "    const int k0 = 4 * (blockIdx.x * kThreads + threadIdx.x);\n"
     "    const int mine = bf::clampi(n_geo - k0, 0, 4);\n"
     "    int slot[4], pix[4];\n"
     "    if (mine == 4) {\n"
     "      const int4 a = *reinterpret_cast<const int4*>(sf + k0);\n"
     "      const int4 b = *reinterpret_cast<const int4*>(gpix + k0);\n"
     "      slot[0] = a.x, slot[1] = a.y, slot[2] = a.z, slot[3] = a.w;\n"
     "      pix[0] = b.x, pix[1] = b.y, pix[2] = b.z, pix[3] = b.w;\n"
     "    } else {\n"
     "      for (int q = 0; q < 4; ++q)\n"
     "        if (q < mine) slot[q] = sf[k0 + q], pix[q] = gpix[k0 + q];\n"
     "    }\n"
     "    P o0[4], o1[4];\n"
     "    T v[4];\n"
     "#pragma unroll\n"
     "    for (int q = 0; q < 4; ++q)\n"
     "      if (q < mine) {\n"
     "        load_pair(acc, slot[q], o0[q], o1[q]);\n"
     "        v[q] = orig[slot[q]];\n"
     "      }\n"
     "#pragma unroll\n"
     "    for (int q = 0; q < 4; ++q)\n"
     "      if (q < mine) {\n"
     "        if (o0[q] == P(0) && o1[q] == P(0)) atomicAdd(out + pix[q], "
     "v[q]);\n"
     "        else move_source<P, T>(N, pix[q], o0[q], o1[q], v[q], rows, "
     "out);\n"
     "      }\n"
     "    return;\n"),
    ("  return (n_geo + kThreads - 1) / kThreads;\n",
     "  return (n_geo + 4 * kThreads - 1) / (4 * kThreads);\n")]
VARIANTS["table_rows.cu"] = {
    "kernel": [],
    "empty": [("  extern __shared__ double sh[];\n"
               "  __shared__ double wsum[2][kGroup / 32];\n",
               "  if (n > 0) return;\n"
               "  extern __shared__ double sh[];\n"
               "  __shared__ double wsum[2][kGroup / 32];\n")],
    "no_inversion": [(
        "  invert_row<2 * kGroup>(all, n_r, s, &wcnt[0][0],\n"
        "                         out + (long long)blockIdx.x * n_r);\n",
        "  if (int(threadIdx.x) < n_r)\n"
        "    out[(long long)blockIdx.x * n_r + threadIdx.x] =\n"
        "        s.lo[threadIdx.x] + s.lb[threadIdx.x] + all.t;\n")],
    "no_chain": [(
        "  if (threadIdx.x == 0 || threadIdx.x == 32) {\n"
        "    // keep a candidate",
        "  for (int i = threadIdx.x; i < n; i += G) {\n"
        "    s.mask_b[i] = s.xb[i] > -INFINITY;\n"
        "    s.mask_o[i] = s.xo[i] > -INFINITY;\n  }\n"
        "  if (n < 0) {\n"
        "    // keep a candidate")],
    "no_scan": [("  double s_i = group_prefix<G>(g, part, wsum);\n",
                 "  double s_i = part * 0.0;\n")],
    "group128": [("constexpr int kGroup = 256;", "constexpr int kGroup = 128;")],
}
VARIANTS["stencil_finish.cu"] = {
    "kernel": [],
    "split": _K6_SPLIT,
    "per4": _K6_PER4,
    "float_ring": [(
        "  const int i = bf::pixel_ring(N, p);\n",
        "  int i;\n"
        "  {\n"
        "    const int ncap = 2 * N * (N - 1), npx = 12 * N * N;\n"
        "    if (p < ncap || p >= npx - ncap) {\n"
        "      const int q = p < ncap ? p : npx - 1 - p;\n"
        "      int c = int((1.0f + sqrtf(1.0f + 2.0f * float(q))) * 0.5f);\n"
        "      while (2 * c * (c - 1) > q) --c;\n"
        "      while (2 * c * (c + 1) <= q) ++c;\n"
        "      i = p < ncap ? c : 4 * N - c;\n"
        "    } else {\n"
        "      i = N + (p - ncap) / (4 * N);\n"
        "    }\n"
        "  }\n")],
    "no_table": [("  const RingRow<T> row = rows[4 * N + i];\n",
                  "  const RingRow<T> row = bf::source_ring_row<T>(N, i);\n"),
                 ("                           TableRings<T>{rows}, pix, w);\n",
                  "                           bf::RingAngles<T>{N}, pix, w);\n")],
    "no_phi_div": [("                    (bf::kTwoPi / double(ri.nr)));\n",
                    "                    (bf::kTwoPi * 0.001));\n")],
    "no_geometry": [(
        "  bf::displaced_weights<T>(N, row.theta, phi_p, row.sin_safe, T(o0), "
        "T(o1),\n                           TableRings<T>{rows}, pix, w);\n",
        "#pragma unroll\n"
        "  for (int c = 0; c < 4; ++c) {\n"
        "    pix[c] = min(p + (c & 1) + (c >> 1) * 4 * N, 12 * N * N - 1);\n"
        "    w[c] = T(0.25) + T(0) * (row.theta + phi_p + T(o0) + T(o1));\n"
        "  }\n")],
    "no_moved": [("  else move_source<P, T>(N, p, o0, o1, v, rows, out);\n",
                  "  else out[p] = v;\n")],
}
# the designs of K9 and K6 before their redesign (three launches a
# redshift; a thread a source of a 24-byte list), whose sources only a
# checkout of an earlier commit holds: sections K9p and K6p, run with
# --tree on such a checkout; every variant is timing only
PARENT_VARIANTS = {
    "table_rows.cu": {
        "kernel": [],
        "empty": [
            ("  const int row = blockIdx.x;\n"
             "  const double* f = intgd + (long long)row * n;\n",
             "  if (n > 0) return;\n"
             "  const int row = blockIdx.x;\n"
             "  const double* f = intgd + (long long)row * n;\n"),
            ("  const int row = blockIdx.x;\n"
             "  double* o = out + (long long)row * n;\n",
             "  if (n > 0) return;\n"
             "  const int row = blockIdx.x;\n"
             "  double* o = out + (long long)row * n;\n")],
        "no_simpson": [(
            "  if (threadIdx.x == 0) {\n"
            "    // scipy's cumulative Simpson",
            "  for (int i = threadIdx.x; i < n; i += blockDim.x)\n"
            "    Me[i] = (f[i] + 1.0) * double(i + 1);\n"
            "  if (n < 0) {\n"
            "    // scipy's cumulative Simpson")],
        "no_compact": [(
            "  if (threadIdx.x == 0) {\n    int k = 0;\n",
            "  for (int j = threadIdx.x; j < n; j += blockDim.x) {\n"
            "    xc[j] = x[j];\n    yc[j] = y[j];\n  }\n"
            "  if (threadIdx.x == 0) *nv = n;\n"
            "  if (n < 0) {\n    int k = 0;\n")],
        "no_runmax": [(
            "  if (threadIdx.x == 0) {\n"
            "    // keep a point where it exceeds",
            "  for (int i = threadIdx.x; i < n; i += blockDim.x) {\n"
            "    mask_b[i] = isfinite(lb[i]);\n"
            "    mask_o[i] = isfinite(lo[i]);\n  }\n"
            "  if (n < 0) {\n"
            "    // keep a point where it exceeds")],
        "no_slopes": [("    d[i] = pchip_slope(xc, yc, n, i);\n",
                       "    d[i] = yc[i];\n")],
        "no_eval": [("    out[q] = ok ? hermite(xc, yc, d, n, v) : nan(\"\");\n",
                     "    out[q] = ok ? v : nan(\"\");\n")],
    },
    "stencil_finish.cu": {
        "kernel": [],
        "unmoved_store": [("    atomicAdd(out + self, src);\n",
                           "    out[self] += src;\n")],
        "no_unmoved": [("    atomicAdd(out + self, src);\n",
                        "    (void)self;\n")],
        "no_hot": [("  const long long total = n_geo + (long long)n_hot * RB * K;"
                    "\n", "  const long long total = n_geo;\n"),
                   ("  if (k >= n_geo + (long long)n_hot * PS) return;\n",
                    "  if (k >= n_geo) return;\n")],
        "no_geo_angles": [("    theta_p = gth[k];\n    phi_p = gph[k];\n",
                           "    theta_p = T(0.5) + T(1e-7) * T(self);\n"
                           "    phi_p = T(1);\n")],
        "no_geometry": [(
            "  bf::displaced_weights<T>(N, theta_p, phi_p, T(o0), T(o1), pix, "
            "w);\n",
            "#pragma unroll\n"
            "  for (int c = 0; c < 4; ++c) {\n"
            "    pix[c] = min(self + (c & 1) + (c >> 1) * 4 * N, "
            "12 * N * N - 1);\n"
            "    w[c] = T(0.25) + T(0) * (theta_p + phi_p + T(o0) + T(o1));\n"
            "  }\n")],
        "no_atomics": [(
            "  for (int c = 0; c < 4; ++c) atomicAdd(out + pix[c], w[c] * src);"
            "\n",
            "  for (int c = 0; c < 4; ++c) out[pix[c]] = w[c] * src;\n")],
        "geo_no_rank": [("  for (int uu = 0; uu < u; ++uu) {\n",
                         "  for (int uu = 0; uu < 0; ++uu) {\n")],
    },
}
TIMING_ONLY = {"no_row_trig", "no_rows", "no_slot_geometry", "no_stage",
               "no_zero", "no_pairs", "no_move", "init_plain", "move_list",
               "move_gathers",
               "no_geometry", "no_atomics", "no_search", "no_corners",
               "empty", "no_inversion", "no_chain", "no_scan", "no_phi_div",
               "no_moved"}
# variants whose results must equal the kernel's bit for bit
BITWISE = {"sin_cos", "int_div", "unroll2", "zero_div", "zero_vec",
           "vec_out"}


class _Library:
    """A variant's library, with the build's argument types."""

    def __init__(self, path):
        from baryonforge_torch.ops import _build
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _build._SIGNATURES.items():
            try:
                fn = getattr(self._lib, name)
            except AttributeError:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build_variants(work, sources):
    """Compile every variant of ``sources``, pairs (source, its variants
    as in VARIANTS[source]), into ``work``; returns {(source, variant):
    library path}."""
    from baryonforge_torch.ops import _build
    flags = _build.NVCC_FLAGS
    jobs = {}
    for src, variants in sources:
        text = (_build._CSRC / src).read_text()
        for name, edits in variants.items():
            tag = f"{src[:-3]}_{name}"
            d = os.path.join(work, tag)
            shutil.copytree(_build._CSRC, d)
            body = text
            for old, new in edits:
                if body.count(old) != 1:
                    raise RuntimeError(f"{name}: the text to replace is not "
                                       f"in {src} once: {old!r}")
                body = body.replace(old, new)
            with open(os.path.join(d, src), "w") as f:
                f.write(body)
            out = os.path.join(work, f"lib_{tag}.so")
            jobs[(src, name)] = (out, subprocess.Popen(
                [_build._nvcc()] + flags + ["-Xptxas", "-v", "-o", out,
                                            os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for key, (out, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        paths[key] = out
        # registers and spills of the float kernels the probes time
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+"
                          r"(tile_pairs_kernelIfLi[01]E|disc_paint_kernelIfd"
                          r"|regrid_\w+_kernelIffE|collapse_curves_kernelIfE"
                          r"|stencil_\w+_kernelIf+E|\w+_rows_kernel"
                          r"|enclosed_mass_kernel)",
                          line)
            if "Compiling entry function" in line:
                entry = m.group(1) if m else None
            elif entry and ("spill" in line or "Used" in line):
                cs.log(f"  ptxas [{key[1]}] {entry}: {line.strip()}")
    return paths


def timed_in_turns(torch, fns, reps=20, rounds=2, timer=None):
    """{name: [ms, ...]}: every fn timed forward then back, ``rounds``
    times, by ``timer`` (chip_smoke.time_ms by default)."""
    timer = timer or (lambda fn: cs.time_ms(torch, fn, reps))
    out = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(timer(fns[name]))
    return out


class Bench:
    """The bench inputs every section shares (chip_smoke.py's), made once."""

    def __init__(self, bf, torch):
        self.dev = torch.device(cs.DEVICE)
        self.cosmo = bf.cosmo.cosmology_from_dict(cs.COSMO)
        self.cat, self.shell = cs.bench_inputs(bf, cs.NSIDE, cs.N_HALOS,
                                               cs.SEED)
        self.model = bf.Baryonification2D(
            None, None, self.cosmo, epsilon_max=cs.EPS_MAX).load_table(
                cs.TABLE)
        self.runner = bf.BaryonifyShell(
            self.cat, self.shell, epsilon_max=cs.EPS_MAX, model=self.model,
            dtype=torch.float32, device=self.dev)
        self.hd = self.runner._host_halo_data(self.cosmo)
        self.tsz = cs.tsz_models(bf, bf.utils.TabulatedProfile(
            None, self.cosmo, mass_def=bf.cosmo.MassDef200c).load_table(
                cs.TSZ_TABLE))["log"]


def probe_tile_deposit_paint(bf, torch, b, libs, gpu):
    """K4, K10, K12 (tile_deposit.cu) and K11 (disc_paint.cu)."""
    from baryonforge_torch.ops import _build, paint
    from baryonforge_torch.ops import tile_deposit as td
    dev, cat, shell, tsz = b.dev, b.cat, b.shell, b.tsz
    tiling, csr, pack, r0, inv, _ = cs.tiled_inputs(torch, b.runner, b.hd)
    runner_p = bf.PaintProfilesShell(cat, shell, epsilon_max=cs.PAINT_EPS,
                                     model=tsz, dtype=torch.float32,
                                     device=dev)
    hd_p = runner_p._host_halo_data(b.cosmo)
    curves, pr0, pdl = tsz.with_dtype(torch.float32, device=dev).halo_curves(
        hd_p["M"], hd_p["a"])
    pr0, pdl = float(pr0), float(pdl)
    tiling_p, csr_p, pack_p = runner_p._tile_paint_inputs(
        hd_p, curves, True, cs.NSIDE)
    halos = {k: torch.as_tensor(hd_p[k], device=dev)
             for k in paint.HALO_COLUMNS}
    runner_a = bf.PaintProfilesAnisShell(
        cat, cs.anis_shell(bf, shell), epsilon_max=cs.PAINT_EPS,
        model=tsz, Tracer_model=tsz, Mtot_model=tsz,
        background_val=cs.ANIS_BG, global_tracer_fraction=cs.ANIS_FRAC,
        dtype=torch.float32, device=dev)
    hd_a = runner_a._host_halo_data(b.cosmo)
    c2, r2, d2 = tsz.with_dtype(torch.float64, device=dev).halo_curves(
        hd_a["M"], hd_a["a"])
    second = (c2, float(r2), float(d2), True)
    tiling_a, csr_a, pack_a, grid_a = runner_a._tile_paint2_inputs(
        hd_a, [second, second], cs.NSIDE)
    halos_a = {k: torch.as_tensor(hd_a[k], device=dev)
               for k in paint.HALO_COLUMNS}
    _, marginal_a = paint.float32_tolerance(cs.NSIDE, halos_a, *second,
                                            second=second)

    def k4():
        return td.tile_deposit(tiling, csr, pack, r0, inv)

    def k10():
        return td.tile_paint(tiling_p, csr_p, pack_p, pr0, 1.0 / pdl, True)

    def k12():
        return td.tile_paint2(tiling_a, csr_a, pack_a, *grid_a)

    def k11():
        return paint.disc_paint(cs.NSIDE, halos, curves, pr0, pdl, True,
                                False, torch.float64)

    ap4 = td.tile_deposit_plain(tiling, csr, pack, r0, inv)
    ap10 = td.tile_paint_plain(tiling_p, csr_p, pack_p, pr0, 1.0 / pdl,
                               True)
    ap11 = paint.disc_paint_plain(cs.NSIDE, halos, curves, pr0, pdl,
                                  True, False, torch.float64)
    ap12 = td.tile_paint2_plain(tiling_a, csr_a, pack_a, *grid_a)
    rtol, marginal = paint.float32_tolerance(cs.NSIDE, halos, curves,
                                             pr0, pdl, True)
    _build._lib = libs[("tile_deposit.cu", "kernel")]
    base = (k4(), k10(), k12())
    results = {}
    for kernels, src in (((("K4", k4), ("K10", k10), ("K12", k12)),
                          "tile_deposit.cu"),
                         ((("K11", k11),), "disc_paint.cu")):
        names = list(VARIANTS[src])
        for name in names:
            if name in TIMING_ONLY:
                continue
            _build._lib = libs[(src, name)]
            if kernels[0][0] == "K4":
                ak, a10, a12 = k4(), k10(), k12()
                diff = (ak - ap4).abs()
                scale = ap4.abs().max().item()
                cs.check(f"K4 [{name}]", diff.max().item(), 0.02 * scale)
                cs.check(f"K4 summed [{name}]", diff.sum().item(),
                         3e-3 * ap4.abs().sum().item())
                cs.paint_f32_check(f"K10 [{name}]",
                                   tiling_p.flat_view_plain(a10),
                                   tiling_p.flat_view_plain(ap10),
                                   torch.full_like(rtol, 1e-4), marginal)
                cs.paint_f32_check(f"K12 [{name}]",
                                   tiling_a.flat_view_plain(a12),
                                   tiling_a.flat_view_plain(ap12),
                                   torch.full_like(rtol, 1e-4), marginal_a)
                if name in BITWISE:
                    same = all(torch.equal(x.view(torch.int32),
                                           y.view(torch.int32))
                               for x, y in zip((ak, a10, a12), base))
                    cs.log(f"  K4, K10, K12 [{name}] bitwise the kernel's: "
                           f"{same}")
                    if not same:
                        raise AssertionError(f"{name}: results differ from "
                                             "the kernel's")
            else:
                cs.paint_f32_check(f"K11 [{name}]", k11(), ap11, rtol,
                                   marginal)
        for kname, fn in kernels:
            fns = {}
            for name in names:
                def run(lib=libs[(src, name)], fn=fn):
                    _build._lib = lib
                    return fn()
                fns[name] = run
            results[kname] = report(gpu, kname, timed_in_turns(torch, fns))
    return results


def report(gpu, kname, got, label=""):
    for name, ms in got.items():
        cs.log(f"[{gpu}] {kname}{label} {name}: "
               + ", ".join(f"{t:.4f}" for t in ms) + " ms")
    return got


def probe_regrid(bf, torch, b, libs, gpu):
    """K3 (regrid.cu) on the scatter path's bench inputs: the offsets of
    K2 at the bench, the float32 map."""
    from baryonforge_torch.ops import _build, deposit, regrid
    dev, nside = b.dev, cs.NSIDE
    m = b.model.with_dtype(torch.float32, device=dev)
    curves, r0, dl = m.halo_curves(b.hd["M"], b.hd["a"])
    po = deposit.disc_deposit(nside, b.runner._halo_tensors(b.hd), curves,
                              r0, dl, cs.EPS_MAX)
    orig = torch.as_tensor(b.shell.map, device=dev).to(torch.float32)
    plain = regrid.regrid_plain(nside, po, orig)
    tol = 1e-6 * nside * orig.abs().max().item()
    moved = ~(po == 0).all(1)
    cs.log(f"  K3 at the bench: {int(moved.sum())} of {moved.numel()} "
           f"pixels moved")
    names = list(VARIANTS["regrid.cu"])
    for name in names:
        if name in TIMING_ONLY:
            continue
        _build._lib = libs[("regrid.cu", name)]
        got = regrid.regrid(nside, po, orig)
        cs.check(f"K3 [{name}]", (got - plain).abs().max().item(), tol)
        dm = abs(got.double().sum().item() / orig.double().sum().item() - 1)
        cs.check(f"K3 mass [{name}]", dm, 1e-5)
    fns = {}
    for name in names:
        def run(lib=libs[("regrid.cu", name)]):
            _build._lib = lib
            return regrid.regrid(nside, po, orig)
        fns[name] = run
    return {"K3": report(gpu, "K3", timed_in_turns(torch, fns)),
            "K3 alone": report(gpu, "K3", timed_in_turns(
                torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
                " (device alone)")}


def probe_curves(bf, torch, b, libs, gpu):
    """K1 (curves.cu) at the bench (18,512 halos, the S19 table in
    float32): the variants by wrapper call on the card's halo columns and
    on the device alone, then the wrapper's host parts apart."""
    import numpy as np
    from baryonforge_torch.ops import _build, interp
    dev = b.dev
    m = b.model.with_dtype(torch.float32, device=dev)
    M, a = b.hd["M"], b.hd["a"]
    M_d = torch.as_tensor(M, dtype=torch.float32, device=dev)
    a_d = torch.as_tensor(a, dtype=torch.float32, device=dev)
    plain = interp.collapse_curves_plain(m._table, m._axes, 2, M, a, [],
                                         {})[0]
    tol = 1e-6 * plain.abs().max().item()
    names = list(VARIANTS["curves.cu"])
    tables = {}
    for name in names:
        _build._lib = libs[("curves.cu", name)]
        tables[name] = interp.CurveTable(m._table, m._axes, 2, [])
        if name in TIMING_ONLY:
            continue
        got = tables[name].collapse(M_d, a_d, {})[0]
        cs.check(f"K1 [{name}]", (got - plain).abs().max().item(), tol)
    _build._lib = None
    fns = {name: (lambda ct=ct: ct.collapse(M_d, a_d, {}))
           for name, ct in tables.items()}
    out = {"K1": report(gpu, "K1", timed_in_turns(torch, fns), " (columns "
                        "on the card)"),
           "K1 alone": report(gpu, "K1", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)")}
    ct = tables["kernel"]
    M64, a64 = np.asarray(M, np.float64), np.asarray(a, np.float64)
    out_pre = torch.empty((len(M), m._table.shape[2]), device=dev)
    # a set-up of its own for the launch alone, its columns the card's
    ct_launch = interp.CurveTable(m._table, m._axes, 2, [])
    ct_launch.collapse(M_d, a_d, {})
    runner_s = bf.BaryonifyShell(b.cat, b.shell, epsilon_max=cs.EPS_MAX,
                                 model=b.model, deposit="scatter",
                                 regrid="scatter", device=dev)
    halos_s = runner_s._halo_tensors(b.hd)
    pinned = torch.empty((2, len(M)), dtype=torch.float64, pin_memory=True)

    def to_pinned():
        staged = pinned.numpy()
        staged[0] = a64
        staged[1] = M64

    parts = {
        "the scatter runner's _halo_curves":
            lambda: runner_s._halo_curves(halos_s),
        "the runner's float64 columns on the card":
            lambda: m.halo_curves(halos_s["M"], halos_s["a"]),
        "host columns": lambda: m.halo_curves(M, a),
        "with_dtype (the kept casts)":
            lambda: b.model.with_dtype(torch.float32, device=dev),
        "float32 columns on the card": lambda: ct.collapse(M_d, a_d, {}),
        "host columns staged and copied": lambda: ct._upload(
            [(0, a64), (1, M64)], len(M)),
        "columns into pinned memory": to_pinned,
        "asynchronous copy from pinned memory":
            lambda: pinned.to(dev, non_blocking=True),
        "output allocation": lambda: torch.empty_like(out_pre),
        "launch alone": lambda: ct_launch._launch(len(M), 0.0, out_pre),
    }
    out["K1 host"] = report(gpu, "K1", timed_in_turns(torch, parts, reps=50),
                            " host part")
    return out


def probe_calls(bf, torch, b, libs, gpu):
    """K1 and K3 as the scatter shell runner calls them, with the package
    that was imported (see the module docstring)."""
    import inspect
    import numpy as np
    from baryonforge_torch.ops import deposit, regrid
    dev, hd = b.dev, b.hd
    r = bf.BaryonifyShell(b.cat, b.shell, epsilon_max=cs.EPS_MAX,
                          model=b.model, deposit="scatter", regrid="scatter",
                          device=dev)
    # a tree whose runner hands K1 its columns on the card
    on_card = "halos" in inspect.signature(r._halo_curves).parameters

    def columns_to_curves():
        halos = r._halo_tensors(hd)
        return r._halo_curves(halos if on_card else hd)

    halos = r._halo_tensors(hd)
    curves, r0, dl = r._halo_curves(halos if on_card else hd)
    po = deposit.disc_deposit(cs.NSIDE, halos, curves, float(r0), float(dl),
                              cs.EPS_MAX)
    orig = torch.as_tensor(b.shell.map, device=dev).to(torch.float32)
    fns = {"halo columns to curves": columns_to_curves,
           "_halo_curves from host arrays": lambda: r._halo_curves(hd),
           "K3 regrid": lambda: regrid.regrid(cs.NSIDE, po, orig)}
    out = {"calls": report(gpu, "calls", timed_in_turns(torch, fns,
                                                        reps=50))}
    phases = []
    r.process()
    for _ in range(8):
        r.process()
        phases.append(dict(r.timings))
    med = {k: float(np.median([t[k] for t in phases]))
           for k in ("host_prep", "curves", "regrid")}
    cs.log(f"[{gpu}] calls process() phases, medians of 8: "
           + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items()))
    out["calls phases"] = med
    return out


def k6_inputs(torch, b):
    """K6's inputs at the shell bench as the tiled engine's regrid gets
    them, float32 offsets and map: the tiling, its stencil tables, K4's
    offsets, the tiled map, the stencil's output in ring order and the hot
    tiles."""
    from baryonforge_torch.ops import stencil as st
    from baryonforge_torch.ops import tile_deposit as td
    tiling, csr, pack, r0, inv, _ = cs.tiled_inputs(torch, b.runner, b.hd)
    acc = td.tile_deposit(tiling, csr, pack, r0, inv)
    tables = b.runner._stencil_tables(cs.NSIDE)
    orig = torch.as_tensor(b.shell.map, device=b.dev).to(torch.float32)
    og = tiling.tile_view(orig)
    excl = st.hot_tiles(acc, tables)
    base = tiling.flat_view(st.stencil_regrid(tiling, tables, acc, og, excl))
    hot = torch.nonzero(excl & ~tables["D_geom"])[:, 0].to(torch.int32)
    return tiling, tables, acc, og, base, hot


def k6_sources(torch, tiling, tables, acc, hot):
    """The complement's sources at these offsets: geometric ones, those of
    them that move, the hot tiles' valid slots and those that move."""
    from baryonforge_torch.ops.tiles import valid_slot_counts
    import numpy as np
    po = acc.reshape(-1, 2)
    P = tiling.P
    moved = ~(po == 0).all(1)
    g = tables["g_tids"].long()
    geo = (g[:, None] * P + torch.arange(P, device=g.device)).reshape(-1)
    arr = tiling.device_arrays(acc.device)
    valid = tiling.slot_pix(arr["tile_i0"][g], arr["tile_s"][g],
                            arr["tile_S"][g])[1].reshape(-1)
    geo = geo[valid]
    h = hot.long()
    hs = (h[:, None] * P + torch.arange(P, device=h.device)).reshape(-1)
    hvalid = tiling.slot_pix(arr["tile_i0"][h], arr["tile_s"][h],
                             arr["tile_S"][h])[1].reshape(-1)
    hs = hs[hvalid]
    counts = valid_slot_counts(tiling, hot.cpu().numpy())
    assert int(np.sum(counts)) == hs.numel()
    return dict(geo=geo.numel(), geo_moved=int(moved[geo].sum()),
                hot_tiles=h.numel(), hot_slots=h.numel() * P,
                hot_valid=hs.numel(), hot_moved=int(moved[hs].sum()))


def probe_table_rows_parent(bf, torch, b, libs, gpu):
    """K9 of the parent design (three launches a redshift: two
    enclosed_mass, one displacement_rows) at the bench table's first
    redshift: variants leaving parts out, by wrapper call and on the
    device alone, the entries apart and the wrappers' torch operations."""
    from baryonforge_torch.ops import _build, table_rows
    ins, lnr_int, lnr = cs.k9_inputs(bf, torch)

    def redshift():
        ms = [table_rows.enclosed_mass(i, d, lnr_int, lnr) for i, d in ins]
        return table_rows.displacement_rows(lnr, *ms)

    names = list(PARENT_VARIANTS["table_rows.cu"])
    fns = {}
    for name in names:
        def run(lib=libs[("table_rows.cu", name)]):
            _build._lib = lib
            return redshift()
        fns[name] = run
    out = {"K9p": report(gpu, "K9p", timed_in_turns(torch, fns)),
           "K9p alone": report(gpu, "K9p", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)")}
    _build._lib = libs[("table_rows.cu", "kernel")]
    masses = [table_rows.enclosed_mass_plain(i, d, lnr_int, lnr)
              for i, d in ins]
    parts = {"enclosed_mass": lambda: table_rows.enclosed_mass(
                 *ins[0], lnr_int, lnr),
             "displacement_rows": lambda: table_rows.displacement_rows(
                 lnr, *masses),
             "its torch operations (exp, 2 log)": lambda: (
                 torch.exp(lnr), torch.log(masses[0]).contiguous(),
                 torch.log(masses[1]).contiguous())}
    out["K9p parts"] = report(gpu, "K9p", timed_in_turns(torch, parts),
                              " part")
    out["K9p parts alone"] = report(gpu, "K9p", timed_in_turns(
        torch, parts, timer=lambda fn: cs.graph_ms(torch, fn)),
        " part (device alone)")
    _build._lib = None
    return out


def probe_stencil_finish_parent(bf, torch, b, libs, gpu):
    """K6 of the parent design (a thread a source, the geometric list
    with each source's theta and phi, the hot tiles' every slot, an
    atomic a share) at the shell bench: variants leaving parts out, by
    wrapper call (in place on one map, as the engine calls it) and on the
    device alone; the source list; the moved sources counted."""
    from baryonforge_torch.ops import _build
    from baryonforge_torch.ops import stencil as st
    tiling, tables, acc, og, base, hot = k6_inputs(torch, b)
    _build._lib = libs[("stencil_finish.cu", "kernel")]
    geo = st.stencil_geo(tiling, tables, torch.float32)
    src = k6_sources(torch, tiling, tables, acc, hot)
    cs.log(f"  K6 at the bench: {src}")
    out_map = base.clone()
    names = list(PARENT_VARIANTS["stencil_finish.cu"])
    fns, geo_fns = {}, {}
    for name in names:
        lib = libs[("stencil_finish.cu", name)]
        if name.startswith("geo_"):
            def run(lib=lib):
                _build._lib = lib
                return st.stencil_geo(tiling, tables, torch.float32)
            geo_fns[name] = run
            continue

        def run(lib=lib):
            _build._lib = lib
            return st.stencil_complement(tiling, out_map, acc, og, geo, hot)
        fns[name] = run

    def geo_kernel(lib=libs[("stencil_finish.cu", "kernel")]):
        _build._lib = lib
        return st.stencil_geo(tiling, tables, torch.float32)
    geo_fns["kernel"] = geo_kernel
    fns["the map's clone (held by chip_smoke's earlier K6 timing)"] = \
        lambda: base.clone()
    out = {"K6p": report(gpu, "K6p", timed_in_turns(torch, fns)),
           "K6p alone": report(gpu, "K6p", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)"),
           "K6p geo": report(gpu, "K6p stencil_geo", timed_in_turns(
               torch, geo_fns, reps=5)),
           "K6p sources": src}
    _build._lib = None
    return out


def probe_table_rows(bf, torch, b, libs, gpu):
    """K9 (table_rows.cu) at the bench table's first redshift: the fused
    launch's variants by wrapper call and on the device alone (the
    variant "empty", a launch whose body returns at once, is the launch
    floor), each variant that keeps the results held against the plain
    version first."""
    from baryonforge_torch.ops import _build, table_rows
    ins, lnr_int, lnr = cs.k9_inputs(bf, torch)
    args = (*ins[0], *ins[1], lnr_int, lnr)
    plain = table_rows.displacement_table_plain(*args)
    scale = plain.nan_to_num().abs().max().item()
    names = list(VARIANTS["table_rows.cu"])
    fns = {}
    for name in names:
        lib = libs[("table_rows.cu", name)]
        if name not in TIMING_ONLY:
            _build._lib = lib
            got = table_rows.displacement_table(*args)
            if not torch.equal(torch.isnan(got), torch.isnan(plain)):
                raise AssertionError(f"K9 [{name}]: NaN masks differ")
            cs.check(f"K9 [{name}]", (got - plain).abs().nan_to_num().max()
                     .item(), 1e-12 * scale)

        def run(lib=lib):
            _build._lib = lib
            return table_rows.displacement_table(*args)
        fns[name] = run
    out = {"K9": report(gpu, "K9", timed_in_turns(torch, fns)),
           "K9 alone": report(gpu, "K9", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)")}
    _build._lib = None
    return out


def probe_stencil_finish(bf, torch, b, libs, gpu):
    """K6 (stencil_finish.cu) at the shell bench: the complement's
    variants (two launches or one; the unmoved sources' add plain or
    atomic) by wrapper call, in place on one map as the engine calls it,
    and on the device alone, each variant that keeps the results held
    against the plain version first; the source list by wrapper call."""
    from baryonforge_torch.ops import _build
    from baryonforge_torch.ops import stencil as st
    tiling, tables, acc, og, base, hot = k6_inputs(torch, b)
    geo = st.stencil_geo(tiling, tables, torch.float32)
    plain = st.stencil_complement_plain(tiling, base.clone(), acc, og, geo,
                                        hot)
    tol = 1e-6 * cs.NSIDE * og.abs().max().item()
    out_map = base.clone()
    names = list(VARIANTS["stencil_finish.cu"])
    fns = {}
    for name in names:
        lib = libs[("stencil_finish.cu", name)]
        if name not in TIMING_ONLY:
            _build._lib = lib
            got = st.stencil_complement(tiling, base.clone(), acc, og, geo,
                                        hot)
            cs.check(f"K6 [{name}]", (got - plain).abs().max().item(), tol)

        def run(lib=lib):
            _build._lib = lib
            return st.stencil_complement(tiling, out_map, acc, og, geo, hot)
        fns[name] = run

    def geo_call(lib=libs[("stencil_finish.cu", "kernel")]):
        _build._lib = lib
        return st.stencil_geo(tiling, tables, torch.float32)
    out = {"K6": report(gpu, "K6", timed_in_turns(torch, fns)),
           "K6 alone": report(gpu, "K6", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)"),
           "K6 geo": report(gpu, "K6 stencil_geo", timed_in_turns(
               torch, {"kernel": geo_call}, reps=20)),
           "K6 geo alone": report(gpu, "K6 stencil_geo", timed_in_turns(
               torch, {"kernel": geo_call},
               timer=lambda fn: cs.graph_ms(torch, fn)), " (device alone)")}
    _build._lib = None
    return out


def probe_rows(bf, torch, b, libs, gpu):
    """K9 and K6 as the table build and the tiled engine call them, with
    the package that was imported (see the module docstring): K9 one
    redshift's rows, K6's complement (in place on one map) by wrapper call
    and on the device alone, K6's source list by wrapper call."""
    from baryonforge_torch.ops import stencil as st
    from baryonforge_torch.ops import table_rows
    ins, lnr_int, lnr = cs.k9_inputs(bf, torch)
    if hasattr(table_rows, "displacement_table"):
        def k9():
            return table_rows.displacement_table(*ins[0], *ins[1], lnr_int,
                                                 lnr)
    else:
        def k9():
            ms = [table_rows.enclosed_mass(i, d, lnr_int, lnr)
                  for i, d in ins]
            return table_rows.displacement_rows(lnr, *ms)
    tiling, tables, acc, og, base, hot = k6_inputs(torch, b)
    geo = st.stencil_geo(tiling, tables, torch.float32)
    out_map = base.clone()
    fns = {"K9 a redshift": k9,
           "K6 complement": lambda: st.stencil_complement(
               tiling, out_map, acc, og, geo, hot)}
    out = {"rows": report(gpu, "rows", timed_in_turns(torch, fns, reps=50)),
           "rows alone": report(gpu, "rows", timed_in_turns(
               torch, fns, timer=lambda fn: cs.graph_ms(torch, fn)),
               " (device alone)"),
           "rows geo": report(gpu, "rows", timed_in_turns(
               torch, {"K6 stencil_geo": lambda: st.stencil_geo(
                   tiling, tables, torch.float32)}, reps=5))}
    return out


SECTIONS = {"K4": (("tile_deposit.cu", "disc_paint.cu"),
                   probe_tile_deposit_paint),
            "K3": (("regrid.cu",), probe_regrid),
            "K1": (("curves.cu",), probe_curves),
            "K9": (("table_rows.cu",), probe_table_rows),
            "K6": (("stencil_finish.cu",), probe_stencil_finish),
            "calls": ((), probe_calls),
            "rows": ((), probe_rows),
            "K9p": (("table_rows.cu",), probe_table_rows_parent,
                    PARENT_VARIANTS),
            "K6p": (("stencil_finish.cu",), probe_stencil_finish_parent,
                    PARENT_VARIANTS)}


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--tree"]:
        sys.path.insert(0, os.path.abspath(argv[1]))
        argv = argv[2:]
    import baryonforge_torch as bf
    from baryonforge_torch.ops import _build
    cs.log(f"baryonforge_torch from {os.path.dirname(bf.__file__)}")
    want = argv or [k for k in SECTIONS
                    if k not in ("calls", "rows", "K9p", "K6p")]
    if not set(want) <= set(SECTIONS):
        print(f"chip_probes: sections are {list(SECTIONS)}", file=sys.stderr)
        return 2
    gpu = cs.gpu_line()
    cs.log(gpu)
    results = {}
    with tempfile.TemporaryDirectory() as work:
        sources = [(src, (SECTIONS[k][2] if len(SECTIONS[k]) > 2
                          else VARIANTS)[src])
                   for k in want for src in SECTIONS[k][0]]
        libs = {k: _Library(p)
                for k, p in build_variants(work, sources).items()}
        b = Bench(bf, torch)
        for k in want:
            results.update(SECTIONS[k][1](bf, torch, b, libs, gpu))
        _build._lib = None
    cs.log(gpu)
    print(json.dumps({"probes": results, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
