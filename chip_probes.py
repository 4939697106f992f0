"""Design probes of kernels K4 (tile deposit), K10 and K12 (tile paint and
paint2, K4's template in its paint modes), K11 (disc paint), K3 (scatter
regrid), K1 (curve collapse), K9, K6, K20-K23 (the shell, grid and
snapshot direct readout) on the card, at the bench inputs of
chip_smoke.py.

    python3 chip_probes.py [K4] [K3] [K1] [K22] [K23] [K21]  # builds included
    python3 chip_probes.py --tree DIR calls
    python3 chip_probes.py --tree DIR direct
    python3 chip_probes.py --tree DIR K20

With no argument it runs the variant sections: K4 (tile_deposit.cu with
K10, K12, and disc_paint.cu), K3 (regrid.cu), K1 (curves.cu), K9
(table_rows.cu), K6 (stencil_finish.cu), K22 (grid_cutout.cu), K23
(snapshot.cu) and K21 (disc_direct.cu). The
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

grid_cutout.cu (K22's apply at the 3D ΔP(k) baryonify's largest size
bucket, float32 offsets, random values: its first readout chunk and its
first apply group; then K22's radii on the group):
  kernel       the tile body as it stands, a persistent grid over the
               touched tiles, a block taking the next from a counter, 3
               blocks of 512 threads an SM in 3D
  stride       held equal to the kernel's results bit for bit: block b
               takes the touched tiles b, b + its grid's size, ...
  fast_div     held equal to the kernel's results bit for bit: T(g / r)
               for float T from g times one reciprocal of r, the division
               taken where that lies within 8 ulps of a float rounding
               midpoint
  occ2, occ4   held equal to the kernel's results bit for bit: the
               apply's registers uncapped (2 blocks of 512 threads an SM
               in 3D, the grouped apply's first design), or capped so
               that 4 fit (8 of 256 in 2D)
  timing only: no_div (the divisions by r and res made products),
  no_vals (a stand-in for each value), no_sqrt (r2 for r)
snapshot.cu (K23 at the snapshot bench, float32, random values):
  kernel       the radii pass (a warp a piece) and the gather (a warp 32
               particles) as they stand
  radii_unroll held equal to the plain version: the radii loop unrolled 4
               times
  timing only: radii_no_coords, gather_no_coords (a stand-in for each
  position read), gather_no_vals (a stand-in for each value)

disc_direct.cu (K21 at the bench shell, displacement, float32, on K20's
rows and random values; each variant that keeps the results held to the
plain version first; also the wrapper's memset of the accumulator alone,
and every entry on the device alone, a CUDA graph of 20):
  kernel       a thread a slot, the two tangent components by one float2
               atomic (sm_90)
  slots4       4 consecutive slots a thread
  scalar       two scalar atomics, as before the redesign
  timing only: no_atomics (plain stores), no_geo (a stand-in for the
  geometry reads), no_halo (a stand-in for the halo's a)
  and K20's layout pass alone (a CUDA graph of 20) on the bench's row
  counts, each variant held equal to the kernel's layout bit for bit:
  kernel (one block of 32 warps, 4 halos a lane a chunk, the class peers
  by __match_any_sync), ballot (the peers by 7 ballots), lane16 (16
  halos a lane)
  K21p (PARENT_VARIANTS, with --tree on a checkout of the commit before
  the redesign): kernel (two scalar atomics), vec2 (one float2 atomic),
  no_atomics, no_geo, no_halo.

K20 (the package of --tree; K20 at the bench shell, displacement,
float32, split into its parts: each by call, the mean of 20 in turns, and
those on the device only alone, a CUDA graph of 20): with the layout
formed on the card, the count launch, the layout launch, the class
counts' copy, the rows' allocation (torch.empty), the write launch, the
host's groups (cut while the write pass runs) and the three launches
together; with the host layout of the commit before, the count launch,
the counts' copy and the host row_layout, the slot fills, the upload of
base, the write launch and the device's three steps together.

calls (the package of --tree; the shell runner on the scatter path at
the bench, float32; CUDA events, the mean of 50 calls, in turns):
  halo columns to curves   _halo_tensors then _halo_curves, as the tree's
                           process() calls them (from its host halo data)
  _halo_curves from host arrays   the runner's K1 call given the host halo
                           data (the call both trees can make)
  K3 regrid                the wrapper on K2's offsets at the bench
  and the medians of 8 process() calls' host_prep and curves phases.

direct (the package of --tree; K20-K23 as the direct readout's
runners call them, float32, models behind a readout-only wrapper):
  the bench shell on the scatter path (the S19 table), the tSZ paint at
  epsilon_max 5 and the anisotropic scatter shell, the 3D BaryonifyGrid
  and PaintProfilesGrid at 256^3, the 2D PaintProfilesAnisGrid at 2048^2
  and the snapshot bench, one warm and 3 timed calls each: the medians of
  every phase, of radii + apply (K20 and K21's, K22's or K23's share of a
  call) and of the call, and K20-K23's launches a call; then by wrapper
  call (CUDA events, the mean of 10, in turns) K20 and K21 at the bench
  shell (displacement, float32; K21 on random values) beside K21's
  index_add_ yardstick, K22's radii and apply on the 3D baryonify's first
  chunk of its largest bucket (random values), K22's radii + apply on
  that bucket's first apply group of 2^28 cells at most as the tree's
  runner takes it (one radii pass and one apply, or each chunk's in
  turn), and K23's radii and gather at the snapshot bench, each tree
  through its own entry points; last, digests of K20's rows and layout
  at the bench in every mode (two trees that agree wrote them bit for
  bit).

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
import time

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
VARIANTS["grid_cutout.cu"] = {
    "kernel": [],
    # bitwise the kernel's: T(g / r) for float T from g times 1 / r
    # (within 2 ulps of g / r), the division taken where that lies within
    # 8 ulps of a float rounding midpoint
    "fast_div": [(
        "        for (int d = 0; d < kDim; ++d) {\n"
        "          double comp = dd * double(T(g[d] / r));\n",
        "        const double rinv = 1.0 / r;\n"
        "        for (int d = 0; d < kDim; ++d) {\n"
        "          double q = g[d] * rinv;\n"
        "          if constexpr (sizeof(T) == 4) {\n"
        "            const long long lo =\n"
        "                __double_as_longlong(q) & ((1LL << 29) - 1);\n"
        "            const double aq = fabs(q);\n"
        "            if (!(aq >= 1e-30 && aq <= 1e30) ||\n"
        "                (lo > (1LL << 28) - 8 && lo < (1LL << 28) + 8))\n"
        "              q = g[d] / r;\n"
        "          } else {\n"
        "            q = g[d] / r;\n"
        "          }\n"
        "          double comp = dd * double(T(q));\n")],
    # timing only
    "no_div": [
        ("          dd = double(static_cast<const T*>(p.vals)[slot]) / "
         "p.res;\n",
         "          dd = double(static_cast<const T*>(p.vals)[slot]) * "
         "p.res;\n"),
        ("          double comp = dd * double(T(g[d] / r));\n",
         "          double comp = dd * double(T(g[d] * r));\n")],
    "no_vals": [(
        "          dd = double(static_cast<const T*>(p.vals)[slot]) / "
        "p.res;\n",
        "          dd = double(slot & 7) / p.res;\n")],
    "no_sqrt": [("      const double r = sqrt(r2);\n",
                 "      const double r = r2;\n")],
    # bitwise: each block of the apply takes the tiles blockIdx.x,
    # blockIdx.x + gridDim.x, ... instead of the next from the counter
    "stride": [(
        "  __shared__ int s_next;\n"
        "  const int n = work[0];\n"
        "  for (;;) {\n"
        "    __syncthreads();  // every thread has read the last s_next\n"
        "    if (threadIdx.x == 0) s_next = atomicAdd(work + 1, 1);\n"
        "    __syncthreads();\n"
        "    const int i = s_next;\n"
        "    if (i >= n) return;\n",
        "  const int n = work[0];\n"
        "  for (int i = blockIdx.x; i < n; i += gridDim.x) {\n")],
    # bitwise: the apply's registers uncapped (2 blocks of 512 threads an
    # SM in 3D), or capped so that 4 fit (8 of 256 in 2D)
    "occ2": [("__launch_bounds__(kDim == 3 ? 512 : 256, kDim == 3 ? 3 : 1)\n"
              "grid_direct_kernel(",
              "__launch_bounds__(kDim == 3 ? 512 : 256)\n"
              "grid_direct_kernel(")],
    "occ4": [("__launch_bounds__(kDim == 3 ? 512 : 256, kDim == 3 ? 3 : 1)\n"
              "grid_direct_kernel(",
              "__launch_bounds__(kDim == 3 ? 512 : 256,\n"
              "                                  kDim == 3 ? 4 : 8)\n"
              "grid_direct_kernel(")],
}
VARIANTS["snapshot.cu"] = {
    "kernel": [],
    # bitwise: the radii loop unrolled 4 times (the loads of 4 iterations
    # issued together)
    "radii_unroll": [("  for (int j = pc.y + lane; j < j1; j += 32) {\n",
                      "#pragma unroll 4\n"
                      "  for (int j = pc.y + lane; j < j1; j += 32) {\n")],
    # timing only
    "radii_no_coords": [(
        "      double v = coords[p * NDIM + c] - hp[c];\n",
        "      double v = double(p & 1023) - hp[c];\n")],
    "gather_no_vals": [("      T val = vals[e.x];\n",
                        "      T val = T(e.x & 7);\n")],
    "gather_no_coords": [(
        "        double v = coords[p * NDIM + c] - hpos[(long long)e.y * "
        "NDIM + c];\n",
        "        double v = double(p & 1023) - hpos[(long long)e.y * "
        "NDIM + c];\n")],
}
_K21_GEO = ("  const T amp = d / geo[3 * s + 2];\n"
            "  T t_th = amp * geo[3 * s];\n"
            "  T t_ph = amp * geo[3 * s + 1];\n",
            "  const T amp = d / T(1 + (s & 3));\n"
            "  T t_th = amp * T(0.5);\n"
            "  T t_ph = amp * T(0.25);\n")
_K21_HALO = ("  T d = T(vals[s] * a[hid[s]]);\n",
             "  T d = T(vals[s] * 0.5);\n")
_K21_VEC2 = ("  atomicAdd(reinterpret_cast<float2*>(acc) + p, "
             "make_float2(t_th, t_ph));\n")
VARIANTS["disc_direct.cu"] = {
    "kernel": [],
    # 4 consecutive slots a thread (a warp's atomics then spread over 4
    # times the pixels)
    "slots4": [("  if (s < n) apply_displace_slot(s, pix, hid, geo, vals, a, "
                "acc);\n",
                "  for (long long t = 4 * s; t < 4 * s + 4 && t < n; ++t)\n"
                "    apply_displace_slot(t, pix, hid, geo, vals, a, acc);\n"),
               ("    apply_displace_kernel<T><<<apply_blocks(n), "
                "kApplyThreads, 0,",
                "    apply_displace_kernel<T><<<apply_blocks((n + 3) / 4), "
                "kApplyThreads, 0,")],
    # two scalar atomics, as before the redesign
    "scalar": [(_K21_VEC2, "  atomicAdd(acc + 2 * (long long)p, t_th);\n"
                           "  atomicAdd(acc + 2 * (long long)p + 1, t_ph);"
                           "\n")],
    # timing only
    "no_atomics": [(_K21_VEC2, "  acc[2 * (long long)p] = t_th;\n"
                               "  acc[2 * (long long)p + 1] = t_ph;\n")],
    "no_geo": [_K21_GEO],
    "no_halo": [_K21_HALO],
    # K20's layout pass, each held equal to the kernel's layout bit for
    # bit: the class peers by a ballot a bit of the class (7 ballots)
    # instead of __match_any_sync; 16 halos a lane a chunk instead of 4
    "ballot": [("  return __match_any_sync(kFull, k);\n",
                "  const unsigned key = unsigned(k + 1);\n"
                "  unsigned peers = kFull;\n"
                "#pragma unroll\n"
                "  for (int b = 0; b < 7; ++b) {\n"
                "    const unsigned m = __ballot_sync(kFull, (key >> b) & 1u);"
                "\n"
                "    peers &= (key >> b) & 1u ? m : ~m;\n"
                "  }\n"
                "  return peers;\n")],
    "lane16": [_const("kPerLane", 4, 16)],
}
# the variants of K20's layout pass (the others are K21's)
LAYOUT_VARIANTS = {"ballot", "lane16"}
# K21 before its redesign (a thread a slot, two scalar atomics, the
# accumulator zeroed by the wrapper), whose source only a checkout of an
# earlier commit holds: section K21p, run with --tree on such a checkout
_K21P_ATOMICS = ("  atomicAdd(acc + 2 * (long long)p, t_th);\n"
                 "  atomicAdd(acc + 2 * (long long)p + 1, t_ph);\n")
PARENT_VARIANTS["disc_direct.cu"] = {
    "kernel": [],
    # one 8-byte float2 atomic (sm_90) in place of two scalar ones
    "vec2": [(_K21P_ATOMICS,
              "  if constexpr (sizeof(T) == 4) {\n"
              "    atomicAdd(reinterpret_cast<float2*>(acc) + p,\n"
              "              make_float2(t_th, t_ph));\n"
              "  } else {\n" + _K21P_ATOMICS + "  }\n")],
    # timing only
    "no_atomics": [(_K21P_ATOMICS,
                    "  acc[2 * (long long)p] = t_th;\n"
                    "  acc[2 * (long long)p + 1] = t_ph;\n")],
    "no_geo": [_K21_GEO],
    "no_halo": [_K21_HALO],
}
TIMING_ONLY = {"no_row_trig", "no_rows", "no_slot_geometry", "no_stage",
               "no_zero", "no_pairs", "no_move", "init_plain", "move_list",
               "move_gathers",
               "no_geometry", "no_atomics", "no_search", "no_corners",
               "empty", "no_inversion", "no_chain", "no_scan", "no_phi_div",
               "no_moved", "no_div", "no_vals", "no_sqrt", "radii_no_coords",
               "gather_no_vals", "gather_no_coords", "no_atomics", "no_geo",
               "no_halo"}
# variants whose results must equal the kernel's bit for bit
BITWISE = {"sin_cos", "int_div", "unroll2", "zero_div", "zero_vec",
           "vec_out", "fast_div", "radii_unroll", "occ2", "occ4", "stride"}


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
                          r"|enclosed_mass_kernel|grid_direct_kernelIfLi0ELi3E"
                          r"|snapshot_\w+_kernel\w*Li3E"
                          r"|disc_\w+_kernelIfE|apply_displace_kernelIfE"
                          r"|disc_layout_kernel)",
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


class _Hide:
    """A model's readout surface alone: the runners read it directly."""

    def __init__(self, m):
        self._m = m

    def displacement(self, *a, **k):
        return self._m.displacement(*a, **k)

    def projected(self, *a, **k):
        return self._m.projected(*a, **k)

    def real(self, *a, **k):
        return self._m.real(*a, **k)


DIRECT_CALLS = 3


def _direct_calls(torch, runner, label, gpu):
    """One warm and DIRECT_CALLS timed process() calls: the medians of
    each phase (CUDA events), of radii + apply and of the call, and the
    K20-K23 launches a call."""
    from baryonforge_torch.ops import _build
    runner.process()
    _build.reset_launches()
    walls, phases = [], []
    for _ in range(DIRECT_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.process()
        walls.append((time.perf_counter() - t0) * 1e3)
        phases.append(dict(runner.timings))
    import numpy as np
    out = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    out["radii + apply"] = float(np.median([p["radii"] + p["apply"]
                                            for p in phases]))
    out["call"] = float(np.median(walls))
    out["launches a call"] = {k: v / DIRECT_CALLS
                              for k, v in _build.launches.items()
                              if k in ("grid_radii", "grid_direct",
                                       "tile_pairs", "snapshot_radii",
                                       "snapshot_direct", "disc_radii",
                                       "disc_apply")}
    cs.log(f"[{gpu}] direct {label}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items() if k != "launches a call")
        + f" ms; launches a call {out['launches a call']}")
    return out


def _direct_shells(bf, torch, b):
    """The direct shell runners of chip_smoke.py's step 19, float32, each
    model behind a readout-only wrapper: the bench shell on the scatter
    path (the S19 table; K20, K21, K3), the tSZ paint at epsilon_max 5
    (K20, K21) and the anisotropic scatter shell (K20, K21, K14)."""
    f32, f64, dev = torch.float32, torch.float64, b.dev
    # the table's proj_cutoff (it was built with 100) sets the Anis
    # background's depth
    b.tsz.proj_cutoff = 100
    m = _Hide(b.tsz.with_dtype(f64, device=dev))
    return {
        "BaryonifyShell": bf.BaryonifyShell(
            b.cat, b.shell, epsilon_max=cs.EPS_MAX,
            model=_Hide(b.model.with_dtype(f32, device=dev)),
            deposit="scatter", regrid="scatter", dtype=f32,
            regrid_dtype=f32, device=dev),
        "PaintProfilesShell (tSZ)": bf.PaintProfilesShell(
            b.cat, b.shell, epsilon_max=cs.PAINT_EPS,
            model=_Hide(b.tsz.with_dtype(f32, device=dev)),
            deposit="scatter", dtype=f32, device=dev),
        "PaintProfilesAnisShell": bf.PaintProfilesAnisShell(
            b.cat, cs.anis_shell(bf, b.shell), epsilon_max=cs.PAINT_EPS,
            model=m, Tracer_model=m, Mtot_model=b.tsz,
            background_val=cs.ANIS_BG, global_tracer_fraction=cs.ANIS_FRAC,
            deposit="scatter", dtype=f32, device=dev)}


def _bench_rows(torch, b):
    """K20's inputs at the bench shell (the halo columns of the direct
    BaryonifyShell) and K21's: K20's float32 displacement rows and
    random float64 values on them."""
    from baryonforge_torch.ops import deposit
    halos = b.runner._direct_halos(b.hd)
    rows, lay = deposit.disc_radii(cs.NSIDE, halos, "displace",
                                   torch.float32)
    gen = torch.Generator(device=b.dev).manual_seed(5)
    vals = torch.rand(lay.n_slots, generator=gen, device=b.dev,
                      dtype=torch.float64)
    return halos, rows, lay, vals


def _k20_digests(torch, b):
    """SHA-256 digests of K20's rows (pixel, halo, r, geometry) and layout
    (counts, bases, groups) at the bench halos in every mode (float32, and
    the displacement in float64 too), through the tree's own entry point:
    two trees whose digests agree wrote the same rows and layout bit for
    bit."""
    import hashlib
    import numpy as np
    from baryonforge_torch.ops import deposit
    halos = b.runner._direct_halos(b.hd)
    out = {}
    for mode, dt in (("displace", torch.float32), ("displace", torch.float64),
                     ("paint", torch.float32), ("anis", torch.float32)):
        rows, lay = deposit.disc_radii(cs.NSIDE, halos, mode, dt)
        h = hashlib.sha256()
        for k in ("pix", "hid", "r", "geo"):
            if rows[k] is not None:
                h.update(rows[k].cpu().numpy().tobytes())
        host = lay.numpy() if hasattr(lay, "numpy") else lay
        h.update(np.asarray(host.counts, dtype=np.int64).tobytes())
        h.update(np.asarray(host.base, dtype=np.int64).tobytes())
        for g, K, s0 in host.groups:
            h.update(np.asarray(g, dtype=np.int64).tobytes())
            h.update(np.array([K, s0, host.n_slots], dtype=np.int64)
                     .tobytes())
        out[f"{mode} {str(dt)[6:]}"] = h.hexdigest()[:16]
    cs.log(f"  K20 digests (rows and layout): {out}")
    return out


def probe_direct(bf, torch, b, libs, gpu):
    """The direct readout's runners and K20-K23 as they call them, with the
    package that was imported (see the module docstring): the three direct
    shells (the bench shell on the scatter path, the tSZ paint at
    epsilon_max 5, the anisotropic scatter shell), the 3D BaryonifyGrid
    and PaintProfilesGrid at 256^3 and the 2D PaintProfilesAnisGrid at
    2048^2 (chip_smoke.py's ΔP(k) catalog, 7,088 halos) and the snapshot
    bench, float32, each call's phases; then by wrapper call, in turns,
    K20 and K21 at the bench shell (with K21's index_add_ yardstick), K22
    on the 3D baryonify's first chunk and first apply group of its largest
    bucket and K23 at the snapshot bench."""
    import numpy as np
    from baryonforge_torch.ops import deposit, direct, grid, paint, snapshot
    from baryonforge_torch.ops import healpix as hpx
    from baryonforge_torch.Runners.HealpixRunner import _PhaseClock
    from baryonforge_torch.Runners import Map2DRunner
    from baryonforge_torch.Runners.Map2DRunner import GRID_CELL_BUDGET
    f32, f64 = torch.float32, torch.float64
    dev = b.dev
    cosmo = bf.cosmo.cosmology_from_dict(cs.COSMO)
    P = bf.Profiles
    dmo3 = bf.utils.TabulatedProfile(P.DarkMatter(**cs.BPAR), cosmo) \
        .setup_interpolator(**cs.DMO_GRID)
    dmo2 = bf.utils.TabulatedProfile(P.DarkMatter(**cs.BPAR, proj_cutoff=100),
                                     cosmo).setup_interpolator(**cs.DMO_GRID)
    b3 = bf.Baryonification3D(
        P.DarkMatterOnly(**cs.BPAR), P.DarkMatterBaryon(**cs.BPAR), cosmo,
        epsilon_max=cs.GRID_BARYON_EPS).setup_interpolator(**cs.B_GRID)

    def hide(m):
        return _Hide(m.with_dtype(f64, device=dev))
    cat3, _ = cs.grid_inputs(bf, 3, cs.GRID3D_N)
    rng = np.random.default_rng(1)
    gm3 = cs.grid_map(bf, rng.exponential(1.0, (cs.GRID3D_N,) * 3))
    cat2, _ = cs.grid_inputs(bf, 2, cs.GRID2D_N)
    gm2 = cs.grid_map(bf, rng.exponential(1.0, (cs.GRID2D_N,) * 2))
    out = {}
    for label, runner in _direct_shells(bf, torch, b).items():
        out[f"direct {label}"] = _direct_calls(torch, runner, label, gpu)
    rb = bf.BaryonifyGrid(cat3, gm3, epsilon_max=cs.GRID_BARYON_EPS,
                          model=hide(b3), dtype=f32, device=dev)
    out["direct BaryonifyGrid 3D"] = _direct_calls(torch, rb, "BaryonifyGrid "
                                                   "3D", gpu)
    out["direct PaintProfilesGrid 3D"] = _direct_calls(
        torch, bf.PaintProfilesGrid(
            cat3, gm3, epsilon_max=cs.GRID_PAINT_EPS, model=hide(dmo3),
            dtype=f32, device=dev), "PaintProfilesGrid 3D", gpu)
    out["direct PaintProfilesAnisGrid 2D"] = _direct_calls(
        torch, bf.PaintProfilesAnisGrid(
            cat2, gm2, epsilon_max=cs.GRID_ANIS_EPS, model=hide(dmo2),
            Tracer_model=hide(dmo2), Mtot_model=dmo2,
            background_val=cs.ANIS_BG, global_tracer_fraction=cs.ANIS_FRAC,
            dtype=f32, device=dev), "PaintProfilesAnisGrid 2D", gpu)
    smodel = cs.snapshot_model(bf, cs.DEVICE)
    scat, snap = cs.snapshot_inputs(bf, 3, cs.SNAP_L, cs.SNAP_PARTS,
                                    cs.SNAP_HALOS, cs.SNAP_SEED)
    rs = bf.BaryonifySnapshot(scat, snap, epsilon_max=20, model=hide(smodel),
                              dtype=f32, device=dev, verbose=False)
    out["direct BaryonifySnapshot"] = _direct_calls(torch, rs,
                                                    "BaryonifySnapshot", gpu)

    # K22 on the runner's chunk: the largest bucket's first
    # GRID_CELL_BUDGET cells; and on the first apply group of the
    # grouping runner (whole chunks up to 2^28 cells): the tree's runner
    # takes it in one radii pass and one apply, or chunk by chunk (a tree
    # without Map2DRunner.direct_groups)
    inp = rb._cutout_inputs(_PhaseClock(dev))
    idx, Ns = rb._buckets(inp["Nsize"])[-1]
    cells = Ns ** 3
    step = max(1, GRID_CELL_BUDGET // cells)
    per = step * max(1, (1 << 28) // (step * cells))
    ix = torch.as_tensor(idx[:per], device=dev)
    group = {k: None if v is None else v[ix]
             for k, v in inp["halos"].items()}
    part = {k: None if v is None else v[:step] for k, v in group.items()}
    npix, res = cs.GRID3D_N, gm3.res
    gen = torch.Generator(device=dev).manual_seed(2)
    group_vals = torch.randn(ix.numel() * cells, generator=gen, device=dev,
                             dtype=f32)
    gvals = group_vals[:step * cells]
    acc = torch.zeros((3, npix ** 3), dtype=f32, device=dev)
    grouped = hasattr(Map2DRunner, "direct_groups")

    def group_k22():
        if grouped:
            grid.grid_radii(npix, Ns, res, group)
            return grid.grid_direct("displace", npix, Ns, res, group,
                                    group_vals, acc)
        for a in range(0, ix.numel(), step):
            c = {k: None if v is None else v[a:a + step]
                 for k, v in group.items()}
            grid.grid_radii(npix, Ns, res, c)
            grid.grid_direct("displace", npix, Ns, res, c,
                             group_vals[a * cells:(a + step) * cells], acc)
        return acc
    # K23 at the snapshot bench
    _, _, _, R_q, hpos, _ = rs._host_prep()
    (halos, offsets, parts), layout = rs._neighbour_pairs(hpos, R_q)
    hpos = torch.as_tensor(hpos, device=dev)
    coords, L = rs._coords_dev, snap.L
    if hasattr(snapshot, "direct_layout"):
        dlay = rs._direct_layout()
        n_slots = dlay.rows.n_slots

        def radii():
            return snapshot.snapshot_radii(hpos, halos, offsets, dlay, L)
        svals = torch.randn(n_slots, generator=gen, device=dev, dtype=f32)

        def gather():
            return snapshot.snapshot_direct(hpos, layout[:2], dlay, svals,
                                            L)
    else:
        slay = direct.row_layout((offsets[1:] - offsets[:-1]).cpu().numpy())
        pslot = snapshot.snapshot_radii(coords, hpos, halos, offsets, parts,
                                        slay, L)[1]
        eslot = pslot[snapshot.particle_major_pairs(parts, layout[0])]
        svals = torch.randn(slay.n_slots, generator=gen, device=dev,
                            dtype=f32)

        def radii():
            return snapshot.snapshot_radii(coords, hpos, halos, offsets,
                                           parts, slay, L)

        def gather():
            return snapshot.snapshot_direct(coords, hpos, halos, layout,
                                            eslot, svals, L)
    # K20 and K21 at the bench shell, displacement, float32; K21's
    # yardstick: the tangent offsets formed beforehand, one index_add_
    dhalos, rows, lay, dvals = _bench_rows(torch, b)
    live = rows["pix"] >= 0
    pl = rows["pix"][live].long()
    delta = torch.randn((pl.numel(), 2), generator=gen, device=dev,
                        dtype=f32)
    fns = {"K20 disc_radii": lambda: deposit.disc_radii(
               cs.NSIDE, dhalos, "displace", f32),
           "K21 disc_apply": lambda: paint.disc_apply(
               "displace", cs.NSIDE, rows, dvals, dhalos),
           "K21 index_add_ yardstick": lambda: torch.zeros(
               (hpx.npix(cs.NSIDE), 2), device=dev, dtype=f32).index_add_(
                   0, pl, delta),
           "K22 radii (one chunk)": lambda: grid.grid_radii(npix, Ns, res,
                                                            part),
           "K22 apply (one chunk, its lists)": lambda: grid.grid_direct(
               "displace", npix, Ns, res, part, gvals, acc),
           "K22 radii + apply (one group, as the tree's runner cuts "
           "it)": group_k22,
           "K23 radii": radii, "K23 gather": gather}
    cs.log(f"  K20/K21: {lay.n_slots} slots, {pl.numel()} members; K22's "
           f"chunk: {step} halos x {Ns}^3 cells, its group {ix.numel()} "
           f"halos; K23: {parts.numel()} pairs")
    out["direct wrappers"] = report(gpu, "direct", timed_in_turns(
        torch, fns, reps=10))
    out["K20 digests"] = _k20_digests(torch, b)
    return out


def _direct_bench(bf, torch, dev):
    """K22's and K23's inputs at the direct readout's bench shapes: the 3D
    baryonify's largest size bucket (its first readout chunk, its first
    apply group, random float32 values), and the snapshot bench's pairs
    with K23's layout (random float32 values)."""
    from baryonforge_torch.Runners.HealpixRunner import _PhaseClock
    from baryonforge_torch.Runners.Map2DRunner import direct_groups
    f32, f64 = torch.float32, torch.float64
    cosmo = bf.cosmo.cosmology_from_dict(cs.COSMO)
    P = bf.Profiles
    b3 = bf.Baryonification3D(
        P.DarkMatterOnly(**cs.BPAR), P.DarkMatterBaryon(**cs.BPAR), cosmo,
        epsilon_max=cs.GRID_BARYON_EPS).setup_interpolator(**cs.B_GRID)
    cat3, gm3 = cs.grid_inputs(bf, 3, cs.GRID3D_N)
    rb = bf.BaryonifyGrid(cat3, gm3, epsilon_max=cs.GRID_BARYON_EPS,
                          model=_Hide(b3.with_dtype(f64, device=dev)),
                          dtype=f32, device=dev)
    inp = rb._cutout_inputs(_PhaseClock(dev))
    idx, Ns = rb._buckets(inp["Nsize"])[-1]
    step, groups = direct_groups(idx.size, Ns ** 3)
    per = groups[0].stop
    gen = torch.Generator(device=dev).manual_seed(2)
    parts = {}
    for name, n in (("chunk", step), ("group", per)):
        ix = torch.as_tensor(idx[:n], device=dev)
        parts[name] = ({k: None if v is None else v[ix]
                        for k, v in inp["halos"].items()},
                       torch.randn(ix.numel() * Ns ** 3, generator=gen,
                                   device=dev, dtype=f32))
    smodel = cs.snapshot_model(bf, cs.DEVICE)
    scat, snap = cs.snapshot_inputs(bf, 3, cs.SNAP_L, cs.SNAP_PARTS,
                                    cs.SNAP_HALOS, cs.SNAP_SEED)
    rs = bf.BaryonifySnapshot(scat, snap, epsilon_max=20,
                              model=_Hide(smodel), dtype=f32, device=dev,
                              verbose=False)
    _, _, _, R_q, hpos, _ = rs._host_prep()
    (halos, offsets, _), layout = rs._neighbour_pairs(hpos, R_q)
    dlay = rs._direct_layout()
    svals = torch.randn(dlay.rows.n_slots, generator=gen, device=dev,
                        dtype=f32)
    snap_args = (torch.as_tensor(hpos, device=dev), halos, offsets,
                 layout[:2], dlay, svals, snap.L)
    return (cs.GRID3D_N, Ns, gm3.res, parts), snap_args


def probe_disc_radii(bf, torch, b, libs, gpu):
    """K20 at the bench shell (displacement, float32) split into its parts,
    with the package that was imported: each part by call (CUDA events,
    the mean of 20, in turns) and, where it runs on the device only, alone
    (a CUDA graph of 20), beside the whole wrapper. The parts of the
    layout formed on the card (a tree with ``ops.deposit._k20_layout``):
    the count launch, the layout launch, the class counts' copy, the rows'
    allocation, the write launch, the host's groups (cut while the write
    pass runs). Those of the
    two-walk design with a host layout (an earlier tree): the count
    launch, the counts' copy and the host row_layout, the slot fills, the
    upload of base, the write launch."""
    import numpy as np
    from baryonforge_torch.ops import _build, deposit, direct
    f32, dev, N = torch.float32, b.dev, cs.NSIDE
    halos = b.runner._direct_halos(b.hd)
    n = halos["theta"].numel()
    cols = [halos[k].contiguous() for k in deposit._DIRECT_COLUMNS]
    fn = _build.library().bf_disc_radii_f32
    wrapper = {"wrapper": lambda: deposit.disc_radii(N, halos, "displace",
                                                     f32)}
    if hasattr(deposit, "_k20_layout"):
        def count_launch():
            return deposit._k20_count(fn, 0, N, cols)
        members, counts = count_launch()

        def layout_launch():
            return deposit._k20_layout(counts)
        base, order, class_counts = layout_launch()

        def copy():
            return direct.class_slots(class_counts.tolist())
        n_slots = copy()

        def groups():
            return direct.class_groups(hist, order)
        hist = class_counts.tolist()

        def alloc():
            return deposit._k20_rows(n_slots, "displace", f32, dev)
        rows = alloc()

        def write_launch():
            deposit._k20_write(fn, 0, N, cols, members, base, rows)

        def device():
            count_launch()
            layout_launch()
            write_launch()
        by_call = dict(wrapper, **{
            "count launch": count_launch, "layout launch": layout_launch,
            "class counts' copy": copy, "row allocation": alloc,
            "write launch": write_launch, "groups (host)": groups})
        alone = {"count launch": count_launch,
                 "layout launch": layout_launch,
                 "write launch": write_launch,
                 "count, layout, write": device}
        cs.log(f"  K20 at the bench: {n} halos, {int(counts.sum())} row "
               f"radii, {n_slots} slots in {len(groups())} groups")
    else:
        ptrs = [_build.ptr(c) for c in cols]
        count = torch.zeros(n, dtype=torch.int32, device=dev)

        def count_launch():
            _build.check(fn(0, N, n, *ptrs, 0, _build.ptr(count), None,
                            None, None, None, None, _build.stream_of(count)),
                         "K20")

        def copy_layout():
            members = count.cpu().numpy().astype(np.int64)
            return direct.row_layout(deposit._row_counts("displace",
                                                         members))
        count_launch()
        lay = copy_layout()

        def fills():
            return deposit._rows_empty(lay.n_slots, "displace", f32, dev)

        def upload():
            return torch.as_tensor(lay.base, device=dev)
        rows, base = fills(), upload()

        def write_launch():
            _build.check(fn(0, N, n, *ptrs, 1, _build.ptr(count),
                            _build.ptr(base), _build.ptr(rows["pix"]),
                            _build.ptr(rows["hid"]), _build.ptr(rows["r"]),
                            _build.ptr(rows["geo"]),
                            _build.stream_of(count)), "K20")

        def device():
            count_launch()
            fills()
            write_launch()
        by_call = dict(wrapper, **{
            "count launch": count_launch,
            "counts' copy + host row_layout": copy_layout,
            "slot fills": fills, "base upload": upload,
            "write launch": write_launch})
        alone = {"count launch": count_launch, "slot fills": fills,
                 "write launch": write_launch,
                 "count, fills, write": device}
        cs.log(f"  K20 at the bench: {n} halos, {lay.n_radii} row radii, "
               f"{lay.n_slots} slots in {len(lay.groups)} groups")
    return {"K20 parts": report(gpu, "K20", timed_in_turns(torch, by_call),
                                " by call"),
            "K20 parts alone": report(gpu, "K20", timed_in_turns(
                torch, alone, timer=lambda f: cs.graph_ms(torch, f)),
                " (device alone)")}


def probe_disc_apply(bf, torch, b, libs, gpu):
    """K21 (disc_direct.cu) at the bench shell, displacement, float32, on
    K20's rows and random values: the variants by wrapper call, each that
    keeps the results first held to the plain version (1e-5 of the
    offsets' largest, as chip_smoke.py holds the kernel), and the
    accumulator's memset (the wrapper's torch.zeros) alone; then K20's
    layout pass and its variants (LAYOUT_VARIANTS, each held to the
    kernel's layout bit for bit first) on the bench's row counts."""
    from baryonforge_torch.ops import _build, deposit, paint
    from baryonforge_torch.ops import healpix as hpx
    halos, rows, lay, vals = _bench_rows(torch, b)
    want = paint.disc_apply_plain("displace", cs.NSIDE, rows, vals, halos)
    scale = float(want.abs().max())
    fns = {}
    for (src, v), lib in libs.items():
        if src != "disc_direct.cu" or v in LAYOUT_VARIANTS:
            continue
        if v not in TIMING_ONLY:
            _build._lib = lib
            got = paint.disc_apply("displace", cs.NSIDE, rows, vals, halos)
            cs.check(f"K21 [{v}] against the plain version",
                     float((got - want).abs().max()), 1e-5 * scale)

        def run(lib=lib):
            _build._lib = lib
            return paint.disc_apply("displace", cs.NSIDE, rows, vals, halos)
        fns[v] = run
    fns["memset alone"] = lambda: torch.zeros(
        (hpx.npix(cs.NSIDE), 2), dtype=torch.float32, device=b.dev)
    out = {"K21": report(gpu, "K21", timed_in_turns(torch, fns)),
           "K21 alone": report(gpu, "K21", timed_in_turns(
               torch, fns, timer=lambda f: cs.graph_ms(torch, f)),
               " (device alone)")}
    layouts = {}
    if hasattr(deposit, "_k20_layout"):
        counts = lay.counts
        _build._lib = libs[("disc_direct.cu", "kernel")]
        ref = deposit._k20_layout(counts)
        for v in ["kernel"] + sorted(LAYOUT_VARIANTS):
            lib = libs.get(("disc_direct.cu", v))
            if lib is None:
                continue
            _build._lib = lib
            got = deposit._k20_layout(counts)
            n_ord = int(ref[2].sum())
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
                    and torch.equal(got[1][:n_ord], ref[1][:n_ord])):
                raise AssertionError(f"K20 layout [{v}]: not the kernel's")

            def run(lib=lib):
                _build._lib = lib
                return deposit._k20_layout(counts)
            layouts[v] = run
        out["K20 layout alone"] = report(gpu, "K20 layout", timed_in_turns(
            torch, layouts, timer=lambda f: cs.graph_ms(torch, f)),
            " (device alone)")
    _build._lib = None
    return out


def probe_grid_direct(bf, torch, b, libs, gpu):
    """K22 (grid_cutout.cu) at the 3D baryonify's largest bucket: the
    apply's variants on its first readout chunk and its first apply group
    by wrapper call, each variant that keeps the results held against the
    kernel's bit for bit first (and the kernel against the plain version
    on the chunk); the radii on the group."""
    from baryonforge_torch.ops import _build, grid
    (npix, Ns, res, parts), _ = _direct_bench(bf, torch, b.dev)
    acc0 = torch.zeros((3, npix ** 3), dtype=torch.float32, device=b.dev)
    names = list(VARIANTS["grid_cutout.cu"])
    out = {}
    for name in ("chunk", "group"):
        part, vals = parts[name]
        _build._lib = libs[("grid_cutout.cu", "kernel")]
        ref = grid.grid_direct("displace", npix, Ns, res, part, vals,
                               acc0.clone())
        if name == "chunk":
            plain = grid.grid_direct_plain("displace", npix, Ns, res, part,
                                           vals, acc0.clone())
            cs.check("K22 [kernel] against the plain version",
                     (ref - plain).abs().max().item(),
                     1e-5 * plain.abs().max().item())
        fns = {}
        for v in names:
            lib = libs[("grid_cutout.cu", v)]
            if v not in TIMING_ONLY:
                _build._lib = lib
                got = grid.grid_direct("displace", npix, Ns, res, part, vals,
                                       acc0.clone())
                if not torch.equal(got, ref):
                    raise AssertionError(f"K22 [{v}]: not the kernel's "
                                         "results bit for bit")

            def run(lib=lib, part=part, vals=vals):
                _build._lib = lib
                return grid.grid_direct("displace", npix, Ns, res, part,
                                        vals, acc0)
            fns[v] = run
        cs.log(f"  K22 {name}: {part['cen'].shape[0]} halos x {Ns}^3 cells")
        out[f"K22 apply ({name})"] = report(
            gpu, "K22", timed_in_turns(torch, fns, reps=5 if name == "chunk"
                                       else 2), f" apply ({name})")
    _build._lib = libs[("grid_cutout.cu", "kernel")]
    part, _ = parts["group"]
    out["K22 radii (group)"] = report(gpu, "K22", timed_in_turns(
        torch, {"kernel": lambda: grid.grid_radii(npix, Ns, res, part)},
        reps=5), " radii (group)")
    _build._lib = None
    return out


def probe_snapshot_direct(bf, torch, b, libs, gpu):
    """K23 (snapshot.cu) at the snapshot bench: the radii's and the
    gather's variants by wrapper call, each variant that keeps the results
    held against the plain version bit for bit first."""
    from baryonforge_torch.ops import _build, snapshot
    _, (hpos, halos, offsets, layout, dlay, vals, L) = _direct_bench(
        bf, torch, b.dev)
    r0 = snapshot.snapshot_radii_plain(hpos, halos, offsets, dlay, L)
    g0 = snapshot.snapshot_direct_plain(hpos, layout, dlay, vals, L)
    radii, gather = {}, {}
    for v in VARIANTS["snapshot.cu"]:
        lib = libs[("snapshot.cu", v)]
        if v not in TIMING_ONLY:
            _build._lib = lib
            if not (torch.equal(snapshot.snapshot_radii(
                    hpos, halos, offsets, dlay, L), r0)
                    and torch.equal(snapshot.snapshot_direct(
                        hpos, layout, dlay, vals, L), g0)):
                raise AssertionError(f"K23 [{v}]: not the plain version's")

        def run_r(lib=lib):
            _build._lib = lib
            return snapshot.snapshot_radii(hpos, halos, offsets, dlay, L)

        def run_g(lib=lib):
            _build._lib = lib
            return snapshot.snapshot_direct(hpos, layout, dlay, vals,
                                            L)
        if not v.startswith("gather"):
            radii[v] = run_r
        if not v.startswith("radii"):
            gather[v] = run_g
    out = {"K23 radii": report(gpu, "K23", timed_in_turns(torch, radii),
                               " radii"),
           "K23 gather": report(gpu, "K23", timed_in_turns(torch, gather),
                                " gather")}
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
            "direct": ((), probe_direct),
            "K22": (("grid_cutout.cu",), probe_grid_direct),
            "K23": (("snapshot.cu",), probe_snapshot_direct),
            "K20": ((), probe_disc_radii),
            "K21": (("disc_direct.cu",), probe_disc_apply),
            "K21p": (("disc_direct.cu",), probe_disc_apply, PARENT_VARIANTS),
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
                    if k not in ("calls", "rows", "direct", "K9p", "K6p",
                                 "K20", "K21p")]
    if not set(want) <= set(SECTIONS):
        print(f"chip_probes: sections are {list(SECTIONS)}", file=sys.stderr)
        return 2
    gpu = cs.gpu_line()
    cs.log(gpu)
    results = {}
    with tempfile.TemporaryDirectory() as work:
        sources = {src: (SECTIONS[k][2] if len(SECTIONS[k]) > 2
                         else VARIANTS)[src]
                   for k in want for src in SECTIONS[k][0]}.items()
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
