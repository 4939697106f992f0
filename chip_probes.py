"""Design probes of kernels K4 (tile deposit), K10 and K12 (tile paint and
paint2, K4's template in its paint modes) and K11 (disc paint) on the
card, at the bench inputs of chip_smoke.py.

    python3 chip_probes.py        # one card; builds included

Each variant is a kernel's source in baryonforge_torch/csrc/ with a few
text replacements, compiled with the build's own nvcc flags into a library
of its own (one nvcc per variant, all started together). The wrappers run
unchanged with that library in place of the build's. Every variant that
keeps the kernel's results is first held against the plain version, as
chip_smoke.py holds the kernel; then the variants of a kernel are timed by
CUDA events (chip_smoke.time_ms: the mean of 20 wrapper calls after a
warm-up) in turns, forward and back, twice, and each variant's four
readings are printed. The variants:

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
TIMING_ONLY = {"no_row_trig", "no_rows", "no_slot_geometry", "no_stage",
               "no_zero", "no_pairs"}
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


def build_variants(work):
    """Compile every variant into ``work``; returns {name: library path}."""
    from baryonforge_torch.ops import _build
    flags = _build.NVCC_FLAGS
    jobs = {}
    for src, variants in VARIANTS.items():
        text = (_build._CSRC / src).read_text()
        for name, edits in variants.items():
            d = os.path.join(work, name)
            shutil.copytree(_build._CSRC, d)
            body = text
            for old, new in edits:
                if body.count(old) != 1:
                    raise RuntimeError(f"{name}: the text to replace is not "
                                       f"in {src} once: {old!r}")
                body = body.replace(old, new)
            with open(os.path.join(d, src), "w") as f:
                f.write(body)
            out = os.path.join(work, f"lib_{name}.so")
            jobs[name] = (out, subprocess.Popen(
                [_build._nvcc()] + flags + ["-Xptxas", "-v", "-o", out,
                                            os.path.join(d, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (out, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        paths[name] = out
        # registers and spills of the float kernels the probes time
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+"
                          r"(tile_pairs_kernelIfLi[01]E|disc_paint_kernelIfd)",
                          line)
            if "Compiling entry function" in line:
                entry = m.group(1) if m else None
            elif entry and ("spill" in line or "Used" in line):
                cs.log(f"  ptxas [{name}] {entry}: {line.strip()}")
    return paths


def timed_in_turns(torch, fns, reps=20, rounds=2):
    """{name: [ms, ...]}: every fn timed forward then back, ``rounds``
    times."""
    out = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(cs.time_ms(torch, fns[name], reps))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import baryonforge_torch as bf
    from baryonforge_torch.ops import _build, paint
    from baryonforge_torch.ops import tile_deposit as td
    gpu = cs.gpu_line()
    cs.log(gpu)
    dev = torch.device(cs.DEVICE)
    with tempfile.TemporaryDirectory() as work:
        libs = {k: _Library(p) for k, p in build_variants(work).items()}

        cosmo = bf.cosmo.cosmology_from_dict(cs.COSMO)
        cat, shell = cs.bench_inputs(bf, cs.NSIDE, cs.N_HALOS, cs.SEED)
        model = bf.Baryonification2D(None, None, cosmo,
                                     epsilon_max=cs.EPS_MAX).load_table(
                                         cs.TABLE)
        runner = bf.BaryonifyShell(cat, shell, epsilon_max=cs.EPS_MAX,
                                   model=model, dtype=torch.float32,
                                   device=dev)
        hd = runner._host_halo_data(cosmo)
        tiling, csr, pack, r0, inv, _ = cs.tiled_inputs(torch, runner, hd)

        tsz = cs.tsz_models(bf, bf.utils.TabulatedProfile(
            None, cosmo, mass_def=bf.cosmo.MassDef200c).load_table(
                cs.TSZ_TABLE))["log"]
        runner_p = bf.PaintProfilesShell(cat, shell,
                                         epsilon_max=cs.PAINT_EPS, model=tsz,
                                         dtype=torch.float32, device=dev)
        hd_p = runner_p._host_halo_data(cosmo)
        curves, pr0, pdl = tsz.with_dtype(torch.float32,
                                          device=dev).halo_curves(
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
        hd_a = runner_a._host_halo_data(cosmo)
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
            return td.tile_paint(tiling_p, csr_p, pack_p, pr0, 1.0 / pdl,
                                 True)

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
        _build._lib = libs["kernel"]
        base = (k4(), k10(), k12())
        results = {}
        for kernels, names in (((("K4", k4), ("K10", k10), ("K12", k12)),
                                list(VARIANTS["tile_deposit.cu"])),
                               ((("K11", k11),),
                                list(VARIANTS["disc_paint.cu"]))):
            for name in names:
                if name in TIMING_ONLY:
                    continue
                _build._lib = libs[name]
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
                                       torch.full_like(rtol, 1e-4),
                                       marginal_a)
                    if name in BITWISE:
                        same = all(torch.equal(x.view(torch.int32),
                                               y.view(torch.int32))
                                   for x, y in zip((ak, a10, a12), base))
                        cs.log(f"  K4, K10, K12 [{name}] bitwise the "
                               f"kernel's: {same}")
                        if not same:
                            raise AssertionError(f"{name}: results differ "
                                                 "from the kernel's")
                else:
                    cs.paint_f32_check(f"K11 [{name}]", k11(), ap11, rtol,
                                       marginal)
            for kname, fn in kernels:
                fns = {}
                for name in names:
                    def run(lib=libs[name], fn=fn):
                        _build._lib = lib
                        return fn()
                    fns[name] = run
                got = timed_in_turns(torch, fns)
                results[kname] = got
                for name, ms in got.items():
                    cs.log(f"[{gpu}] {kname} {name}: "
                           + ", ".join(f"{t:.4f}" for t in ms) + " ms")
        _build._lib = None
    cs.log(gpu)
    print(json.dumps({"probes": results, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
