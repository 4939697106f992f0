#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` (on PATH or under CUDA_HOME) and the
repository's ``baryonforge_torch`` package; it imports nothing of JAX. It

  1. prints the card's name and power limit (nvidia-smi),
  2. builds the CUDA kernels from ``baryonforge_torch/csrc``,
  3. holds each kernel against its plain PyTorch version on the card, in
     float32 and float64, timing both with CUDA events at the bench shapes
     (bench.py:81-123: NSIDE 1024, 18,512 halos, seed 7, epsilon_max 20,
     the Schneider19 table in tools/_northstar_table.npz):
       - K1 curve collapse, K2 disc deposit, K3 scatter regrid on a small
         catalog with halos at the poles (NSIDE 64) and at the bench shapes;
       - K4 tile deposit, K5 hot-tile test and stencil, K6 the stencil's
         source list and complement, K7 the tile layouts, on that polar
         catalog, on an NSIDE 256 catalog (where the stencil handles the
         belt's tiles) and at the bench shapes, and K1 on a table with two
         parameter axes; K5's two entries also timed apart, beside K3 (the
         scatter path's regrid of the same map);
     at the bench K1 timed as the runner calls it (the model's kept set-up,
     the runner's float64 M and a on the card), on the device alone (a
     CUDA graph of 20 calls) and from host columns, and K3 by wrapper call,
     on the device alone and
     beside one index_add_ of its 4 npix shares formed beforehand (a
     partial library yardstick), and K6's complement in place on one map
     by wrapper call and on the device alone, beside one index_add_ of its
     shares formed beforehand (4 a moved source, one an unmoved source),
     its bound from its own bytes (offsets and values read once, each
     touched pixel updated);
     K7 also on the shell's and the paint's tilings at NSIDE 64, 256 and
     1024 (C 1 and 2, float32 and float64, bitwise), and K2 also at NSIDE
     1024 on discs at both poles, across phi = 0, under 4 members and of
     1.2 to 8 degrees (the kernel's whole-block route);
  4. runs the whole path on the card against the plain versions on the CPU
     (float64) for the polar catalog through the default engine (its small
     discs take K2) and the scatter path, and the NSIDE 256 catalog through
     the default engine;
  5. holds the table build's kernels against their plain versions on the
     card (float64): K8 FFTLog on correlation_3d's P(k) grid (1 x 1024, the
     only shape the S19 and tSZ table builds launch), on a batch of profile
     rows (20 x 2048, mu = 0 and 1/2), on Bluestein's route (3 x 100, q on
     a Gamma pole) and on the device-memory route (1 x 8192 and 1 x
     16,384, past the 12,288 points of its former limit), each timed
     beside torch.fft.fft twice with the coefficients formed beforehand (a
     partial yardstick), both also on the device alone (a CUDA graph), and
     K9 on the bench table's first redshift (20 masses, 64 radii): its
     fused launch (both enclosed-mass curves and the inversion) by
     wrapper call and on the device alone, and its two halves apart;
  6. builds the Schneider19 displacement table on the card from the bench's
     profile parameters (bench.py:42-55: 8 z x 20 M x 64 r) through
     Baryonification2D(DarkMatterOnly, DarkMatterBaryon).setup_interpolator,
     with the launch counts set to 0 just before and read just after, and
     K8's shapes and callers logged; checks
     it is finite and within 2.5e-4 of its largest |d| of
     tools/_northstar_table.npz (the JAX file's own drift from the current
     JAX profiles is 1.2e-4), a small table (2 x 4 x 16) on the card against
     the plain versions on the CPU to 1e-9, and prints the build's wall time
     and per-redshift phases, among them the DMB profile's spline solves
     (the host sweep against the same sweep as launches on the card and a
     dense torch.linalg.solve there);
  7. runs, at the bench configuration, the scatter path
     BaryonifyShell(deposit="scatter", regrid="scatter",
     regrid_dtype=float32) and the default (tiled) engine
     BaryonifyShell(regrid_dtype=float32), each with the launch counts set
     to 0 just before and read just after: it checks that every kernel of
     each path was launched, that mass is conserved, that the maps are
     finite (the scatter path's curves and regrid phases printed apart),
     that the scatter path agrees with its plain-version pipeline
     and the tiled engine with the scatter path (also with a float64
     regrid, to the JAX package's edge-jitter bounds), and prints each
     path's halos/s and per-phase milliseconds; then the default engine
     again from the card-built table (the table file is not read on that
     path), against the run from the file's table within the edge-jitter
     bound;
  8. times the full-width table (setup_interpolator() at its defaults, 30 z
     x 30 M x 100 r) and counts its broken-row warnings;
  9. holds the paint's kernels against their plain versions on the card,
     with the bench's tSZ table as the JAX package built it
     (tests/data/tsz_bench_table.npz) and its raw form (exp of the table):
     K10 tile paint and K11 disc paint, log and raw curves, float64 (to
     1e-10 of the largest value) and float32 (per pixel, to the relative
     tolerance of ops.paint.float32_tolerance, with pixels painted on one
     side only allowed at disc edges alone; at the bench shapes also K11's
     plain version on the card against the CPU's), on the polar catalog
     (NSIDE 64, epsilon_max 60), the NSIDE 256 catalog (epsilon_max 20) and
     the bench shapes (epsilon_max 5), and the paint path card vs CPU in
     float64 on the polar catalog;
 10. builds the tSZ table TabulatedProfile(ThermalSZ(Pressure(**bpar,
     proj_cutoff=100), proj_cutoff=100)) on the card on the bench grid,
     timed (K8's shapes and callers logged), against the JAX file (logs
     within 1e-9) and a small table on the card against the CPU's;
 11. runs the paint path at the bench configuration, PaintProfilesShell(
     epsilon_max=5, model=the card's tSZ table).process(), tiled (the
     default: K1, K10, K7) and scatter (K1, K11), each with the launch
     counts set to 0 just before and read just after; checks the two agree
     to the JAX package's bound (tests/test_tiled_deposit.py:113), and the
     card table's map agrees with the file table's; then one paint call at
     the north star's size (NSIDE 4096, 10^6 halos), warm and twice timed,
     with its phases;
 12. holds the anisotropic paint's kernels against their plain versions on
     the card: K12 tile paint2 (on the runner's own pack), K13 anisotropic
     disc paint and K14 finish (both forms), with (log, log) and (raw, log)
     curve pairs, float64 (to 1e-10 of the largest value; K14 to 1e-15
     relative) and float32 (per pixel, to ops.paint.float32_tolerance with
     both curves' slopes, K13's unit vectors with their own reach), on the
     polar catalog (epsilon_max 60) and at the bench shapes (epsilon_max
     5; K13's discs all a warp each, so K13 also with three discs of 1.2-3
     degrees on the whole-block route, its map reads counted in warp
     requests and 32-byte sectors, and its device time alone); runs
     PaintProfilesAnisShell card vs CPU (polar, float64, the halo term)
     and, at its bench configuration (tools/anis_bench.py:76-93: the
     card's tSZ table as model, tracer and Mtot, the shell at z 0.9), the
     tiled (K1, K10, K7, K12, K14) and scatter (K1, K11, K13, K14) paths
     with drive_path(), and holds the two to the JAX package's bounds
     (tests/test_runners_extra.py:243-261) in float32, float64 and on the
     halo term alone;
 13. builds the ΔP(k) recipe's tables on the card (examples/06_delta_pk.py:
     46-87) and runs the grid runners: on a small grid (32^3, 128^2) K15
     grid cutouts and K16 grid deposit against their plain versions in
     float64 and float32 and every runner card vs CPU in float64; then, at
     the recipe's configuration (7,088 halos of seed 3 at z 0.2 in a 256
     Mpc box, BASELINE.md:13), in 3D (256^3) the DMO paint
     (PaintProfilesGrid, epsilon_max 10) and BaryonifyGrid (epsilon_max
     20) of its map plus a 10% floor, and in 2D (2048^2) the same with
     ellipticity and PaintProfilesAnisGrid (epsilon_max 5): each driven
     with the launch counts set to 0 just before and read just after, mass
     conserved, K15 and K16 held against their plain versions on each
     runner's own inputs (float32 offsets to 1e-5 of the largest,
     float64 maps to 1e-10; K16 also against the plain version of its tile
     windows, ops.scatter.grid_deposit_windows_plain, with the share of
     sources whose offsets are all 0 and of corners that spill past the
     window logged, and at 256^3 its time against the 0.45 ms target),
     K15's second call on each bitwise equal to its first and its (tile,
     halo) lists equal to those of its pair kernel's plain version on the
     CPU, halos/s and phases printed;
 14. builds the tables of the remaining profile families on the card,
     each timed twice, the first build with the launch counts set to 0
     just before and read just after, and a small one (2 z x 4 M x 16 r) on the card against the
     CPU's to 1e-9 (of the largest |d|; of the logs for a tabulated
     profile), and runs each family's runner at full width, one warm and
     three timed calls with the launch counts set to 0 just before and
     read just after, halos/s and phases printed: the Arico20 ΔP(k)
     (Baryonification3D of the fiducial set of
     examples/05_profile_gallery.py:34-41 on the grid tables' 2 z x 8 M x
     48 r, K9; BaryonifyGrid(epsilon_max=20) on the 3D grid path's map,
     BASELINE.md:14: K1, K15, K16, mass conserved); Mead20
     (Baryonification2D of the T_AGN 10^7.8 calibration with the two-halo
     terms, proj_cutoff 100, on the bench grid, K8 and K9; the tiled shell
     engine at the bench: K1, K4, K5, K6, K7); Schneider25
     (Baryonification2D of tests/defaults.py:21-29's parameters on the
     bench grid, K8 and K9; the scatter shell path at the bench: K1, K2,
     K3); Battaglia12 (a TabulatedProfile of ElectronPressure("200_AGN")
     on the bench grid; the tiled paint at the bench, epsilon_max 5: K1,
     K10, K7);
 15. builds the snapshot bench's table on the card (tools/snapshot_bench.py:
     29-73: Baryonification3D(DarkMatter, DarkMatter(epsilon 2)), 2 z x 12
     M x 48 r) and holds K17 snapshot displacement against its plain
     versions (the halo-major reference and the per-particle gather) on
     small boxes whose largest query radius exceeds L / 3 (2D and 3D;
     float64 to 1e-10 of the largest offset, float32 to
     tests/test_snapshot.py:67; two launches bitwise equal) and
     BaryonifySnapshot card vs CPU (float64); on those boxes the pairs
     of K24, the cell list on the card, against its plain version (a
     brute-force test on the card) and the host's search (native.
     cell_query in 3D, cKDTree in 2D), set for set;
     then drives BaryonifySnapshot at the bench (10^6 particles, 20,000
     halos, L 512, seed 11, z 0.2, float32) with the launch counts set to 0
     just before and read just after: the first call (with K24's build,
     count and write) and three steady calls timed, halos/s, particles/s
     and phases printed, K1, K17 and K24 launched, no host search, the
     pairs one kept chunk, the output finite, a 256-halo subcatalog
     against the brute-force sum on the card; K24 on the bench's input
     (one search by wrapper and each launch on the device alone, beside
     its plain version and the host cell list on the same input, the sets
     of both); the bench with PAIR_BUDGET lowered to a quarter of its
     pairs, bitwise the one-chunk run on the curve and direct paths in
     float32 and float64; a box whose largest halo holds more pairs than
     a lowered PAIR_BUDGET, that halo cut across three chunks or more,
     bitwise the one-chunk run on both paths; K17's particle-major layout (pairs a particle:
     mean, 99th percentile, max; its build time), K17 on the runner's own
     inputs (two launches bitwise equal) timed against its plain version,
     the 0.30 ms target and an index_add_ of the same pair vectors;
     then the large snapshot, the bench's generator at 512^3 particles and
     40,000 halos, past 2^31 - 1 pairs: the first call and two steady
     calls with their phases, the pairs and chunks, K24 and K17 in every
     chunk, the peak device memory; 4,096 particles against a brute-force
     float64 sum over all the halos and 256 halos' counts against a
     brute-force count, on the card; two more calls with the chunks
     kept, the other choice of the cache;
 16. holds K18 ring modes and K19 Legendre transform against their plain
     versions on the card in float64 (K18 within ops.sht.
     ring_modes_tolerance, the plain version's angle rounding; K19 within 4
     n_ring eps of its absolute sum) at NSIDE 64 and at NSIDE 1024, lmax
     3071, where both are timed (2 repetitions) beside torch.fft.rfft per
     ring length, K19 on the mirrored ring heights (ops.sht.ring_heights)
     and on the JAX heights, and the plain version's difference between
     the two in units of K19's tolerance; K18 also at NSIDE 8 with lmax 23
     (m past nr), at NSIDE
     48 (Bluestein rings) and at NSIDE 64 with 2048 bytes of shared memory
     a ring (the device-memory route); anafast card vs CPU at NSIDE 64 and
     the analytic maps of tests/test_sht.py:38-58 at NSIDE 1024;
 17. runs the ΔCl recipe of examples/15_delta_cl.py at NSIDE 1024 (150
     halos, its two tables built on the card): the paint, the
     baryonification and the two anafast calls (lmax 3071) on the card,
     with the launch counts set to 0 just before and read just after; prints
     the four band ratios and the phases;
 18. runs the last modules at full width: the S19 validation pipelines of
     baryonforge_torch/utils/validation.py, each with the launch counts set
     to 0 just before and read just after, every row printed beside
     PARITY.json's (the JAX package's) and held to the JAX tests' bounds:
     limber_shell_run at NSIDE 256 and 512 (93,369 halos expected;
     tests/test_deltacl.py), deltapk_s19_residuals on the 256^3 s19_box
     (tests/test_deltapk_golden.py:57-59) and tiled_vs_scatter_residual(
     64, 300) under 0.02; TabulatedCorrelation3D at its defaults (40 x
     500) built on the card against the CPU's (1e-9 of max |xi|) and as
     the xi_mm hook of the bench table (against the card's direct build,
     within HOOK_BOUND of max |d|: the table's interpolation error);
     halomodel_power card vs CPU (1e-9); every runner kind with
     halo_mesh(4, "cuda") against none at the bench configuration (the
     shell's two engines, the tiled tSZ paint, the float64 anisotropic
     paint both ways, BaryonifyGrid on the 256^3 map, the snapshot bench),
     SplitJoinParallel on the scatter tSZ paint, SimpleParallel of four
     bench shells against the same in sequence (both timed), and a FITS
     shell through LightconeShell(path=...);
 19. runs the direct readout (models without halo_curves) of every runner
     at full width, each given its model behind HideCurves (only its
     displacement / projected / real, as tests/test_runners_extra.py:
     201-208 wraps one): the bench shell (K20, K21, K3), the tSZ paint at
     epsilon_max 5 (K20, K21), the anisotropic scatter shell (K20, K21,
     K14), the 3D ΔP(k) BaryonifyGrid and DMO paint at 256^3 and the 2D
     anisotropic grid at 2048^2 (K22, then K16 or K14) and the snapshot
     bench (K23): each direct map held in float64 on the card against its
     curve path to 1e-9 of the largest value (of the largest move for a
     baryonification; the shell's members within 1e-12 of the eps_max
     edge counted), each path driven in float32 (one warm call, two timed,
     the launch counts set to 0 just before and read just after) with its
     phases (host prep, radii, readout, apply, regrid or finish,
     download); then K20-K23 against their plain versions at the bench
     shapes, timed beside them: K22 on the 3D baryonify's first chunk of
     its largest size bucket, as the runner cuts it, with the readout's
     own values; K20's float64 r held to what the gap between the
     device's and torch's ring colatitudes explains, its layout (formed
     on the card) to row_layout's bit for bit and its pad slots to the
     fills they replace;
 20. closes the last gaps to the JAX package: after the tSZ paint, the
     paint with five per-halo properties (a ParamTabulatedProfile of the
     bench's Schneider19 Gas profile over theta_ej, theta_co, M_c, mu_beta
     and delta, two or three values each, built on the card and timed, a
     small one card vs CPU; the bench catalog with five columns of its
     own, some halos off an axis: K1's wide kernel (counted apart as
     collapse_curves_wide) as the runner calls it, timed with its bound,
     the tiled (K1, K10, K7) and disc (K1, K11) paints through drive(),
     their agreement, and the paint card vs CPU in float64 at NSIDE 64);
     K1 also at 5 and 6 parameter axes against its plain version (with the
     2-axis case, at NSIDE 64's 400 halos and the bench's 18,512, timed
     with its bound); at the end, the public ops.scatter.deposit_3d (256^3
     sources onto 256^3) and deposit_2d (2048^2 onto 2048^2), float32 and
     float64, with the launch counts set to 0 just before and read just
     after, against their plain versions and timed (3D float64 beside one
     torch.index_add of the corner shares); and fht past shared memory
     (1 x 16,384, 20 x 16,384, 200 x 8192, 1 x 2^22 and Bluestein at M =
     2^22, 1 x 2^28 and Bluestein at M = 2^28) against fht_plain, with the
     launches its plan predicts, timed beside fht_plain and the partial
     library call;
 21. prints the registers, spills and resident warps of K1's, K3's, K4's
     (with K10's and K12's, the same template), K5's, K8's, K11's, K13's,
     K16's, K17's, K19's and K24's kernels (nvcc -Xptxas -v on their
     sources), one JSON line with each kernel's launches, error, times, bound and
     library-call time, and last
     the line {"ok": true, "device": ...}.

A kernel's bound (bound_ms) is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its
operations over the H100's peak for their type (67 TFLOP/s float32, 34
TFLOP/s float64, outside the tensor cores), counted from this run's shapes
and data as ``bound()``'s callers state.

Any failed check raises, and the exit code is then not 0. Times are
informational: they hold for the card and power limit printed with them.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TABLE = os.path.join(HERE, "tools", "_northstar_table.npz")
TSZ_TABLE = os.path.join(HERE, "tests", "data", "tsz_bench_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
NSIDE, N_HALOS, SEED, EPS_MAX = 1024, 18512, 7, 20
DEVICE = "cuda"
N_CALLS = 10            # timed process() calls per path, after 2 warm ones
# the bench's Schneider19 parameters and table grid (bench.py:42-55)
H = 0.7
BPAR = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H, mu_beta=0.4,
            eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0,
            A=0.09 / 2, M1=2.5e11 / H, epsilon_h=0.015,
            a=0.3, n=2, epsilon=4, p=0.3, q=0.707, gamma=2, delta=7)
BENCH_GRID = dict(z_min=0.7, z_max=1.1, N_samples_z=8, M_min=5e12,
                  M_max=2e15, N_samples_Mass=20, R_min=1e-3, R_max=60,
                  N_samples_R=64, verbose=False)
SMALL_GRID = dict(BENCH_GRID, N_samples_z=2, N_samples_Mass=4,
                  N_samples_R=16)
# the paint's bench configuration: the README's epsilon_max for the tSZ
# paint, on the bench catalog; the north-star size (tools/northstar.py)
PAINT_EPS = 5
NS_NSIDE, NS_HALOS = 4096, 1_000_000
# the anisotropic paint's configuration (tools/anis_bench.py:60-93 on the
# bench catalog): epsilon_max 5 (PAINT_EPS), the shell at z 0.9, background
ANIS_Z, ANIS_BG, ANIS_FRAC = 0.9, 1.0, 0.1
# the grid configurations: the ΔP(k) recipe of examples/06_delta_pk.py:46-87
# (its cosmology and S19 parameters, seed 3, z 0.2, epsilon_max 10 paint and
# 20 baryonify, its table grids) at the reference's ΔP(k) size, 7,088 halos
# (BASELINE.md:13), in a 256 Mpc box: 256^3 cells, and 2048^2 in 2D
GRID_SEED, GRID_HALOS, GRID_Z, GRID_L = 3, 7088, 0.2, 256.0
GRID3D_N, GRID2D_N = 256, 2048
GRID_PAINT_EPS, GRID_BARYON_EPS, GRID_ANIS_EPS = 10, 20, 5
DMO_GRID = dict(z_min=0.1, z_max=0.3, N_samples_z=2, M_min=1e13, M_max=1e15,
                N_samples_Mass=8, R_min=1e-3, R_max=60, N_samples_R=64,
                verbose=False)
B_GRID = dict(z_min=0.1, z_max=0.3, N_samples_z=2, M_min=1e13, M_max=3e15,
              N_samples_Mass=8, R_min=1e-3, R_max=50, N_samples_R=48,
              verbose=False)
GRID_CALLS = 3          # timed process() calls per grid path, after one warm
# the remaining families' paths: the Arico20 fiducial set
# (examples/05_profile_gallery.py:34-41), Schneider25's bpar_S25
# (tests/defaults.py:21-29), Mead20's HMx T_AGN = 10^7.8 calibration
# (Tagn2pars, Mead20.py:471-476) and the Battaglia12 200_AGN electron
# pressure; each path one warm runner call and FAMILY_CALLS timed ones
A20 = dict(cdelta=4, alpha_g=2, epsilon_h=0.015, M1_0=2.2e11 / H,
           alpha_fsat=1, M1_fsat=1, delta_fsat=1, gamma_fsat=1,
           eps_fsat=1, M_c=1.2e14 / H, eta=0.6, mu=0.31, beta=0.6,
           epsilon_hydro=math.sqrt(5), M_inn=3.3e13 / H, M_r=1e16,
           beta_r=2, theta_inn=0.1, theta_out=3, theta_rg=0.3,
           sigma_rg=0.1, a=0.3, n=2, p=0.3, q=0.707,
           A_nt=0.495, alpha_nt=0.1, mean_molecular_weight=0.59)
S25 = dict(epsilon0=4, epsilon1=0.5, alpha_excl=0.4, p=0.3, q=0.707,
           M_c=1e15, mu=0.8,
           q0=0.075, q1=0.25, q2=0.7, nu_q0=0, nu_q1=1, nu_q2=0,
           nstep=3 / 2,
           theta_c=0.3, nu_theta_c=1 / 2, c_iga=0.1, nu_c_iga=3 / 2,
           r_min_iga=1e-3, alpha=1, gamma=3 / 2, delta=7,
           tau=-1.376, tau_delta=0, Mstar=3e11, Nstar=0.03,
           eta=0.1, eta_delta=0.22, epsilon_cga=0.03,
           alpha_nt=0.1, nu_nt=0.5, gamma_nt=0.8,
           mean_molecular_weight=0.6125)
M20_TAGN = 7.8
FAMILY_CALLS = 3
# the redesigned kernels' earlier times, not measured by this script (PERF.md
# §6, on an NVIDIA H100 80GB HBM3 at 700 W); printed beside this run's with
# that label
EARLIER_MS = {"grid_cutout": (37.545, "the atomic cutouts"),
              "ring_modes": (36.623, "the direct DFT"),
              "disc_deposit": (2.772, "the block-per-halo walk"),
              "tile_layout": (0.230, "the per-element slot math"),
              "stencil": (2.066, "a thread a slot, ring math a block"),
              "legendre_alm": (16.526, "a recurrence a ring"),
              "fht": (0.541, "the direct DFT"),
              "disc_paint_anis": (0.654, "the block-per-halo walk"),
              "snapshot_displace": (0.634, "a block a halo, atomics"),
              "grid_deposit": (0.933, "a thread a source, global atomics"),
              "tile_deposit": (0.509, "a thread a slot, f64 ring math a "
                               "slot"),
              "disc_paint": (0.450, "the block-per-halo walk"),
              "regrid": (0.2645, "pix2ang and ring_theta a pixel, an atomic "
                         "an unmoved pixel, a memset"),
              "collapse_curves": (0.1309, "a thread a (halo, radius), the "
                                  "set-up, M's upload and an expanded a a "
                                  "call"),
              "table_rows": (0.1916, "three launches a redshift, the scans "
                             "on one thread"),
              "stencil_finish": (0.0320, "a thread a source, 24 bytes of "
                                 "list a source, an atomic an unmoved one; "
                                 "in place"),
              "grid_direct": (12.89, "a 64-bit-index thread a cell, a "
                              "block for every tile, the group's 33 readout "
                              "chunks applied in turn, each with its lists "
                              "(chip_probes.py direct)"),
              "snapshot_direct": (1.0982, "a thread a pair with per-pair "
                                  "row and slot tensors, a thread a "
                                  "particle gathering slots"),
              "disc_radii": (2.62, "two walks around a copy of the counts "
                             "to the host, its numpy row_layout, the slot "
                             "fills and an upload of base (chip_probes.py "
                             "direct)"),
              "disc_apply": (0.151, "two scalar atomics a slot "
                             "(chip_probes.py direct)")}
# H100 SXM data sheet: HBM bytes/s, FLOP/s outside the tensor cores; and
# float64 instructions a second (an fma is one): 132 SMs x 64 a clock at
# the 1.98 GHz boost clock
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12
F64_INSTR = 132 * 64 * 1.98e9


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def bench_inputs(bf, nside, n_halos, seed):
    """Catalog and map exactly as bench.py:94-102 makes them."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halos)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos)))
    M = 10 ** rng.uniform(13.0, 14.8, n_halos)
    z = rng.uniform(0.8, 1.0, n_halos)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO)
    return cat, shell


def polar_inputs(bf, nside, n_halos, seed):
    """A small catalog with halos at dec +-89.5 and near the caps (as
    tests/test_tiled_deposit.py:23-24), a third at the table's lowest
    masses (discs under 4 pixels: the interpolation-neighbour fallback)."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halos)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos)))
    dec[2:18] = rng.uniform(77, 84, 16) * rng.choice([-1, 1], 16)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n_halos)
    M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.8, 1.0, n_halos)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO)
    return cat, shell


def time_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    from CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(torch, fn, n=20, reps=5):
    """Device milliseconds per call: ``n`` calls of ``fn`` captured in one
    CUDA graph (after a warm-up on a side stream), replayed ``reps`` times
    and timed by CUDA events, so the host's own time a call drops out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (reps * n)


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``peak``."""
    t_b, t_o = nbytes / HBM_BPS, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*objs):
    """Bytes of the tensors in ``objs`` (tensors, or dicts / tuples of
    them)."""
    import torch
    total = 0
    for o in objs:
        if isinstance(o, dict):
            o = list(o.values())
        if isinstance(o, (list, tuple)):
            total += nbytes(*o)
        elif isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
    return total


def s19_model(bf, device):
    """The bench's Schneider19 Baryonification2D, unbuilt, on ``device``."""
    return bf.Baryonification2D(
        bf.Profiles.DarkMatterOnly(**BPAR, proj_cutoff=100),
        bf.Profiles.DarkMatterBaryon(**BPAR, proj_cutoff=100),
        bf.cosmo.cosmology_from_dict(COSMO), epsilon_max=EPS_MAX,
        device=device)


def check(name, err, tol):
    log(f"  {name}: max_abs_err {err:.3e}  tolerance {tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{err:.3e} > {tol:.3e}")


def compare_kernels(bf, torch, model, cat, shell, label, timing):
    """Each kernel against its plain version on the card, on this catalog,
    in float64 and float32. Returns {kernel: (max_abs_err, ms, plain_ms)}
    for the float32 (main-path) configuration when ``timing``."""
    from baryonforge_torch.ops import deposit, interp, regrid
    from baryonforge_torch.ops import healpix as hpx
    dev = torch.device(DEVICE)
    nside = shell.NSIDE
    runner = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                               model=model, deposit="scatter",
                               regrid="scatter", device=dev)
    hd = runner._host_halo_data(
        bf.cosmo.cosmology_from_dict(runner.cosmo))
    halos = runner._halo_tensors(hd)
    orig64 = torch.as_tensor(shell.map, device=dev)
    out = {}
    for dt in (torch.float64, torch.float32):
        tag = f"{label} {str(dt).replace('torch.', '')}"
        m = model.with_dtype(dt, device=dev)
        args = (m._table, m._axes, 2, hd["M"], hd["a"], [], {})
        # the runner's call: the model's kept K1 set-up, M and a among the
        # runner's float64 halo columns on the card
        ck, r0, dl = m.halo_curves(halos["M"], halos["a"])
        ch = m.halo_curves(hd["M"], hd["a"])[0]
        cp, _, _ = interp.collapse_curves_plain(*args)
        torch.cuda.synchronize()
        err1 = max((ck - cp).abs().max().item(),
                   (ch - cp).abs().max().item())
        rel = 1e-6 if dt == torch.float32 else 1e-12
        check(f"K1 collapse_curves [{tag}]", err1,
              rel * cp.abs().max().item())
        r0, dl = float(r0), float(dl)

        pk = deposit.disc_deposit(nside, halos, cp, r0, dl, EPS_MAX)
        pp = deposit.disc_deposit_plain(nside, halos, cp, r0, dl, EPS_MAX)
        torch.cuda.synchronize()
        scale = pp.abs().max().item()
        diff = (pk - pp).abs()
        err2 = diff.max().item()
        if dt == torch.float64:
            # atomic sums in another order
            check(f"K2 disc_deposit [{tag}]", err2, 1e-10 * scale)
        else:
            # float32: a pixel on a disc edge can flip in or out; the JAX
            # package's edge-jitter bounds (tests/test_tiled_deposit.py:61-63)
            check(f"K2 disc_deposit [{tag}]", err2, 0.02 * scale)
            check(f"K2 disc_deposit summed [{tag}]", diff.sum().item(),
                  3e-3 * pp.abs().sum().item())

        for rdt in (torch.float64, torch.float32):
            rtag = f"{tag} offsets, {str(rdt).replace('torch.', '')} map"
            orig = orig64.to(rdt)
            ok = regrid.regrid(nside, pp, orig)
            op = regrid.regrid_plain(nside, pp, orig)
            torch.cuda.synchronize()
            err3 = (ok - op).abs().max().item()
            if rdt == torch.float64:
                # tests/test_tiled_deposit.py:80, summation order only
                tol3 = 1e-9 * (op - orig).abs().max().item()
            else:
                # float32 weights carry ~1e-6 * nside of noise
                tol3 = 1e-6 * nside * orig.abs().max().item()
            check(f"K3 regrid [{rtag}]", err3, tol3)
            dm = abs(ok.double().sum().item() / orig64.sum().item() - 1.0)
            check(f"K3 regrid mass [{rtag}]", dm, 1e-5)

        if timing and dt == torch.float32:
            orig = orig64.to(torch.float32)
            ok = regrid.regrid(nside, pk, orig)
            op = regrid.regrid_plain(nside, pk, orig)
            torch.cuda.synchronize()
            n, nr = cp.shape
            npix = 12 * nside * nside
            # K1: per output value 4 corner weights and multiply-adds; timed
            # from host columns (one upload, one launch: the call that the
            # paint, grid and snapshot runners make, and the one timed
            # before the set-up was kept), as the shell runner calls it (its
            # float64 M and a on the card, one launch) and on the device
            # alone
            def runner_call():
                return m.halo_curves(halos["M"], halos["a"])
            out["collapse_curves"] = (err1, time_ms(
                torch, lambda: m.halo_curves(hd["M"], hd["a"]), 50),
                time_ms(torch, lambda: interp.collapse_curves_plain(*args),
                        10)) + bound(
                nbytes(m._table, m._axes, cp) + 2 * 8 * n, 16 * n * nr,
                F32_FLOPS) + (None,)
            k1_runner = time_ms(torch, runner_call, 50)
            k1_alone = graph_ms(torch, runner_call)
            log(f"  K1 at the bench: from host columns "
                f"{out['collapse_curves'][1]:.4f} ms, the shell runner's "
                f"call {k1_runner:.4f} ms, the device alone {k1_alone:.4f} "
                f"ms (targets 0.05, 0.010)")
            # K2: the member pixels of these discs, ~40 operations each;
            # the (npix, 2) offsets written once
            mh = torch.bincount(deposit.disc_members_plain(
                nside, halos, dt)[0], minlength=n)
            pairs = float(mh.sum())
            log(f"  K2 members at the bench: {int(mh.sum())} in all, "
                f"{int(mh.max())} in the largest disc")
            out["disc_deposit"] = (err2, time_ms(
                torch, lambda: deposit.disc_deposit(nside, halos, cp, r0, dl,
                                                    EPS_MAX), 10),
                time_ms(torch, lambda: deposit.disc_deposit_plain(
                    nside, halos, cp, r0, dl, EPS_MAX), 3)) + bound(
                nbytes(halos, cp, pk), 40 * pairs, F32_FLOPS) + (None,)
            # K3: per pixel its offset and value read, its value written,
            # ~60 operations of neighbour geometry and weights; the library
            # yardstick (partial): one index_add_ of the (pixel, weight x
            # value) shares, formed beforehand, untimed: a moved pixel's 4,
            # an unmoved pixel's own (displaced_weights' 3 zero-weight
            # shares of pixel 0 dropped, which would put ~3 npix atomics on
            # one address)
            p_all = torch.arange(npix, dtype=torch.int32, device=dev)
            th_p, ph_p = hpx.pix2ang(nside, p_all, torch.float32)
            cpix, cw = regrid.displaced_weights(nside, torch.float32, p_all,
                                                pk, th_p, ph_p)
            keep = ((pk != 0).any(1)[:, None]
                    | (torch.arange(4, device=dev) == 0)).reshape(-1)
            idx = cpix.reshape(-1)[keep].long()
            val = (cw * orig[:, None]).reshape(-1)[keep]
            del th_p, ph_p, cpix, cw, keep

            def library():
                return torch.zeros(npix, dtype=torch.float32,
                                   device=dev).index_add_(0, idx, val)
            check("K3 library yardstick", (library() - op).abs().max().item(),
                  1e-6 * nside * orig.abs().max().item())
            moved = int((pk != 0).any(1).sum())
            out["regrid"] = ((ok - op).abs().max().item(), time_ms(
                torch, lambda: regrid.regrid(nside, pk, orig), 20),
                time_ms(torch, lambda: regrid.regrid_plain(nside, pk, orig),
                        3)) + bound(nbytes(pk, orig, op), 60 * npix,
                                    F32_FLOPS) + (time_ms(torch, library, 10),)
            del idx, val
            k3_alone = graph_ms(torch, lambda: regrid.regrid(nside, pk, orig))
            log(f"  K3 at the bench: {moved} of {npix} pixels moved; wrapper "
                f"{out['regrid'][1]:.4f} ms, the device alone {k3_alone:.4f} "
                f"ms (target 0.15); library (partial: one index_add_ of the "
                f"{npix + 3 * moved} shares formed beforehand) "
                f"{out['regrid'][5]:.4f} ms")
    return out


def layout_cases(torch):
    """K7 on the shell's 16 x 32 and the paint's 8 x 16 tilings at NSIDE
    64, 256 and 1024, for C = 1 and 2, float32 and float64: both views
    equal to their plain versions, and flat_view undoes tile_view."""
    from baryonforge_torch.ops import tiles as tt
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(3)
    n = 0
    for nside in (64, 256, 1024):
        for shape in ((16, 32), (8, 16)):
            tiling = tt.SkyTiling(nside, *shape)
            for dt in (torch.float32, torch.float64):
                for trail in ((), (2,)):
                    flat = torch.randn((tiling.npix,) + trail, dtype=dt,
                                       device=dev, generator=g)
                    tk = tiling.tile_view(flat)
                    fk = tiling.flat_view(tk)
                    if not (torch.equal(tk, tiling.tile_view_plain(flat))
                            and torch.equal(fk, tiling.flat_view_plain(tk))
                            and torch.equal(fk, flat)):
                        raise AssertionError(
                            f"K7 NSIDE {nside} {shape} {dt} C "
                            f"{trail or 1}: kernel and plain differ")
                    n += 1
    log(f"  K7 tile_view / flat_view: {n} cases (NSIDE 64, 256, 1024; "
        "16 x 32 and 8 x 16; C 1, 2; f32, f64) equal to the plain versions")


def disc_cases(bf, torch, model):
    """K2 against its plain version on discs that the bench catalog lacks:
    at NSIDE 1024, the polar catalog of 300 halos, with a disc across phi
    = 0 from either side, two under 4 members, one through each pole, and
    five of 1.2 to 8 degrees (walked by a whole block; the widest over
    two chunks of rings), with Rcom and rscale set so that every member
    moves; float64 and float32, to compare_kernels' bounds."""
    from baryonforge_torch.ops import deposit, interp
    dev = torch.device(DEVICE)
    nside, n = 1024, 300
    cat, shell = polar_inputs(bf, nside, n, SEED)
    runner = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                               device=dev)
    hd = runner._host_halo_data(bf.cosmo.cosmology_from_dict(runner.cosmo))
    for dt in (torch.float64, torch.float32):
        tag = f"NSIDE {nside} discs {str(dt).replace('torch.', '')}"
        halos = runner._halo_tensors(hd)
        m = model.with_dtype(dt, device=dev)
        cp, r0, dl = interp.collapse_curves_plain(
            m._table, m._axes, 2, hd["M"], hd["a"], [], {})
        r0, dl = float(r0), float(dl)
        pix = math.pi / (2 * nside)
        for i, th, ph, rad in ((6, None, 0.2 * pix, None),
                               (7, None, 2 * math.pi - 0.4 * pix, None),
                               (8, 1.3, 0.7, 0.3 * pix),
                               (9, 2.2, 5.1, 0.6 * pix),
                               (10, 0.2 * pix, 1.0, 2.5 * pix),
                               (11, math.pi - 0.3 * pix, 3.0, 3.0 * pix)):
            if th is not None:
                halos["theta"][i] = th
            halos["phi"][i] = ph
            if rad is not None:
                halos["radius"][i] = rad
        for i, th, ph, deg in ((0, None, None, 2.0), (1, None, None, 1.5),
                               (3, 1.2, 0.3 * pix, 1.2),
                               (4, 1.6, 2 * math.pi - 0.6 * pix, 8.0),
                               (5, 0.9, 4.0, 3.0)):
            if th is not None:
                halos["theta"][i] = th
                halos["phi"][i] = ph
            rad = math.radians(deg)
            halos["radius"][i] = rad
            halos["Rcom"][i] = 1e30
            r_max = 2 * math.sin(rad / 2) * float(halos["D"][i]
                                                  / halos["a"][i])
            halos["rscale"][i] = math.exp(r0 + dl * (cp.shape[1] - 2)) / r_max
        walk = deposit.disc_walk_plain(nside, halos["theta"], halos["phi"],
                                       halos["radius"], dt)
        counts = torch.bincount(deposit.disc_members_plain(
            nside, halos, dt)[0], minlength=n)
        if not (int(walk["block"].sum()) >= 5 and int(
                walk["n_rings"].max()) > 256 and (counts < 4).any()):
            raise AssertionError(f"K2 [{tag}]: the cases miss a route")
        pk = deposit.disc_deposit(nside, halos, cp, r0, dl, EPS_MAX)
        pp = deposit.disc_deposit_plain(nside, halos, cp, r0, dl, EPS_MAX)
        torch.cuda.synchronize()
        scale = pp.abs().max().item()
        diff = (pk - pp).abs()
        log(f"  [{tag}] {int((counts < 4).sum())} discs under 4 members, "
            f"{int(walk['block'].sum())} on the block route (up to "
            f"{int(walk['n_rings'].max())} rings), {int(counts.sum())} "
            "members")
        if dt == torch.float64:
            check(f"K2 disc_deposit [{tag}]", diff.max().item(),
                  1e-10 * scale)
        else:
            check(f"K2 disc_deposit [{tag}]", diff.max().item(),
                  0.02 * scale)
            check(f"K2 disc_deposit summed [{tag}]", diff.sum().item(),
                  3e-3 * pp.abs().sum().item())


def pole_regrid(bf, torch, nside):
    """K3 against its plain version with polar pixels pushed through the
    poles (theta < 0 and > pi after the move: the reflection)."""
    from baryonforge_torch.ops import healpix as hpx
    from baryonforge_torch.ops import regrid
    dev = torch.device(DEVICE)
    npix = 12 * nside * nside
    rng = np.random.default_rng(5)
    theta, _ = hpx.pix2ang(nside, torch.arange(npix, dtype=torch.int32))
    theta = theta.numpy()
    po = np.zeros((npix, 2), np.float32)
    north = np.where(theta < 3.0 / nside)[0]
    south = np.where(theta > np.pi - 3.0 / nside)[0]
    po[north, 0] = -theta[north] * rng.uniform(1.2, 2.5, north.size)
    po[south, 0] = (np.pi - theta[south]) * rng.uniform(1.2, 2.5, south.size)
    po_t = torch.as_tensor(po, device=dev)
    for rdt in (torch.float64, torch.float32):
        orig = torch.as_tensor(rng.exponential(1.0, npix), device=dev).to(rdt)
        ok = regrid.regrid(nside, po_t, orig)
        op = regrid.regrid_plain(nside, po_t, orig)
        torch.cuda.synchronize()
        tol = (1e-9 * (op - orig).abs().max().item() if rdt == torch.float64
               else 1e-6 * nside * orig.abs().max().item())
        check(f"K3 regrid pole overshoot [{rdt}]",
              (ok - op).abs().max().item(), tol)


def plain_pipeline(bf, torch, runner):
    """The scatter path with the plain versions on the card: what
    process() runs, without the kernels. Returns (map, seconds)."""
    from baryonforge_torch.ops import deposit, interp, regrid
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hd = runner._host_halo_data(bf.cosmo.cosmology_from_dict(runner.cosmo))
    halos = runner._halo_tensors(hd)
    orig = torch.as_tensor(runner.LightconeShell.map,
                           device=dev).to(runner.regrid_dtype)
    m = runner.model.with_dtype(runner.dtype, device=dev)
    curves, r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, hd["M"], hd["a"], [], {})
    po = deposit.disc_deposit_plain(runner.LightconeShell.NSIDE, halos,
                                    curves, float(r0), float(dl), EPS_MAX)
    new = regrid.regrid_plain(runner.LightconeShell.NSIDE, po, orig)
    out = new.cpu().numpy().astype(np.float64)
    return out, time.perf_counter() - t0


def tiled_inputs(torch, runner, hd):
    """The tile deposit's inputs as the default path builds them (its host
    binning, pruning and CSR grouping) in the runner's dtype, with curves
    from K1's plain version. The halos are those the path routes to the
    tiles, or every halo where all discs are small (the polar catalog), so
    that K4 has work."""
    from baryonforge_torch.ops import interp
    from baryonforge_torch.ops import tiles as tt
    dev = torch.device(DEVICE)
    nside = runner.LightconeShell.NSIDE
    tiling = runner._get_tiling(nside)
    small = runner._small_disc_mask(hd, nside)
    idx = np.where(~small)[0] if (~small).any() else np.arange(small.size)
    th, ph, rad = hd["theta"][idx], hd["phi"][idx], hd["radius"][idx]
    st = np.sin(th)
    vh = np.stack([st * np.cos(ph), st * np.sin(ph), np.cos(th)], 1)
    t_ids, h_ids = tt.bin_halos_to_tiles(tiling, th, ph, rad)
    t_ids, h_ids = tt.refine_pairs(tiling, t_ids, h_ids, vh,
                                   2.0 * np.sin(np.minimum(rad, np.pi) / 2))
    csr = tuple(torch.as_tensor(x, device=dev)
                for x in tt.pairs_csr(t_ids, idx[h_ids]))
    pack = runner._tile_base_pack(hd)
    m = runner.model.with_dtype(runner.dtype, device=dev)
    pack["curves"], r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, hd["M"], hd["a"], [], {})
    return tiling, csr, pack, float(r0), 1.0 / float(dl), idx.size


def compare_tiled_kernels(bf, torch, model, cat, shell, label, timing):
    """K4, K5, K6 and K7 against their plain versions on the card, on this
    catalog, with the deposit and the regrid in float64 and in float32.
    Returns {kernel: (max_abs_err, ms, plain_ms)} for float32 when
    ``timing``."""
    from baryonforge_torch.ops import stencil as st
    from baryonforge_torch.ops import tile_deposit as td
    dev = torch.device(DEVICE)
    nside = shell.NSIDE
    orig64 = torch.as_tensor(shell.map, device=dev)
    out = {}
    for dt in (torch.float64, torch.float32):
        tag = f"{label} {str(dt).replace('torch.', '')}"
        runner = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                   model=model, dtype=dt, device=dev)
        hd = runner._host_halo_data(
            bf.cosmo.cosmology_from_dict(runner.cosmo))
        tables = runner._stencil_tables(nside)
        tiling, csr, pack, r0, inv, n_h = tiled_inputs(torch, runner, hd)
        ak = td.tile_deposit(tiling, csr, pack, r0, inv)
        ap = td.tile_deposit_plain(tiling, csr, pack, r0, inv)
        torch.cuda.synchronize()
        scale = ap.abs().max().item()
        diff = (ak - ap).abs()
        err4 = diff.max().item()
        log(f"  [{tag}] K4 on {n_h} halos, {csr[0].numel()} tiles, "
            f"{csr[2].numel()} pairs")
        if not scale > 0:
            raise AssertionError(f"K4 [{tag}]: the deposit moved nothing")
        if dt == torch.float64:
            check(f"K4 tile_deposit [{tag}]", err4, 1e-10 * scale)
        else:
            check(f"K4 tile_deposit [{tag}]", err4, 0.02 * scale)
            check(f"K4 tile_deposit summed [{tag}]", diff.sum().item(),
                  3e-3 * ap.abs().sum().item())

        # the checks below take these offsets with two tiles made hot (a
        # move of 0.05 rad), so that the complement's hot-tile route runs
        ap_main = ap
        ap = ap.clone()
        ap[tiling.n_tiles // 3, :, 0] = 0.05
        ap[2 * tiling.n_tiles // 3, 5:40, 1] = -0.05
        orig = orig64.to(dt)
        og_k = tiling.tile_view(orig)
        og_p = tiling.tile_view_plain(orig)
        fl_k = tiling.flat_view(ap)
        torch.cuda.synchronize()
        err7 = max((og_k - og_p).abs().max().item(),
                   (fl_k - tiling.flat_view_plain(ap)).abs().max().item(),
                   (tiling.flat_view(og_k) - orig).abs().max().item())
        check(f"K7 tile_view / flat_view [{tag}] (equality)", err7, 0.0)

        ek = st.hot_tiles(ap, tables)
        ep = st.hot_tiles_plain(ap, tables)
        torch.cuda.synchronize()
        n_diff = int((ek != ep).sum().item())
        check(f"K5 stencil_hot [{tag}] (tiles that differ)", n_diff, 0)
        sk = st.stencil_regrid(tiling, tables, ap, og_p, ep)
        sp = st.stencil_regrid_plain(tiling, tables, ap, og_p, ep)
        torch.cuda.synchronize()
        err5 = (sk - sp).abs().max().item()
        rel = 1e-12 if dt == torch.float64 else 1e-5
        check(f"K5 stencil [{tag}]", err5, rel * orig.abs().max().item())
        hot = torch.nonzero(ep & ~tables["D_geom"])[:, 0].to(torch.int32)
        log(f"  [{tag}] excluded tiles {int(ep.sum())} of {tiling.n_tiles}, "
            f"hot {hot.numel()}")

        gk = st.stencil_geo(tiling, tables, dt)
        gp = st.stencil_geo_plain(tiling, tables, dt)
        torch.cuda.synchronize()
        n_int = sum(int((a != b).sum().item()) for a, b in zip(gk[:2], gp[:2]))
        check(f"K6 stencil_geo ids [{tag}] (entries that differ)", n_int, 0)
        err_ang = (gk[2] - gp[2]).abs().max().item()
        # the device's asin / sin against torch's: a few ulps
        check(f"K6 stencil_geo ring table [{tag}]", err_ang,
              16 * torch.finfo(dt).eps)
        base = tiling.flat_view_plain(sp)
        fk = st.stencil_complement(tiling, base.clone(), ap, og_p, gp, hot)
        fp = st.stencil_complement_plain(tiling, base.clone(), ap, og_p, gp,
                                         hot)
        torch.cuda.synchronize()
        err6 = (fk - fp).abs().max().item()
        if dt == torch.float64:
            check(f"K6 stencil_complement [{tag}]", err6,
                  1e-9 * (fp - orig).abs().max().item())
        else:
            check(f"K6 stencil_complement [{tag}]", err6,
                  1e-6 * nside * orig.abs().max().item())
        dm = abs(fk.double().sum().item() / orig64.sum().item() - 1.0)
        check(f"K5+K6 mass [{tag}]", dm, 1e-5 if dt == torch.float32
              else 1e-10)

        if timing and dt == torch.float32:
            # the main path's own offsets
            ap = ap_main
            hot = torch.nonzero(st.hot_tiles(ap, tables)
                                & ~tables["D_geom"])[:, 0].to(torch.int32)
            base = tiling.flat_view_plain(
                st.stencil_regrid_plain(tiling, tables, ap, og_p,
                                        st.hot_tiles_plain(ap, tables)))
            slots = tiling.n_tiles * tiling.P
            # K4: every (tile, halo) pair's slots, ~40 operations each; the
            # accumulator written once
            out["tile_deposit"] = (err4, time_ms(
                torch, lambda: td.tile_deposit(tiling, csr, pack, r0, inv),
                20), time_ms(torch, lambda: td.tile_deposit_plain(
                    tiling, csr, pack, r0, inv), 3)) + bound(
                nbytes(csr, pack, ap), 40.0 * csr[2].numel() * tiling.P,
                F32_FLOPS) + (None,)
            # K5: offsets and tiled map read, stencil output written; the
            # regrid needs ~60 operations per pixel (K3's count for the same
            # regrid: neighbour geometry and weights), not the 55 taps per
            # slot the stencil evaluates
            out["stencil"] = (err5, time_ms(torch, lambda: st.stencil_regrid(
                tiling, tables, ap, og_p, st.hot_tiles(ap, tables)), 20),
                time_ms(torch, lambda: st.stencil_regrid_plain(
                    tiling, tables, ap, og_p,
                    st.hot_tiles_plain(ap, tables)), 3)) + bound(
                nbytes(ap, og_p) + slots * 4, 60.0 * tiling.npix,
                F32_FLOPS) + (None,)
            # the two entries apart, the stencil on the main path's own
            # exclusions; the share of tap rows the stencil runs
            ex = st.hot_tiles(ap, tables)
            hot_ms = time_ms(torch, lambda: st.hot_tiles(ap, tables), 20)
            st_ms = time_ms(torch, lambda: st.stencil_regrid(
                tiling, tables, ap, og_p, ex), 20)
            live = st.stencil_weights_plain(tiling, tables, ap, og_p,
                                            ex)[1]["live"]
            out["stencil_entries"] = (hot_ms, st_ms,
                                      float(live.double().mean()))
            # K6, in place on one map as the engine calls it (an earlier
            # timing here cloned the 50 MB map each call, ~0.037 ms). Bound:
            # the sources' offsets and values read once, each touched pixel
            # read and written once; ~80 operations a moved source. The
            # library yardstick: one index_add_ of the shares, formed
            # beforehand, untimed, as the kernel's work is (4 a moved
            # source, its own pixel's for an unmoved one)
            idx, vals, n_src, n_moved = k6_shares(torch, tiling, ap, og_p,
                                                  gp, hot)
            n_touched = int(idx.unique().numel())
            k6_bytes = (n_src * (2 * ap.element_size() + og_p.element_size())
                        + 2 * n_touched * og_p.element_size())
            buf, lib_buf = base.clone(), base.clone()

            def k6_kernel():
                return st.stencil_complement(tiling, buf, ap, og_p, gp, hot)

            def k6_library():
                return lib_buf.index_add_(0, idx, vals)
            out["stencil_finish"] = (err6, time_ms(torch, k6_kernel, 50),
                                     time_ms(torch, lambda: (
                                         st.stencil_complement_plain(
                                             tiling, base.clone(), ap, og_p,
                                             gp, hot)), 3)) + bound(
                k6_bytes, 80.0 * n_moved, F32_FLOPS) + (
                time_ms(torch, k6_library, 50),)
            log(f"[{gpu_line()}] K6 stencil_complement: {n_src} sources, "
                f"{n_moved} moved, {n_touched} pixels touched; kernel "
                f"{out['stencil_finish'][1]:.4f} ms a wrapper call, the "
                f"device alone {graph_ms(torch, k6_kernel):.4f} ms; bound "
                f"{out['stencil_finish'][3]:.4f} ms "
                f"({out['stencil_finish'][4]}; {k6_bytes} bytes; the "
                f"earlier bound 0.0112 counted 56 bytes a source); library "
                f"(index_add_ of {idx.numel()} shares, partial) "
                f"{out['stencil_finish'][5]:.4f} ms, the device alone "
                f"{graph_ms(torch, k6_library):.4f} ms")
            # K7: tile_view then flat_view, each reading and writing its
            # map once; the library yardstick is the same two gathers as
            # torch.index_select with precomputed indices (dead slots read
            # pixel 0 instead of giving 0)
            arr = tiling.device_arrays(dev)
            pix, valid = tiling.slot_pix(arr["tile_i0"], arr["tile_s"],
                                         arr["tile_S"])
            idx_t = torch.where(valid, pix, 0).reshape(-1).long()
            idx_f = tiling.slot_index(torch.arange(
                tiling.npix, dtype=torch.int32, device=dev)).long()

            def gathers():
                tv = torch.index_select(orig, 0, idx_t)
                return torch.index_select(tv, 0, idx_f)
            if not torch.equal(gathers(), orig):
                raise AssertionError("index_select yardstick of K7 is wrong")
            out["tile_layout"] = (err7, time_ms(
                torch, lambda: tiling.flat_view(tiling.tile_view(orig)), 20),
                time_ms(torch, lambda: tiling.flat_view_plain(
                    tiling.tile_view_plain(orig)), 3)) + bound(
                2 * (nbytes(orig) + slots * 4), 0.0, F32_FLOPS) + (
                time_ms(torch, gathers, 20),)
            geo_ms = (time_ms(torch, lambda: st.stencil_geo(tiling, tables,
                                                            dt), 5),
                      time_ms(torch, lambda: st.stencil_geo_plain(
                          tiling, tables, dt), 3))
            # K6 stencil_geo: the geometric tiles' ids, offsets and tile
            # records read once, each listed slot's id and pixel and the
            # ring table written once; ~30 operations a listed slot (ring
            # geometry, pixel index)
            n_g = tables["g_tids"].numel()
            geo_bound = bound(n_g * (4 + 4 + 3 * 4) + nbytes(gk),
                              30.0 * gk[0].numel(), F32_FLOPS)
            log(f"  K6 stencil_geo (once per NSIDE): kernel {geo_ms[0]:.3f} "
                f"ms, plain {geo_ms[1]:.3f} ms, bound {geo_bound[0]:.4f} ms "
                f"({geo_bound[1]}), {gk[0].numel()} slots of {n_g} tiles")
    return out


def k6_shares(torch, tiling, acc, og, geo, hot):
    """K6's work at these offsets, from the plain version's pieces: (the
    flat indices and values of its shares, 4 a moved source and one, to
    its own pixel, an unmoved source; the number of sources; the number
    moved). The sources are the geometric list's and the hot tiles' valid
    slots."""
    from baryonforge_torch.ops import regrid
    from baryonforge_torch.ops import stencil as st
    dev = og.device
    sf, gpix, rows = geo
    h = hot.long()
    arr = tiling.device_arrays(dev)
    hpix, valid = tiling.slot_pix(arr["tile_i0"][h], arr["tile_s"][h],
                                  arr["tile_S"][h])
    hslot = (h[:, None] * tiling.P
             + torch.arange(tiling.P, device=dev)).reshape(-1)
    slot = torch.cat([sf.long(), hslot[valid.reshape(-1)]])
    pix = torch.cat([gpix, hpix.reshape(-1)[valid.reshape(-1)].to(
        torch.int32)])
    po = acc.reshape(-1, 2)[slot]
    val = og.reshape(-1)[slot]
    moved = ~(po == 0).all(1)
    th, ph = st.source_angles_plain(tiling.nside, pix[moved], rows)
    cpix, cw = regrid.displaced_weights(tiling.nside, og.dtype, pix[moved],
                                        po[moved], th, ph)
    idx = torch.cat([pix[~moved].long(), cpix.reshape(-1).long()])
    vals = torch.cat([val[~moved], (cw * val[moved, None]).reshape(-1)])
    return idx, vals, slot.numel(), int(moved.sum())


# the parameter axes' sizes of p_key_curves' tables (their first P)
P_SHAPE = (4, 3, 2, 3, 2, 3)


def k1_name(n_p):
    """K1's launch count for a table of ``n_p`` parameter axes: the wide
    kernel's from five on."""
    return "collapse_curves_wide" if n_p > 4 else "collapse_curves"


def p_key_curves(torch, n, timing, n_ps=(2,)):
    """K1 against its plain version on tables of the bench table's 8 x 20 x
    64 with P parameter axes (P_SHAPE's first P; P of ``n_ps``; 5 and 6
    run the wide kernel), made from a seed, for ``n`` halos, a few of them
    off each parameter axis (rows of 0), in float64 and float32 (to 1e-12
    and 1e-6 of the largest |curve|), one launch a call. Returns {P: (err,
    ms, plain_ms, bound_ms, bound_by, alone_ms)} of the float32 tables
    when ``timing``: timed from host columns, and on the device alone (the
    columns on the card, a CUDA graph of 20 calls)."""
    from baryonforge_torch.ops import _build, interp
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    res = {}
    for n_p in n_ps:
        shape = (8, 20, 64) + P_SHAPE[:n_p]
        keys = [f"p{k}" for k in range(n_p)]
        for dt in (torch.float64, torch.float32):
            axes = tuple(torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, k)),
                                         dtype=dt, device=dev)
                         for k in shape)
            table = torch.as_tensor(rng.normal(size=shape), dtype=dt,
                                    device=dev)
            lo = [ax[0].item() for ax in axes]
            hi = [ax[-1].item() for ax in axes]
            M = np.exp(rng.uniform(lo[1], hi[1], n))
            a = 1.0 / np.exp(rng.uniform(lo[0], hi[0], n))
            p = {k: rng.uniform(lo[3 + j], hi[3 + j], n)
                 for j, k in enumerate(keys)}
            for j, k in enumerate(keys):
                p[k][j] = hi[3 + j] + 0.1
            args = (table, axes, 2, M, a, keys, p)
            _build.reset_launches()
            ck = interp.collapse_curves(*args)[0]
            if dict(_build.launches) != {k1_name(n_p): 1}:
                raise AssertionError(f"K1 with {n_p} parameter axes: "
                                     f"{dict(_build.launches)}")
            cp = interp.collapse_curves_plain(*args)[0]
            torch.cuda.synchronize()
            if not ((cp[:n_p] == 0).all() and (cp[n_p:] != 0).any(1).all()):
                raise AssertionError(f"K1 with {n_p} parameter axes: the "
                                     "rows off an axis are not the fill")
            err = (ck - cp).abs().max().item()
            rel = 1e-6 if dt == torch.float32 else 1e-12
            check(f"K1 collapse_curves, {n_p} parameter axes [{n} halos, "
                  f"{dt}]", err, rel * cp.abs().max().item())
            if timing and dt == torch.float32:
                ct = interp.CurveTable(table, axes, 2, keys)
                # the table, the host columns and the curves once; per
                # output value a multiply and an add a corner
                on = {k: torch.as_tensor(v, device=dev) for k, v in p.items()}
                Md, ad = (torch.as_tensor(v, device=dev) for v in (M, a))
                res[n_p] = (err, time_ms(torch, lambda: ct.collapse(M, a, p),
                                         20),
                            time_ms(torch, lambda:
                                    interp.collapse_curves_plain(*args),
                                    3)) + bound(
                    nbytes(table, axes, cp) + 8 * n * (2 + n_p),
                    2 * cp.numel() * 2 ** (2 + n_p), F32_FLOPS) + (
                    graph_ms(torch, lambda: ct.collapse(Md, ad, on)),)
    return res


def k9_inputs(bf, torch):
    """K9's inputs at the bench table's first redshift, as
    setup_interpolator forms them: ((intgd, dens) of the DMO profile, the
    same of the DMB profile), each (20, 500) clipped at 0, and lnr_int
    (500,), lnr (64,), float64 on the card."""
    dev = torch.device(DEVICE)
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    a0 = 1.0 / (1.0 + BENCH_GRID["z_min"])
    m = s19_model(bf, dev)
    r = np.geomspace(BENCH_GRID["R_min"], BENCH_GRID["R_max"],
                     BENCH_GRID["N_samples_R"])
    M = torch.as_tensor(np.geomspace(BENCH_GRID["M_min"], BENCH_GRID["M_max"],
                                     BENCH_GRID["N_samples_Mass"]),
                        device=dev)
    r_int = np.geomspace(min(r.min(), m.r_min_int) / 1.2,
                         max(r.max(), m.r_max_int) * 1.2, m.N_int)
    lnr_int = torch.log(torch.as_tensor(r_int, device=dev))
    lnr = torch.log(torch.as_tensor(r, device=dev))
    dlnr = float(np.log(r_int[1] / r_int[0]))
    ins = []
    for prof in (m.DMO, m.DMB):
        dens = prof.projected(cosmo, r_int, M, a0) * a0
        intgd = 2 * np.pi * torch.exp(lnr_int) ** 2 * dens * dlnr
        ins.append((intgd.clamp(min=0), dens.clamp(min=0)))
    return tuple(ins), lnr_int, lnr


def compare_table_kernels(bf, torch, gpu):
    """K8 and K9 against their plain versions on the card, float64, at the
    table build's shapes. Returns {kernel: (max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms)}, timed on correlation_3d's grid for K8
    and on one redshift's rows (two enclosed-mass calls and one
    displacement call) for K9."""
    from baryonforge_torch.cosmo import power
    from baryonforge_torch.ops import fftlog, table_rows
    dev = torch.device(DEVICE)
    out = {}
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    a0 = 1.0 / (1.0 + BENCH_GRID["z_min"])

    def fht_case(label, x, a, mu, q, reps):
        lx, ln_kcrc = fftlog._fht_grids(x, 1.0)
        qs = fftlog._safe_q(mu, q)
        B, N = a.shape
        plan = fftlog.fht_plan(N, fftlog.shared_memory_optin(dev), B,
                               sm_count(torch))

        def kern():
            return fftlog.fht(x, a, mu, q)[1]

        def plain():
            return fftlog.fht_plain(a, lx, mu, qs, ln_kcrc)
        ok, op = kern(), plain()
        torch.cuda.synchronize()
        err = (ok - op).abs().max().item()
        # K8's FFT sums against torch.fft's, each row against its own
        # largest value. Two correct orders of the sums (the JAX package's
        # matmul DFT and torch.fft) differ by up to 2.2e-12 of a row's
        # largest value on the 20 x 2048 batch
        # (tests/test_torch_fftlog.py::test_fht_summation_orders), so the
        # bound is 1e-11
        rel = ((ok - op).abs() / op.abs().amax(-1, keepdim=True)).max()
        route = fht_route(plan)
        check(f"K8 fht [{label}; {route}] (per row, of the row's largest "
              "value)", rel.item(), 1e-11)
        # what the function needs: per row two real-data FFTs (2.5 N log2 N
        # operations each), the bias and unbias products and the product
        # with the coefficients (~8 operations a point); once for all rows
        # the bias and unbias factors (an exp each, ~20 operations a point)
        # and the coefficients of the N/2 + 1 distinct frequencies (the
        # others are their conjugates), ~450 operations each (two Lanczos
        # log-gammas with their complex logs, a complex exponential)
        ops = (B * (5.0 * N * math.log2(N) + 8.0 * N) + 40.0 * N
               + 450.0 * (N // 2 + 1))
        # the library yardstick, partial: torch.fft.fft of the biased rows,
        # the product with the coefficients (formed beforehand, untimed) and
        # torch.fft.fft again, real part; the bias and unbias left out
        dln = (lx[-1] - lx[0]) / (N - 1)
        u = fftlog._u_coefficients(N, dln, mu, qs, ln_kcrc - lx[-1] + lx[0],
                                   dev) / N
        b = (a * torch.exp(-qs * (lx - lx[0]))).to(torch.float64)

        def library():
            return torch.fft.fft(torch.fft.fft(b) * u).real
        res = (err, time_ms(torch, kern, reps), time_ms(torch, plain, reps)
               ) + bound(nbytes(a, lx, op), ops, F64_FLOPS) + (
            time_ms(torch, library, reps),)
        log(f"[{gpu}] K8 fht {label} ({route}): kernel {res[1]:.4f} ms, "
            f"plain {res[2]:.4f} ms, bound {res[3]:.6f} ms ({res[4]}), "
            f"library (torch.fft.fft twice, partial) {res[5]:.4f} ms; "
            f"device alone (a CUDA graph of 20 calls): kernel "
            f"{graph_ms(torch, kern):.4f} ms, library "
            f"{graph_ms(torch, library):.4f} ms; f64 operations: the "
            f"coefficients {450.0 * (N // 2 + 1):.0f}, the FFTs "
            f"{B * 5.0 * N * math.log2(N):.0f}")
        return res

    # correlation_3d's transform: P(k) k^1.5 on K_GRID, mu = 1/2, q = -1/2:
    # the only shape the S19 and tSZ table builds run (build_bench_table
    # and build_tsz_table log theirs)
    k, pk = power.pk_grid(cosmo, a0, device=dev)
    out["fht"] = fht_case("correlation_3d, 1 x 1024", k,
                          (pk * k ** 1.5)[None], 0.5, -0.5, 50)
    # a batch of 20 DarkMatter rows on a 2048-point Fourier-like grid
    x = torch.as_tensor(np.geomspace(1e-7, 1e9, 2048), device=dev)
    M20 = torch.as_tensor(np.geomspace(5e12, 2e15, 20), device=dev)
    rows = bf.Profiles.DarkMatter(**BPAR).real(cosmo, x, M20, a0)
    for mu in (0.0, 0.5):
        fht_case(f"20 x 2048, mu = {mu}", x, rows * x ** 1.5, mu, -0.5, 10)
    # Bluestein in shared memory (q on a Gamma pole) and powers of two in
    # the passes over device memory, on the DarkMatter profile of the
    # first mass
    for B, N, mu, q in ((3, 100, 0.0, -1.0), (1, 8192, 0.5, -0.5),
                        (1, 16384, 0.5, -0.5)):
        xs = torch.as_tensor(np.geomspace(1e-7, 1e9, N), device=dev)
        prof = bf.Profiles.DarkMatter(**BPAR).real(cosmo, xs, M20[:B], a0)
        fht_case(f"{B} x {N}, mu = {mu}, q = {q}", xs, prof * xs ** 1.5, mu,
                 q, 10)

    # K9 on the bench table's first redshift
    ins, lnr_int, lnr = k9_inputs(bf, torch)
    masses = []
    err = 0.0
    for (i, d), name in zip(ins, ("DMO", "DMB")):
        ek = table_rows.enclosed_mass(i, d, lnr_int, lnr)
        ep = table_rows.enclosed_mass_plain(i, d, lnr_int, lnr)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(ek), torch.isnan(ep)):
            raise AssertionError(f"K9 enclosed_mass [{name}]: masks differ")
        e = ((ek - ep).abs() / ep.abs()).nan_to_num().max().item()
        check(f"K9 enclosed_mass [{name}, 20 x 500 -> 64] (relative)", e,
              1e-12)
        err = max(err, (ek - ep).abs().nan_to_num().max().item())
        masses.append(ep)
    dk = table_rows.displacement_rows(lnr, *masses)
    dp = table_rows.displacement_rows_plain(lnr, *masses)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(dk), torch.isnan(dp)):
        raise AssertionError("K9 displacement_rows: masks differ")
    e = (dk - dp).abs().nan_to_num().max().item()
    check("K9 displacement_rows [20 x 64]", e,
          1e-12 * dp.nan_to_num().abs().max().item())
    log(f"  K9 rows with NaN displacements: "
        f"{int(torch.isnan(dp).any(1).sum())} of {dp.shape[0]}")

    # the fused launch a redshift, as setup_interpolator calls it
    rows_args = (*ins[0], *ins[1], lnr_int, lnr)
    fk = table_rows.displacement_table(*rows_args)
    fp = table_rows.displacement_table_plain(*rows_args)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(fk), torch.isnan(fp)):
        raise AssertionError("K9 displacement_table: masks differ")
    ef = (fk - fp).abs().nan_to_num().max().item()
    check("K9 displacement_table [2 x 20 x 500 -> 20 x 64]", ef,
          1e-12 * fp.nan_to_num().abs().max().item())

    def k9():
        return table_rows.displacement_table(*rows_args)
    B, n_int, n_r = ins[0][0].shape[0], ins[0][0].shape[1], lnr.numel()
    # the inputs read once, the rows written once; per row and curve:
    # Simpson, mask, compaction ~30 operations a grid point, ~40 an
    # evaluation; the inversion two masked PCHIPs of n_r
    k9_bytes = nbytes(*ins, lnr_int, lnr, fp)
    k9_ops = 2 * B * (30.0 * n_int + 40.0 * n_r) + B * 120.0 * n_r
    out["table_rows"] = (max(err, e, ef), time_ms(torch, k9, 50),
                         time_ms(torch, lambda: (
                             table_rows.displacement_table_plain(
                                 *rows_args)), 5)
                         ) + bound(k9_bytes, k9_ops, F64_FLOPS) + (None,)
    enc_ms = time_ms(torch, lambda: table_rows.enclosed_mass(
        *ins[0], lnr_int, lnr), 50)
    disp_ms = time_ms(torch, lambda: table_rows.displacement_rows(
        lnr, *masses), 50)
    log(f"[{gpu}] K9 one redshift (one launch): kernel "
        f"{out['table_rows'][1]:.4f} ms a wrapper call, the device alone "
        f"{graph_ms(torch, k9):.4f} ms, plain {out['table_rows'][2]:.4f} ms,"
        f" bound {out['table_rows'][3]:.6f} ms ({out['table_rows'][4]}); "
        f"its halves apart: enclosed_mass {enc_ms:.4f} ms, "
        f"displacement_rows {disp_ms:.4f} ms")
    return out


def spline_solves(torch, solves, gpu):
    """The spline solve of the DMB profile three ways on the first recorded
    input: the port's host Thomas sweep with its copies, the same sweep as
    launches on the card, and one dense torch.linalg.solve on the card.
    Host-clock ms; the card's answers are held against the host's. Returns
    the three times and the dense solve, (lower, main, upper, rhs) ->
    derivatives."""
    from baryonforge_torch.ops import interp
    x, y, _ = solves[0]
    lower, main, upper, rhs = interp.spline_system(x, y)
    n = main.numel()

    def dense(lower, main, upper, rhs):
        A = (torch.diag(main) + torch.diag(lower[1:], -1)
             + torch.diag(upper[:-1], 1))
        m = rhs.shape[-1]
        return torch.linalg.solve(A, rhs.reshape(-1, m).T).T.reshape(
            (rhs.shape[:-1] or (1,)) + (m,))

    def sweep_on_card():
        r = rhs.reshape(-1, n).T
        cps, dps = torch.empty_like(main), torch.empty_like(r)
        cp, dp = main.new_zeros(()), r.new_zeros(r.shape[1])
        for i in range(n):
            denom = main[i] - lower[i] * cp
            cp = upper[i] / denom
            dp = (r[i] - lower[i] * dp) / denom
            cps[i], dps[i] = cp, dp
        ds, xn = torch.empty_like(r), r.new_zeros(r.shape[1])
        for i in range(n - 1, -1, -1):
            xn = dps[i] - cps[i] * xn
            ds[i] = xn
        return ds.T

    def dense_on_card():
        return dense(lower, main, upper, rhs)

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, res
    ms_host, ref = wall_ms(lambda: interp.cubic_spline_coeffs(x, y), 5)
    ms_sweep, d_sweep = wall_ms(sweep_on_card, 1)
    ms_dense, d_dense = wall_ms(dense_on_card, 5)
    scale = ref.abs().max().item()
    err_sweep = (d_sweep - ref).abs().max().item() / scale
    err_dense = (d_dense - ref).abs().max().item() / scale
    log(f"[{gpu}] spline solve of the DMB profile, {tuple(y.shape)}, "
        f"{len(solves)} per DMB profile: host sweep with copies "
        f"{ms_host:.3f} ms; the sweep as launches on the card "
        f"{ms_sweep:.3f} ms (off by {err_sweep:.3e} of the largest "
        f"derivative); dense torch.linalg.solve on the card {ms_dense:.3f} "
        f"ms (off by {err_dense:.3e})")
    return ms_host, ms_sweep, ms_dense, dense


def table_phases(bf, torch, model, gpu):
    """Host-clock milliseconds of one redshift of the bench table build,
    phase by phase (each ends in a synchronize)."""
    from baryonforge_torch.ops import interp, table_rows
    r = np.geomspace(BENCH_GRID["R_min"], BENCH_GRID["R_max"],
                     BENCH_GRID["N_samples_R"])
    M = np.geomspace(BENCH_GRID["M_min"], BENCH_GRID["M_max"],
                     BENCH_GRID["N_samples_Mass"])
    a0 = 1.0 / (1.0 + BENCH_GRID["z_min"])
    Mt = torch.as_tensor(M, device=DEVICE)
    r_int = np.geomspace(min(r.min(), model.r_min_int) / 1.2,
                         max(r.max(), model.r_max_int) * 1.2, model.N_int)
    ph = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ph[name] = (time.perf_counter() - t0) * 1e3
        return res
    for prof in (model.DMO, model.DMB):   # warm
        prof.projected(model.cosmo, r_int, Mt, a0)
    clock("DMO projected profile (K8 inside)",
          lambda: model.DMO.projected(model.cosmo, r_int, Mt, a0))
    # the not-a-knot spline solves inside the DMB profile, recorded with
    # their host-clock time
    s19 = bf.Profiles.Schneider19
    host_solve = s19.cubic_spline_coeffs
    solves = []

    def record(x, y):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = host_solve(x, y)
        torch.cuda.synchronize()
        solves.append((x, y, (time.perf_counter() - t0) * 1e3))
        return d
    s19.cubic_spline_coeffs = record
    try:
        clock("DMB projected profile (K8 inside)",
              lambda: model.DMB.projected(model.cosmo, r_int, Mt, a0))
    finally:
        s19.cubic_spline_coeffs = host_solve
    ph["spline solves inside it (host sweep)"] = sum(s[2] for s in solves)
    dense = spline_solves(torch, solves, gpu)[3]
    s19.cubic_spline_coeffs = lambda x, y: dense(
        *interp.spline_system(x, y))
    try:
        clock("DMB projected profile, dense spline solves on the card",
              lambda: model.DMB.projected(model.cosmo, r_int, Mt, a0))
    finally:
        s19.cubic_spline_coeffs = host_solve
    ro = clock("DMO profile rows",
               lambda: model._profile_rows(model.DMO, r, M, a0, True))
    rb = clock("DMB profile rows",
               lambda: model._profile_rows(model.DMB, r, M, a0, True))
    clock("table rows (K9, one launch)",
          lambda: table_rows.displacement_table(*ro[:2], *rb))
    log(f"[{gpu}] one redshift of the bench table, host clock (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()))
    return ph


def fht_shapes(fn):
    """fn() with K8's wrapper logging each launch's (B, N) and the callers
    that asked for it (the nearest three frames of the package outside
    ops/). Returns (fn's result, {(B, N, callers): launches})."""
    import collections
    import traceback
    from baryonforge_torch.ops import fftlog
    seen = collections.Counter()
    kernel = fftlog._fht_kernel

    def recording(a, lx, *args, **kw):
        frames = [f"{f.filename.split('baryonforge_torch/')[-1]}:{f.name}"
                  for f in traceback.extract_stack()[:-1]
                  if "baryonforge_torch/" in f.filename
                  and "baryonforge_torch/ops/" not in f.filename]
        B = a.numel() // lx.shape[0]
        seen[(B, lx.shape[0], " < ".join(frames[::-1][:3]))] += 1
        return kernel(a, lx, *args, **kw)
    fftlog._fht_kernel = recording
    try:
        return fn(), dict(seen)
    finally:
        fftlog._fht_kernel = kernel


def build_bench_table(bf, torch, gpu):
    """The bench's Schneider19 table built on the card from its profiles:
    the table path, with the launch counts set to 0 just before and read
    just after. Checks it against the JAX file and a small card table
    against the CPU's. Returns (model, launches)."""
    from baryonforge_torch.ops import _build
    n_z = BENCH_GRID["N_samples_z"]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, shapes = fht_shapes(
        lambda: s19_model(bf, DEVICE).setup_interpolator(**BENCH_GRID))
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    for (B, N, who), n in shapes.items():
        log(f"  K8 in the bench table build: {n} launches at {B} x {N}, "
            f"from {who}")
    want = {"fht": 2 * n_z, "table_rows": n_z, "enclosed_mass": 0,
            "displacement_rows": 0}
    for k, v in want.items():
        if launches.get(k, 0) != v:
            raise AssertionError(f"table build: {k} launched "
                                 f"{launches.get(k, 0)} times, not {v}")
    log(f"launches in the bench table build: {launches}")
    t0 = time.perf_counter()
    s19_model(bf, DEVICE).setup_interpolator(**BENCH_GRID)
    warm = time.perf_counter() - t0
    log(f"[{gpu}] bench table build (8 z x 20 M x 64 r) on the card: "
        f"first {wall * 1e3:.1f} ms, again {warm * 1e3:.1f} ms = "
        f"{warm * 1e3 / n_z:.1f} ms per redshift")
    d = model.raw_input_d
    if d.shape != (8, 20, 64) or not np.isfinite(d).all():
        raise AssertionError("card-built table: not finite / wrong shape")
    with np.load(TABLE) as f:
        ref = f["d"]
    drift = float(np.abs(d - ref).max())
    log(f"  card table vs tools/_northstar_table.npz: max |diff| "
        f"{drift:.3e} = {drift / np.abs(ref).max():.3e} of max |d|")
    check("card-built bench table vs the JAX file", drift,
          2.5e-4 * float(np.abs(ref).max()))

    g = s19_model(bf, DEVICE).setup_interpolator(**SMALL_GRID)
    c = s19_model(bf, "cpu").setup_interpolator(**SMALL_GRID)
    check("table 2 x 4 x 16, card vs CPU (plain versions)",
          float(np.abs(g.raw_input_d - c.raw_input_d).max()),
          1e-9 * float(np.abs(c.raw_input_d).max()))
    table_phases(bf, torch, model, gpu)
    return model, launches


def full_width_table(bf, torch, gpu):
    """setup_interpolator() at its defaults (30 z x 30 M x 100 r), timed;
    returns the number of broken-row warnings."""
    import warnings
    model = s19_model(bf, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        model.setup_interpolator()
    wall = time.perf_counter() - t0
    n_warn = sum(1 for x in w if issubclass(x.category, UserWarning)
                 and "partially failed" in str(x.message))
    d = model.raw_input_d
    if d.shape != (30, 30, 100) or not np.isfinite(d).all():
        raise AssertionError("full-width table: not finite / wrong shape")
    log(f"[{gpu}] full-width table (30 z x 30 M x 100 r) on the card: "
        f"{wall * 1e3:.1f} ms = {wall * 1e3 / 30:.1f} ms per redshift; "
        f"broken-row warnings: {n_warn}")
    return n_warn


def card_vs_cpu(bf, torch, model, cat, shell, label, **kw):
    """The whole path on the card against the plain versions on the CPU,
    float64 (tests/test_tiled_deposit.py:80's bound). Returns the card
    run's launches."""
    from baryonforge_torch.ops import _build
    kw = dict(epsilon_max=EPS_MAX, model=model, dtype=torch.float64,
              regrid_dtype=torch.float64, **kw)
    _build.reset_launches()
    out_gpu = bf.BaryonifyShell(cat, shell, device=DEVICE, **kw).process()
    launches = dict(_build.launches)
    out_cpu = bf.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    check(f"shell {label}, float64, card vs CPU",
          float(np.abs(out_gpu - out_cpu).max()),
          1e-9 * float(np.abs(out_cpu - shell.map).max()))
    return launches


def drive(bf, torch, runner, required, label, gpu, paint=False):
    """Two warm calls and N_CALLS timed ones of ``runner.process()``, with
    the launch counts set to 0 just before and read just after. Checks the
    kernels in ``required`` were launched and the map is finite, of the
    right shape, and moved and mass-conserving (a baryonified shell) or
    painted (``paint``). Returns (map, launches)."""
    from baryonforge_torch.ops import _build
    shell = runner.LightconeShell
    _build.reset_launches()
    runner.process()
    runner.process()
    walls, phases = [], []
    for _ in range(N_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.process()
        walls.append(time.perf_counter() - t0)
        phases.append(runner.timings)
    launches = dict(_build.launches)
    for k in required:
        if launches.get(k, 0) < 2 + N_CALLS:
            raise AssertionError(f"{label} did not launch {k}: {launches}")
    if out.shape != shell.map.shape or not np.isfinite(out).all():
        raise AssertionError(f"{label}: map not finite / wrong shape")
    if paint:
        if not out.max() > 0:
            raise AssertionError(f"{label} painted nothing")
    elif not np.isclose(out.sum(), shell.map.sum()):
        raise AssertionError(f"{label} lost mass")
    elif not np.abs(out - shell.map).max() > 0:
        raise AssertionError(f"{label} moved nothing")
    q = np.percentile(np.array(walls) * 1e3, [25, 50, 75])
    log(f"[{gpu}] {label}: {N_CALLS} calls, median {q[1]:.3f} ms "
        f"({q[0]:.3f}-{q[2]:.3f}) = {N_HALOS / (q[1] / 1e3):.1f} halos/s; "
        "median phases (ms, CUDA events): " + ", ".join(
            f"{k} {np.median([p[k] for p in phases]):.3f}"
            for k in phases[0]))
    log(f"launches in {label}'s {2 + N_CALLS} calls: {launches}")
    return out, launches


def tsz_profile(bf):
    """The bench's tSZ model (tools/northstar.py:50-58)."""
    T = bf.Profiles.Thermodynamic
    return T.ThermalSZ(T.Pressure(**BPAR, proj_cutoff=100), proj_cutoff=100)


def tsz_models(bf, log_tab):
    """A log tSZ table and its raw form (exp of its tables, as a
    ParamTabulatedProfile without parameter axes), which runs the
    raw-curve branches of K10 and K11."""
    raw = bf.utils.ParamTabulatedProfile(None, log_tab.cosmo,
                                         mass_def=log_tab.mass_def)
    raw._set_axes(log_tab._axes, np.exp(log_tab.raw_input_3D),
                  np.exp(log_tab.raw_input_2D))
    return {"log": log_tab, "raw": raw}


def paint_bound_check(name, k, p):
    """The JAX package's bound between its tiled and scatter paint
    (tests/test_tiled_deposit.py:113): |k - p| <= 2e-3 max|p| + 2e-3 |p|,
    reported as the largest excess ratio (<= 1 passes)."""
    k, p = np.asarray(k, np.float64), np.asarray(p, np.float64)
    scale = np.abs(p).max()
    if not scale > 0:
        raise AssertionError(f"{name}: nothing painted")
    ratio = float((np.abs(k - p) / (2e-3 * scale + 2e-3 * np.abs(p))).max())
    check(f"{name} (|diff| / (2e-3 max + 2e-3 |value|))", ratio, 1.0)


def paint_f32_check(name, k, p, rtol, marginal):
    """A float32 paint kernel against its plain version, per pixel, on the
    tolerances of ops.paint.float32_tolerance: |k - p| <= rtol |p| where
    both paint and the pixel is not marginal; a pixel painted on one side
    only must be marginal, and marginal pixels stay under 1% of the
    painted ones (disc-edge pixels within the reach of float32)."""
    k, p = k.double(), p.double()
    nk, np_ = k != 0, p != 0
    painted = int((nk | np_).sum())
    if not painted:
        raise AssertionError(f"{name}: nothing painted")
    keep = nk & np_ & ~marginal
    if not keep.any():
        raise AssertionError(f"{name}: no pixel to hold")
    ratio =((k - p).abs() / (rtol * p.abs()))[keep].max().item()
    log(f"  {name}: {int(keep.sum())} of {painted} painted pixels held, "
        f"{int((marginal & (nk | np_)).sum())} marginal, "
        f"{int((nk ^ np_).sum())} painted on one side only; largest "
        f"|diff| / |value| {((k - p).abs() / p.abs())[keep].max().item():.3e}")
    check(f"{name} (per pixel |diff| / (rtol |value|))", ratio, 1.0)
    check(f"{name}: pixels painted on one side only, not marginal",
          int(((nk ^ np_) & ~marginal).sum()), 0)
    check(f"{name}: marginal share of the painted pixels",
          int((marginal & (nk | np_)).sum()) / painted, 1e-2)


def compare_paint_kernels(bf, torch, models, cat, shell, eps, label, timing):
    """K10 and K11 against their plain versions on the card, on this
    catalog, with log and raw curves, in float64 and float32 (K11's map in
    float64, the runner's default). Returns {kernel: (max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms)} for the bench
    configuration (float32, log curves) when ``timing``."""
    from baryonforge_torch.ops import paint
    from baryonforge_torch.ops import tile_deposit as td
    dev = torch.device(DEVICE)
    nside = shell.NSIDE
    out = {}
    for kind, model in models.items():
        for dt in (torch.float64, torch.float32):
            tag = f"{label}, {kind} curves, {str(dt).replace('torch.', '')}"
            runner = bf.PaintProfilesShell(cat, shell, epsilon_max=eps,
                                           model=model, dtype=dt, device=dev)
            hd = runner._host_halo_data(
                bf.cosmo.cosmology_from_dict(runner.cosmo))
            curves, r0, dl = model.with_dtype(dt, device=dev).halo_curves(
                hd["M"], hd["a"])
            r0, dl = float(r0), float(dl)
            logc = model.curves_are_log
            tiling, csr, pack = runner._tile_paint_inputs(hd, curves, logc,
                                                          nside)
            ak = td.tile_paint(tiling, csr, pack, r0, 1.0 / dl, logc)
            ap = td.tile_paint_plain(tiling, csr, pack, r0, 1.0 / dl, logc)
            halos = {k: torch.as_tensor(hd[k], device=dev)
                     for k in paint.HALO_COLUMNS}
            kk = paint.disc_paint(nside, halos, curves, r0, dl, logc, False,
                                  torch.float64)
            kp = paint.disc_paint_plain(nside, halos, curves, r0, dl, logc,
                                        False, torch.float64)
            torch.cuda.synchronize()
            err10 = (ak - ap).abs().max().item()
            err11 = (kk - kp).abs().max().item()
            log(f"  [{tag}] K10 on {tiling.RB} x {tiling.K} tiles: "
                 f"{csr[0].numel()} touched, {csr[2].numel()} pairs")
            if dt == torch.float64:
                # sums in another order (K11: atomics)
                check(f"K10 tile_paint [{tag}]", err10,
                      1e-10 * ap.abs().max().item())
                if not torch.equal(ak == 0, ap == 0):
                    raise AssertionError(f"K10 [{tag}]: zero masks differ")
                check(f"K11 disc_paint [{tag}]", err11,
                      1e-10 * kp.abs().max().item())
            else:
                rtol, marginal = paint.float32_tolerance(nside, halos, curves,
                                                         r0, dl, logc)
                # K10's geometry is tile-local, well conditioned: 1e-4
                paint_f32_check(f"K10 tile_paint [{tag}]",
                                tiling.flat_view_plain(ak),
                                tiling.flat_view_plain(ap),
                                torch.full_like(rtol, 1e-4), marginal)
                paint_f32_check(f"K11 disc_paint [{tag}]", kk, kp, rtol,
                                marginal)
                if timing and logc:
                    # the same plain version on the CPU: the spread of two
                    # correct float32 evaluations
                    cpu = {k: v.cpu() for k, v in halos.items()}
                    kc = paint.disc_paint_plain(nside, cpu, curves.cpu(), r0,
                                                dl, logc, False,
                                                torch.float64).to(dev)
                    paint_f32_check(f"K11's plain version, CUDA vs CPU "
                                    f"[{tag}]", kp, kc, rtol, marginal)
            if not (timing and dt == torch.float32 and logc):
                continue
            npix = 12 * nside * nside
            # K10: per pair-slot ~25 operations (chord, log, lerp, exp,
            # mask); pack and curves read, the (n_tiles, P) map written
            out["tile_paint"] = (err10, time_ms(
                torch, lambda: td.tile_paint(tiling, csr, pack, r0, 1.0 / dl,
                                             logc), 20),
                time_ms(torch, lambda: td.tile_paint_plain(
                    tiling, csr, pack, r0, 1.0 / dl, logc), 3)) + bound(
                nbytes(csr, pack, ak), 25.0 * csr[2].numel() * tiling.P,
                F32_FLOPS) + (None,)
            # K11: its disc pixels (sum of pi r^2 over the pixel area), ~40
            # operations each; halos and curves read, the map written
            pixels = npix * float(np.sum(hd["radius"] ** 2)) / 4.0
            out["disc_paint"] = (err11, time_ms(
                torch, lambda: paint.disc_paint(nside, halos, curves, r0, dl,
                                                logc, False, torch.float64),
                10), time_ms(torch, lambda: paint.disc_paint_plain(
                    nside, halos, curves, r0, dl, logc, False,
                    torch.float64), 3)) + bound(
                nbytes(halos, curves, kk), 40.0 * pixels,
                F32_FLOPS) + (None,)
            log(f"  K10 pair-slots {csr[2].numel() * tiling.P}, K11 disc "
                 f"pixels ~{pixels:.0f}")
    return out


def paint_card_vs_cpu(bf, torch, model, cat, shell, eps, label):
    """The paint path on the card against the plain versions on the CPU,
    float64 with include_pixel_size, tiled and scatter, rtol 1e-9 per
    pixel (the sums run in other orders)."""
    for deposit in ("auto", "scatter"):
        kw = dict(epsilon_max=eps, model=model, dtype=torch.float64,
                  include_pixel_size=True, deposit=deposit)
        g = bf.PaintProfilesShell(cat, shell, device=DEVICE, **kw).process()
        c = bf.PaintProfilesShell(cat, shell, device="cpu", **kw).process()
        if not c.max() > 0:
            raise AssertionError(f"paint {label}: nothing painted")
        rel = float((np.abs(g - c) / (1e-9 * np.abs(c) + 1e-12 * c.max()))
                    .max())
        check(f"paint {label}, {deposit}, float64, card vs CPU "
              "(|diff| / (1e-9 |value| + 1e-12 max))", rel, 1.0)


def build_tsz_table(bf, torch, gpu):
    """The tSZ table built on the card on the bench grid (8 z x 20 M x 64
    r), timed, against the JAX package's build of the same table
    (tests/data/tsz_bench_table.npz) and a small table on the card
    against the CPU's. Returns the table."""
    from baryonforge_torch.ops import _build
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab, shapes = fht_shapes(lambda: bf.utils.TabulatedProfile(
        tsz_profile(bf), cosmo).setup_interpolator(**BENCH_GRID))
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    for (B, N, who), n in shapes.items():
        log(f"  K8 in the tSZ table build: {n} launches at {B} x {N}, "
            f"from {who}")
    if launches.get("fht", 0) < 1:
        raise AssertionError(f"tSZ table build launched no K8: {launches}")
    t0 = time.perf_counter()
    bf.utils.TabulatedProfile(tsz_profile(bf), cosmo).setup_interpolator(
        **BENCH_GRID)
    warm = time.perf_counter() - t0
    log(f"[{gpu}] tSZ table build (TabulatedProfile(ThermalSZ), 8 z x 20 M "
         f"x 64 r) on the card: first {wall * 1e3:.1f} ms, again "
         f"{warm * 1e3:.1f} ms; launches {launches}")
    with np.load(TSZ_TABLE) as f:
        for key, mine in (("tab3D", tab.raw_input_3D),
                          ("tab2D", tab.raw_input_2D)):
            ref = f[key]
            if mine.shape != ref.shape or not np.isfinite(mine).all():
                raise AssertionError(f"tSZ table {key}: not finite / wrong "
                                     "shape")
            # log values: the card's build reads ~2e-12 from the JAX file;
            # a float32 step anywhere in the build would read ~1e-7 or more
            check(f"card-built tSZ table {key} vs the JAX file "
                  "(max |diff| of the logs)",
                  float(np.abs(mine - ref).max()), 1e-9)
    small = dict(SMALL_GRID)
    g = bf.utils.TabulatedProfile(tsz_profile(bf), cosmo).setup_interpolator(
        **small)
    c = bf.utils.TabulatedProfile(tsz_profile(bf), cosmo,
                                  device="cpu").setup_interpolator(**small)
    check("tSZ table 2 x 4 x 16, card vs CPU (max |diff| of the logs)",
          float(max(np.abs(g.raw_input_2D - c.raw_input_2D).max(),
                    np.abs(g.raw_input_3D - c.raw_input_3D).max())), 1e-9)
    return tab


def north_star_paint(bf, torch, tab, gpu):
    """One paint call at the north star's size, NSIDE 4096 and 10^6 halos
    from the bench generator (seed 7), tiled: one warm call and two timed,
    with each call's phases. Returns the launches of the timed calls."""
    from baryonforge_torch.ops import _build
    rng = np.random.default_rng(SEED)
    n = NS_HALOS
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    M = 10 ** rng.uniform(13.0, 14.8, n)
    z = rng.uniform(0.8, 1.0, n)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    # the paint does not read the map's values
    shell = bf.utils.LightconeShell(map=np.zeros(12 * NS_NSIDE ** 2),
                                    cosmo=COSMO)
    runner = bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS,
                                   model=tab, device=DEVICE)
    t0 = time.perf_counter()
    out = runner.process()
    log(f"[{gpu}] north-star paint (NSIDE {NS_NSIDE}, {n} halos), warm "
         f"call: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if out.shape != (12 * NS_NSIDE ** 2,) or not np.isfinite(out).all() \
            or not out.max() > 0:
        raise AssertionError("north-star paint: map not finite / empty")
    _build.reset_launches()
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.process()
        wall = time.perf_counter() - t0
        log(f"[{gpu}] north-star paint, timed call {i + 1}: "
             f"{wall * 1e3:.1f} ms = {n / wall:.1f} halos/s; phases (ms, "
             "CUDA events): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in runner.timings.items()))
    launches = dict(_build.launches)
    log(f"launches in the north-star paint's 2 timed calls: {launches}")
    return launches


def anis_shell(bf, shell):
    """``shell``'s map at the anisotropic paint's redshift
    (tools/anis_bench.py:60-62)."""
    return bf.utils.LightconeShell(map=shell.map, cosmo=COSMO,
                                   redshift=ANIS_Z)


def wide_anis_discs(halos, nside):
    """Give three halos discs of 1.2-3 degrees (more than
    ops.deposit.SPLIT_RINGS rings at NSIDE 1024: K13's whole-block route):
    at the north pole, across phi = 0 and in the belt
    (tests/test_torch_cuda.py: _wide_anis_discs)."""
    pix = math.pi / (2 * nside)
    for i, th, ph, deg in ((0, 0.0, None, 1.5), (3, 1.2, 0.3 * pix, 1.2),
                           (4, 1.6, 2 * math.pi - 0.6 * pix, 3.0)):
        halos["theta"][i] = th
        if ph is not None:
            halos["phi"][i] = ph
        halos["radius"][i] = math.radians(deg)


def k13_gathers(torch, w):
    """K13's float64 map reads (mtot, orig) at its member pixels, from the
    plain layout ``w`` (ops.deposit.disc_walk_plain): the warp requests
    and the 32-byte sectors they touch in the flat walk (32 consecutive
    candidates of a disc a request) and in the earlier ring walk (32
    consecutive candidates of one ring a request)."""
    m = w["member"]
    halo, q, pix = w["halo"][m], w["q"][m], w["pix"][m]
    first = torch.cumsum(w["span"], 1) - w["span"]
    ring = torch.searchsorted(first[halo], q[:, None], right=True)[:, 0] - 1
    off = q - first[halo, ring]
    sector = pix // 4
    out = []
    for group in ((halo, q // 32), (halo, ring, off // 32)):
        req = torch.unique(torch.stack(group, 1), dim=0).shape[0]
        sec = torch.unique(torch.stack(group + (sector,), 1), dim=0).shape[0]
        out.append((req, sec))
    return out


def compare_anis_kernels(bf, torch, models, cat, shell, eps, label, timing):
    """K12, K13 and K14 against their plain versions on the card, on this
    catalog, with (log, log) and (raw, log) curve pairs, in float64 and
    float32: K12 on the runner's own pack, K13 on a canvas 1 + orig with
    every 7th pixel 0, K14 in both forms. Returns {kernel: (max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms)} for the bench
    configuration (float32, log curves) when ``timing``."""
    from baryonforge_torch.ops import deposit, paint
    from baryonforge_torch.ops import tile_deposit as td
    dev = torch.device(DEVICE)
    nside = shell.NSIDE
    npix = 12 * nside * nside
    orig = torch.as_tensor(shell.map, device=dev)
    mtot = 1.0 + orig
    mtot[::7] = 0.0
    out = {}
    for kinds in (("log", "log"), ("raw", "log")):
        for dt in (torch.float64, torch.float32):
            tag = (f"{label}, {kinds[0]}/{kinds[1]} curves, "
                   f"{str(dt).replace('torch.', '')}")
            runner = bf.PaintProfilesAnisShell(
                cat, anis_shell(bf, shell), epsilon_max=eps,
                model=models[kinds[0]], Tracer_model=models[kinds[1]],
                Mtot_model=models[kinds[1]], background_val=ANIS_BG,
                global_tracer_fraction=ANIS_FRAC, dtype=dt, device=dev)
            hd = runner._host_halo_data(
                bf.cosmo.cosmology_from_dict(runner.cosmo))
            curves = []
            for kind in kinds:
                c, r0, dl = models[kind].with_dtype(
                    torch.float64, device=dev).halo_curves(hd["M"], hd["a"])
                curves.append((c, float(r0), float(dl),
                               models[kind].curves_are_log))
            tiling, csr, pack, grid = runner._tile_paint2_inputs(hd, curves,
                                                                 nside)
            ak = td.tile_paint2(tiling, csr, pack, *grid)
            ap = td.tile_paint2_plain(tiling, csr, pack, *grid)
            halos = {k: torch.as_tensor(hd[k], device=dev)
                     for k in paint.HALO_COLUMNS}
            painting, canvas = ((c.to(dt),) + tuple(rest)
                                for c, *rest in curves)
            kk = paint.disc_paint_anis(nside, halos, painting, canvas, mtot,
                                       orig, False)
            kp = paint.disc_paint_anis_plain(nside, halos, painting, canvas,
                                             mtot, orig, False)
            hs = tiling.flat_view_plain(ap)
            mt = (2.0 * orig - 0.5).to(dt)
            fk = paint.anis_finish(hs, mt, orig, 0.3, 0.1, tiled=True)
            fp = paint.anis_finish_plain(hs, mt, orig, 0.3, 0.1, 1.0, True)
            sk = paint.anis_finish(kp, mtot, orig, 0.3, 0.1, scale=2.0)
            sp = paint.anis_finish_plain(kp, mtot, orig, 0.3, 0.1, 2.0,
                                         False)
            torch.cuda.synchronize()
            err12 = (ak - ap).abs().max().item()
            err13 = (kk - kp).abs().max().item()
            err14 = max(((fk - fp).abs() / fp.abs()).nan_to_num().max()
                        .item(), ((sk - sp).abs() / sp.abs()).nan_to_num()
                        .max().item())
            log(f"  [{tag}] K12 on {tiling.RB} x {tiling.K} tiles: "
                f"{csr[0].numel()} touched, {csr[2].numel()} pairs")
            # K14: the same operations in the same order
            check(f"K14 anis_finish [{tag}] (relative)", err14, 1e-15)
            (c1, r1, d1, l1), (c2, r2, d2, l2) = curves
            second = (c2, r2, d2, l2)
            if dt == torch.float64:
                # sums in another order (K13: atomics)
                check(f"K12 tile_paint2 [{tag}]", err12,
                      1e-10 * ap.abs().max().item())
                if not torch.equal(ak == 0, ap == 0):
                    raise AssertionError(f"K12 [{tag}]: zero masks differ")
                check(f"K13 disc_paint_anis [{tag}]", err13,
                      1e-10 * kp.abs().max().item())
            else:
                # K12's geometry is tile-local, well conditioned: 1e-4
                _, marginal = paint.float32_tolerance(
                    nside, halos, c1, r1, d1, l1, second=second)
                paint_f32_check(f"K12 tile_paint2 [{tag}]",
                                tiling.flat_view_plain(ak), hs,
                                torch.full_like(kp, 1e-4), marginal)
                paint_f32_check(f"K13 disc_paint_anis [{tag}]", kk, kp,
                                *paint.float32_tolerance(
                                    nside, halos, c1, r1, d1, l1,
                                    reach=paint.VEC_SINHD_REACH,
                                    second=second))
            w = deposit.disc_walk_plain(nside, halos["theta"], halos["phi"],
                                        halos["radius"], dt)
            log(f"  [{tag}] K13 routes: {int((~w['block']).sum())} discs a "
                f"warp, {int(w['block'].sum())} on the whole block; "
                f"{int(w['member'].sum())} member pixels of "
                f"{w['member'].numel()} candidates")
            if timing:
                # the whole-block route beside the warps' at the bench
                wide = {k: v.clone() for k, v in halos.items()}
                wide_anis_discs(wide, nside)
                blk = deposit.disc_walk_plain(nside, wide["theta"],
                                              wide["phi"], wide["radius"],
                                              dt)["block"]
                if not (blk.any() and (~blk).any()):
                    raise AssertionError(f"K13 [{tag}]: a route is missing")
                wk = paint.disc_paint_anis(nside, wide, painting, canvas,
                                           mtot, orig, False)
                wp = paint.disc_paint_anis_plain(nside, wide, painting,
                                                 canvas, mtot, orig, False)
                wtag = f"{tag}, {int(blk.sum())} discs on the block route"
                if dt == torch.float64:
                    check(f"K13 disc_paint_anis [{wtag}]",
                          (wk - wp).abs().max().item(),
                          1e-10 * wp.abs().max().item())
                else:
                    paint_f32_check(f"K13 disc_paint_anis [{wtag}]", wk, wp,
                                    *paint.float32_tolerance(
                                        nside, wide, c1, r1, d1, l1,
                                        reach=paint.VEC_SINHD_REACH,
                                        second=second))
            if not (timing and dt == torch.float32 and kinds[0] == "log"):
                continue
            # K12: per pair-slot ~35 operations (chord, log, two lerps, one
            # exp, masks); pack and both curves read, the map written
            out["tile_paint2"] = (err12, time_ms(
                torch, lambda: td.tile_paint2(tiling, csr, pack, *grid), 20),
                time_ms(torch, lambda: td.tile_paint2_plain(
                    tiling, csr, pack, *grid), 3)) + bound(
                nbytes(csr, pack, ak), 35.0 * csr[2].numel() * tiling.P,
                F32_FLOPS) + (None,)
            # K13: its member pixels (this run's, ops.deposit.
            # disc_walk_plain), ~60 float32 operations (pixel centre, unit
            # vector) and ~60 float64 ones (two lookups with their log and
            # exp) each; halos and curves read, the canvas and map read at
            # the member pixels, the map written
            pixels = float(w["member"].sum())
            out["disc_paint_anis"] = (err13, time_ms(
                torch, lambda: paint.disc_paint_anis(
                    nside, halos, painting, canvas, mtot, orig, False), 10),
                time_ms(torch, lambda: paint.disc_paint_anis_plain(
                    nside, halos, painting, canvas, mtot, orig, False),
                    3)) + bound(
                nbytes(halos, painting[0], canvas[0], kk) + 16.0 * pixels,
                60.0 * pixels, F64_FLOPS) + (None,)
            # K14 (tiled form): per pixel the halo sum and canvas (float32)
            # and orig read, the map written; ~8 float64 operations
            out["anis_finish"] = (err14, time_ms(
                torch, lambda: paint.anis_finish(hs, mt, orig, 0.3, 0.1,
                                                 tiled=True), 50),
                time_ms(torch, lambda: paint.anis_finish_plain(
                    hs, mt, orig, 0.3, 0.1, 1.0, True), 10)) + bound(
                nbytes(hs, mt, orig, fk), 8.0 * npix, F64_FLOPS) + (None,)
            k13_ms = graph_ms(torch, lambda: paint.disc_paint_anis(
                nside, halos, painting, canvas, mtot, orig, False))
            zeros_ms = graph_ms(torch, lambda: torch.zeros(
                npix, dtype=torch.float64, device=dev))
            log(f"[{gpu_line()}] K13 device alone (a CUDA graph of 20 "
                f"calls): "
                f"{k13_ms:.4f} ms, of which the map's torch.zeros "
                f"{zeros_ms:.4f} ms")
            (fr, fs), (rr, rs) = k13_gathers(torch, w)
            log(f"  K12 pair-slots {csr[2].numel() * tiling.P}, K13 disc "
                f"pixels {pixels:.0f}; K13's map reads at its member "
                f"pixels: {fr} warp requests over {fs} 32-byte sectors "
                f"({fs / fr:.2f} a request) in the flat walk, {rr} over "
                f"{rs} ({rs / rr:.2f}) in the earlier ring walk")
    return out


def grid_inputs(bf, ndim, npix, n_halos=GRID_HALOS, seed=GRID_SEED):
    """The ΔP(k) recipe's catalog (examples/06_delta_pk.py:57-63: seed 3,
    x, y, z uniform in the box, M = 10^U(13.5, 14.8), z = 0.2) at the
    reference's ΔP(k) size, in 2D its x and y with q_ell and A_ell as
    tests/test_runners_extra.py:80-84; and an empty N^d map of the 256 Mpc
    box."""
    rng = np.random.default_rng(seed)
    L = GRID_L
    x, y, z = (rng.uniform(0, L, n_halos) for _ in range(3))
    M = 10 ** rng.uniform(13.5, 14.8, n_halos)
    extra = dict(z=z) if ndim == 3 else dict(
        q_ell=rng.uniform(0.5, 0.9, n_halos),
        A_ell=rng.normal(size=(n_halos, 2)))
    cat = bf.utils.HaloNDCatalog(x=x, y=y, M=M, redshift=GRID_Z, cosmo=COSMO,
                                 **extra)
    gm = grid_map(bf, np.zeros((npix,) * ndim))
    return cat, gm


def grid_map(bf, m):
    npix = m.shape[0]
    return bf.utils.GriddedMap(map=m, bins=(np.arange(npix) + 0.5)
                               * (GRID_L / npix), cosmo=COSMO,
                               redshift=GRID_Z)


def grid_tables(bf, torch, gpu):
    """The ΔP(k) recipe's tables built on the card
    (examples/06_delta_pk.py:66-82): the DMO paint table (3D; with
    proj_cutoff=100 for 2D), Baryonification3D and Baryonification2D (its
    profiles with proj_cutoff=100, as the bench's)."""
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    P = bf.Profiles
    t0 = time.perf_counter()
    tabs = {
        "dmo3": bf.utils.TabulatedProfile(P.DarkMatter(**BPAR), cosmo)
        .setup_interpolator(**DMO_GRID),
        "dmo2": bf.utils.TabulatedProfile(
            P.DarkMatter(**BPAR, proj_cutoff=100), cosmo)
        .setup_interpolator(**DMO_GRID),
        "b3": bf.Baryonification3D(
            P.DarkMatterOnly(**BPAR), P.DarkMatterBaryon(**BPAR), cosmo,
            epsilon_max=GRID_BARYON_EPS).setup_interpolator(**B_GRID),
        "b2": bf.Baryonification2D(
            P.DarkMatterOnly(**BPAR, proj_cutoff=100),
            P.DarkMatterBaryon(**BPAR, proj_cutoff=100), cosmo,
            epsilon_max=GRID_BARYON_EPS).setup_interpolator(**B_GRID)}
    for k in ("b3", "b2"):
        if not np.isfinite(tabs[k].raw_input_d).all():
            raise AssertionError(f"grid table {k}: not finite")
    log(f"[{gpu}] grid tables on the card (2 DMO paint tables "
        f"2 z x 8 M x 64 r, Baryonification3D/2D 2 z x 8 M x 48 r): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return tabs


def compare_grid_kernels(bf, torch, runner, label, timing, deposit=False,
                         odd=False):
    """K15 over every size bucket of ``runner``'s own inputs (and K16 on
    the offsets when ``deposit``; ``odd``: one bucket's Ns must be odd)
    against the plain versions on the card:
    float64 maps to 1e-10 of the largest value (atomic sums in another
    order), float32 offsets to 1e-5 of the largest (float32 sums in another
    order), K16's float64 map to 1e-12 of the largest value and its mass to
    1e-12. Returns {kernel: (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)} when ``timing``."""
    from baryonforge_torch.ops import grid as tgrid
    from baryonforge_torch.ops import scatter
    from baryonforge_torch.utils.trace import PhaseClock
    dev = torch.device(DEVICE)
    gm = runner.GriddedMap
    ndim, npix = (2 if gm.is2D else 3), gm.Npix
    inp = runner._cutout_inputs(PhaseClock(dev))
    ak = runner._cutouts(inp, runner._accumulator(inp))
    ak2 = runner._cutouts(inp, runner._accumulator(inp))
    ap = runner._cutouts(inp, runner._accumulator(inp),
                         cutout=tgrid.grid_cutout_plain)
    torch.cuda.synchronize()
    if not torch.equal(ak, ak2):
        raise AssertionError(f"K15 [{label}]: two calls differ")
    tile_pairs_check(torch, runner, inp, label)
    err15 = (ak - ap).abs().max().item()
    scale = ap.abs().max().item()
    if not scale > 0:
        raise AssertionError(f"K15 [{label}]: nothing deposited")
    rel = 1e-5 if ak.dtype == torch.float32 else 1e-10
    buckets = runner._buckets(inp["Nsize"])
    cells = float(sum(idx.size * Ns ** ndim for idx, Ns in buckets))
    log(f"  [{label}] K15 {inp['mode']}: {len(buckets)} buckets, cutouts "
        f"{[Ns for _, Ns in buckets]}, {cells:.4g} cells")
    check(f"K15 grid_cutout [{label}]", err15, rel * scale)
    if odd and not any(Ns % 2 for _, Ns in buckets):
        raise AssertionError(f"K15 [{label}]: no odd cutout size")
    out = {}
    if timing:
        # K15: ~50 float64 operations (geometry, a log, one or two lerps,
        # masks) a cell the inputs need, r < rmax inside a box; the halo
        # columns and curves read, the accumulator read and written once
        # (the anisotropic mode also reads the canvas and the map)
        live = live_cells(torch, runner, inp)
        reads = nbytes(inp["halos"], inp["curve"][0], ak) + (
            16.0 * runner.GriddedMap.map.size if inp["mode"] == "anis"
            else 0.0)
        out["grid_cutout"] = (err15, time_ms(
            torch, lambda: runner._cutouts(inp, runner._accumulator(inp)),
            3), time_ms(torch, lambda: runner._cutouts(
                inp, runner._accumulator(inp),
                cutout=tgrid.grid_cutout_plain), 1)) + bound(
            reads + nbytes(ak), 50.0 * live, F64_FLOPS) + (None,)
        log(f"  [{label}] K15: {live:.6g} cells with r < rmax of "
            f"{cells:.6g} box cells; bound on the box cells "
            f"{bound(reads + nbytes(ak), 50.0 * cells, F64_FLOPS)[0]:.4f} "
            "ms")
    if not deposit:
        return out
    orig = inp["orig"]
    dk = scatter.grid_deposit(ap, orig, npix, ndim)
    dp = scatter.grid_deposit_plain(ap, orig, npix, ndim)
    counts = {}
    dw = scatter.grid_deposit_windows_plain(ap, orig, npix, ndim,
                                            counts=counts)
    torch.cuda.synchronize()
    err16 = (dk - dp).abs().max().item()
    check(f"K16 grid_deposit [{label}]", err16,
          1e-12 * dp.abs().max().item())
    check(f"K16 grid_deposit vs its windows' plain version [{label}]",
          (dk - dw).abs().max().item(), 1e-12 * dp.abs().max().item())
    check(f"K16 grid_deposit mass [{label}]",
          abs(dk.sum().item() / orig.sum().item() - 1.0), 1e-12)
    src, kept = counts["sources"], counts["corners"]
    log(f"  [{label}] K16's windows (tile {scatter.TILE[ndim]}): "
        f"{counts['zero_offset'] / src:.4f} of the sources with all offsets "
        f"0; {kept / src:.3f} nonzero corners a source, "
        f"{counts['spilled'] / kept:.3e} of them spilled past the window; "
        f"{counts['flushed'] / src:.3f} window entries flushed a source")
    if timing:
        nflat = orig.numel()
        idx, vals = deposit_corners(torch, ap, orig, npix, ndim)

        def library():
            return torch.zeros_like(orig).index_put_((idx,), vals,
                                                     accumulate=True)
        if not torch.allclose(library(), dp, rtol=0,
                              atol=1e-12 * dp.abs().max().item()):
            raise AssertionError("index_put_ yardstick of K16 is wrong")
        # K16: per source its offsets and value read, ~15 operations an
        # axis and 2^d weighted updates of the map, written once
        out["grid_deposit"] = (err16, time_ms(
            torch, lambda: scatter.grid_deposit(ap, orig, npix, ndim), 5),
            time_ms(torch, lambda: scatter.grid_deposit_plain(
                ap, orig, npix, ndim), 2)) + bound(
            nbytes(ap, orig, dk), (15.0 * ndim + 2 ** ndim * ndim) * nflat,
            F64_FLOPS) + (time_ms(torch, library, 5),)
        ms = out["grid_deposit"][1]
        zeros_ms = time_ms(torch, lambda: torch.zeros_like(orig), 5)
        log(f"  [{label}] K16 grid_deposit: {ms:.4f} ms (the 0.45 ms target "
            f"{'met' if ms <= 0.45 else 'missed'}), of which the map's "
            f"torch.zeros {zeros_ms:.4f} ms")
    return out


def tile_pairs_check(torch, runner, inp, label):
    """K15's lists on the card (its pair kernel, then the sort) equal to
    those of the pair kernel's plain version on the CPU, every bucket."""
    from baryonforge_torch.ops import grid as tgrid
    gm = runner.GriddedMap
    for idx, Ns in runner._buckets(inp["Nsize"]):
        ix = torch.as_tensor(idx, device=DEVICE)
        h = {k: None if v is None else v[ix]
             for k, v in inp["halos"].items()}
        card = tgrid.cutout_tiles(gm.Npix, Ns, gm.res, h)
        cpu = tgrid.cutout_tiles(gm.Npix, Ns, gm.res, {
            k: None if v is None else v.cpu() for k, v in h.items()})
        n = int(cpu[0][-1])
        if not (torch.equal(card[0].cpu(), cpu[0])
                and torch.equal(card[1][:n].cpu(), cpu[1][:n])):
            raise AssertionError(f"K15 [{label}]: the pair kernel's lists "
                                 f"differ from its plain version's (Ns {Ns})")


def live_cells(torch, runner, inp):
    """The (cell, halo) pairs that K15's inputs need, the cells with r <
    rmax inside each halo's box, counted on the card with the plain
    version's geometry, bucket by bucket."""
    from baryonforge_torch.ops import grid as tgrid
    gm = runner.GriddedMap
    ndim = 2 if gm.is2D else 3
    live = 0
    for idx, Ns in runner._buckets(inp["Nsize"]):
        ix = torch.as_tensor(idx, device=DEVICE)
        h = {k: None if v is None else v[ix]
             for k, v in inp["halos"].items()}
        step = max(1, tgrid._CHUNK_CELLS // Ns ** ndim)
        for h0 in range(0, ix.numel(), step):
            sl = slice(h0, h0 + step)
            rmat = None if h["rmat"] is None else h["rmat"][sl]
            _, _, r = tgrid._geometry(gm.Npix, Ns, gm.res, h["cen"][sl],
                                      h["doff"][sl], rmat)
            live += int((r < h["rmax"][sl, None]).sum())
    return float(live)


def deposit_corners(torch, po, orig, npix, ndim):
    """K16's 2^d corner cells and weighted values of every source,
    concatenated (the plain version's weights): the inputs of one
    index_put_(accumulate=True), K16's library yardstick."""
    import itertools
    from baryonforge_torch.ops import scatter
    pos = scatter.lattice(npix, ndim, orig.device).to(orig.dtype) + \
        torch.where(torch.isfinite(po), po, torch.zeros_like(po)).to(
            orig.dtype)
    cw = [scatter._corner_weights_1d(pos[d], npix) for d in range(ndim)]
    idx, vals = [], []
    for corner in itertools.product((0, 1), repeat=ndim):
        ii, w = 0, orig
        for d, c in enumerate(corner):
            ii = ii * npix + cw[d][c]
            w = w * cw[d][2 + c]
        idx.append(ii)
        vals.append(w)
    return torch.cat(idx), torch.cat(vals)


# each drive_path label's timed calls' phases (runner.timings)
PHASES = {}


def drive_path(bf, torch, runner, required, label, gpu, n_halos, warm,
               calls, check_map):
    """``warm`` untimed and ``calls`` timed calls of ``runner.process()``,
    with the launch counts set to 0 just before and read just after.
    Checks that the kernels in ``required`` were launched on every call and
    ``check_map(out)``; keeps the calls' phases in PHASES[label]. Returns
    (map, launches)."""
    from baryonforge_torch.ops import _build
    _build.reset_launches()
    for _ in range(warm):
        runner.process()
    walls, phases = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.process()
        walls.append(time.perf_counter() - t0)
        phases.append(runner.timings)
    launches = dict(_build.launches)
    PHASES[label] = phases
    for k in required:
        if launches.get(k, 0) < warm + calls:
            raise AssertionError(f"{label} did not launch {k}: {launches}")
    check_map(label, out)
    q = np.percentile(np.array(walls) * 1e3, [25, 50, 75])
    log(f"[{gpu}] {label}: {calls} calls, median {q[1]:.3f} ms "
        f"({q[0]:.3f}-{q[2]:.3f}) = {n_halos / (q[1] / 1e3):.1f} halos/s; "
        "median phases (ms, CUDA events): " + ", ".join(
            f"{k} {np.median([p[k] for p in phases]):.3f}"
            for k in phases[0]))
    log(f"launches in {label}'s {warm + calls} calls: {launches}")
    return out, launches


def painted(shape):
    def check_map(label, out):
        if out.shape != shape or not np.isfinite(out).all():
            raise AssertionError(f"{label}: map not finite / wrong shape")
        if not out.max() > 0:
            raise AssertionError(f"{label} painted nothing")
    return check_map


def moved(orig):
    def check_map(label, out):
        if out.shape != orig.shape or not np.isfinite(out).all():
            raise AssertionError(f"{label}: map not finite / wrong shape")
        if not np.isclose(out.sum(), orig.sum()):
            raise AssertionError(f"{label} lost mass")
        if not np.abs(out - orig).max() > 0:
            raise AssertionError(f"{label} moved nothing")
    return check_map


def anis_bound_check(name, t, s, f64):
    """The JAX package's bounds between its tiled and scatter anisotropic
    paints (tests/test_runners_extra.py:243-261): float64 rtol 1e-6 and
    atol 1e-9 of the largest value, float32 rtol 2e-2 and atol 2e-5 of it;
    reported as the largest excess ratio (<= 1 passes)."""
    rtol, atol = (1e-6, 1e-9) if f64 else (2e-2, 2e-5)
    scale = np.abs(s).max()
    if not scale > 0:
        raise AssertionError(f"{name}: nothing painted")
    ratio = float((np.abs(t - s) / (atol * scale + rtol * np.abs(s))).max())
    check(f"{name} (|diff| / (atol max + rtol |value|))", ratio, 1.0)


def grid_card_vs_cpu(bf, torch, tabs):
    """On small grids of the same recipe (3D 32^3 and 2D 128^2 with
    ellipticity, 32 Mpc, 300 halos; and 3D 26^3 and 2D 50^2, whose cutouts
    the runners clip to the odd N // 2): K15 and K16 against their plain
    versions on the card in float64 and float32, and the grid runners on
    the card against the plain versions on the CPU, float64, to 1e-9 of the
    largest value (of the largest move for BaryonifyGrid)."""
    for ndim, npix in ((3, 32), (2, 128), (3, 26), (2, 50)):
        cat, _ = grid_inputs(bf, ndim, npix, n_halos=300, seed=GRID_SEED + 1)
        cat.cat["x"] *= 32.0 / GRID_L
        cat.cat["y"] *= 32.0 / GRID_L
        if ndim == 3:
            cat.cat["z"] *= 32.0 / GRID_L
        rng = np.random.default_rng(ndim)
        gm = bf.utils.GriddedMap(map=rng.exponential(1.0, (npix,) * ndim),
                                 bins=(np.arange(npix) + 0.5) * 32.0 / npix,
                                 cosmo=COSMO, redshift=GRID_Z)
        tab = tabs["dmo3" if ndim == 3 else "dmo2"]
        runs = [(bf.BaryonifyGrid, dict(
            epsilon_max=GRID_BARYON_EPS, model=tabs[f"b{ndim}"],
            use_ellipticity=ndim == 2)),
            (bf.PaintProfilesGrid, dict(epsilon_max=GRID_PAINT_EPS,
                                        model=tab))]
        if ndim == 2:
            runs.append((bf.PaintProfilesAnisGrid, dict(
                epsilon_max=GRID_ANIS_EPS, model=tab, Tracer_model=tab,
                Mtot_model=tab, background_val=ANIS_BG,
                global_tracer_fraction=ANIS_FRAC)))
        for cls, kw in runs:
            for dt in (torch.float64, torch.float32):
                compare_grid_kernels(
                    bf, torch, cls(cat, gm, device=DEVICE, dtype=dt, **kw),
                    f"{cls.__name__} {ndim}D {npix}^{ndim}, "
                    f"{str(dt).replace('torch.', '')}", False,
                    deposit=cls is bf.BaryonifyGrid, odd=npix % 4 == 2)
            kw.update(dtype=torch.float64)
            g = cls(cat, gm, device=DEVICE, **kw).process()
            c = cls(cat, gm, device="cpu", **kw).process()
            ref = (np.abs(c - gm.map).max() if cls is bf.BaryonifyGrid
                   else np.abs(c).max())
            if not ref > 0:
                raise AssertionError(f"{cls.__name__} {ndim}D: nothing")
            check(f"{cls.__name__} {ndim}D {npix}^{ndim}, float64, card vs "
                  "CPU", float(np.abs(g - c).max()), 1e-9 * ref)


def sum_launches(*runs):
    return {k: sum(r.get(k, 0) for r in runs)
            for k in set().union(*runs)}


def anis_card_vs_cpu(bf, torch, tab, cat, shell, eps, label):
    """The anisotropic paint on the card against the plain versions on the
    CPU, float64, tiled and scatter, to 1e-9 of the largest value; with
    background_val 0, so that the halo term (K12 or K13 and K14) is the
    whole map."""
    for deposit in ("auto", "scatter"):
        kw = dict(epsilon_max=eps, model=tab, Tracer_model=tab,
                  Mtot_model=tab, background_val=0.0,
                  global_tracer_fraction=ANIS_FRAC, dtype=torch.float64,
                  deposit=deposit)
        g = bf.PaintProfilesAnisShell(cat, anis_shell(bf, shell),
                                      device=DEVICE, **kw).process()
        c = bf.PaintProfilesAnisShell(cat, anis_shell(bf, shell),
                                      device="cpu", **kw).process()
        if not np.abs(c).max() > 0:
            raise AssertionError(f"anisotropic paint {label}: nothing")
        check(f"anisotropic paint {label}, {deposit}, float64, card vs CPU",
              float(np.abs(g - c).max()), 1e-9 * float(np.abs(c).max()))


def anis_paths(bf, torch, tab, cat, shell, gpu):
    """The anisotropic paint at its bench configuration
    (tools/anis_bench.py:76-93: model, tracer and Mtot the card's tSZ
    table), tiled (the default) and scatter, each driven with the launch
    counts set to 0 just before and read just after; the two routes held to
    the JAX package's bounds in float32 and float64 and, with
    background_val 0, on the halo term alone. Returns the launches of the
    two drives."""
    kw = dict(epsilon_max=PAINT_EPS, model=tab, Tracer_model=tab,
              Mtot_model=tab, background_val=ANIS_BG,
              global_tracer_fraction=ANIS_FRAC)
    sh = anis_shell(bf, shell)
    log(f"main path (anisotropic paint, tiled): PaintProfilesAnisShell("
        f"epsilon_max={PAINT_EPS}, the tSZ table x 3).process(), NSIDE "
        f"{NSIDE}, {N_HALOS} halos")
    out_t, l_t = drive_path(
        bf, torch, bf.PaintProfilesAnisShell(cat, sh, device=DEVICE, **kw),
        ("collapse_curves", "tile_paint", "flat_view", "tile_paint2",
         "anis_finish"), "anisotropic paint, tiled", gpu, N_HALOS, 2,
        N_CALLS, painted(sh.map.shape))
    log("main path (anisotropic paint, scatter): PaintProfilesAnisShell("
        "deposit='scatter', ...).process()")
    out_s, l_s = drive_path(
        bf, torch, bf.PaintProfilesAnisShell(cat, sh, deposit="scatter",
                                             device=DEVICE, **kw),
        ("collapse_curves", "disc_paint", "disc_paint_anis", "anis_finish"),
        "anisotropic paint, scatter", gpu, N_HALOS, 2, N_CALLS,
        painted(sh.map.shape))
    anis_bound_check("anisotropic paint: tiled vs scatter, float32", out_t,
                     out_s, False)
    runs = {}
    for name, extra in (("float64", dict(dtype=torch.float64)),
                        ("halo term, float32", dict(background_val=0.0))):
        for deposit in ("auto", "scatter"):
            runs[deposit] = bf.PaintProfilesAnisShell(
                cat, sh, deposit=deposit, device=DEVICE,
                **dict(kw, **extra)).process()
        anis_bound_check(f"anisotropic paint: tiled vs scatter, {name}",
                         runs["auto"], runs["scatter"], name == "float64")
    log(f"  halo term: largest {np.abs(runs['scatter']).max():.6e}, of the "
        f"map's {np.abs(out_s).max():.6e}")
    return sum_launches(l_t, l_s)


def grid_paths(bf, torch, tabs, gpu):
    """The grid runners at the ΔP(k) recipe's configurations: in 3D the DMO
    paint (PaintProfilesGrid, epsilon_max 10) and BaryonifyGrid
    (Baryonification3D, epsilon_max 20) of its map plus a 10% floor; in 2D
    the same with Baryonification2D and ellipticity, and
    PaintProfilesAnisGrid (epsilon_max 5) on the 2D map. Each drive sets
    the launch counts to 0 just before and reads them just after; K15 and
    K16 are held against their plain versions on each runner's own inputs.
    Returns (the drives' launches, the 3D baryonify's kernel rows, the 3D
    map it baryonified)."""
    runs, measured = [], {}
    calls = dict(n_halos=GRID_HALOS, warm=1, calls=GRID_CALLS)
    for ndim, npix in ((3, GRID3D_N), (2, GRID2D_N)):
        cat, gm0 = grid_inputs(bf, ndim, npix)
        tab = tabs[f"dmo{ndim}"]
        size = f"{npix}^{ndim}"
        log(f"main path (grid {ndim}D paint): PaintProfilesGrid(epsilon_max="
            f"{GRID_PAINT_EPS}, DMO table).process(), {size}, "
            f"{GRID_HALOS} halos")
        r_p = bf.PaintProfilesGrid(cat, gm0, epsilon_max=GRID_PAINT_EPS,
                                   model=tab, device=DEVICE)
        dmo, l_p = drive_path(bf, torch, r_p, ("collapse_curves",
                                               "grid_cutout"),
                              f"grid {ndim}D paint", gpu,
                              check_map=painted(gm0.map.shape), **calls)
        compare_grid_kernels(bf, torch, r_p, f"{ndim}D paint, {size}", False)
        gm = grid_map(bf, dmo + dmo.mean() * 0.1)
        if ndim == 3:
            gm3 = gm
        r_b = bf.BaryonifyGrid(cat, gm, epsilon_max=GRID_BARYON_EPS,
                               model=tabs[f"b{ndim}"],
                               use_ellipticity=ndim == 2, device=DEVICE)
        label = f"{ndim}D baryonify{', ellipticity' if ndim == 2 else ''}"
        measured_b = compare_grid_kernels(bf, torch, r_b,
                                          f"{label}, {size}", ndim == 3,
                                          deposit=True)
        if ndim == 3:
            measured = measured_b
        log(f"main path (grid {label}): BaryonifyGrid(epsilon_max="
            f"{GRID_BARYON_EPS}).process() on the painted map, {size}")
        _, l_b = drive_path(bf, torch, r_b, ("collapse_curves",
                                             "grid_cutout", "grid_deposit"),
                            f"grid {label}", gpu,
                            check_map=moved(gm.map), **calls)
        runs += [l_p, l_b]
        if ndim == 3:
            continue
        r_a = bf.PaintProfilesAnisGrid(
            cat, gm, epsilon_max=GRID_ANIS_EPS, model=tab, Tracer_model=tab,
            Mtot_model=tab, background_val=ANIS_BG,
            global_tracer_fraction=ANIS_FRAC, device=DEVICE)
        compare_grid_kernels(bf, torch, r_a, f"2D anisotropic paint, {size}",
                             False)
        log(f"main path (grid 2D anisotropic paint): PaintProfilesAnisGrid("
            f"epsilon_max={GRID_ANIS_EPS}, DMO table x 3).process() on the "
            f"painted map, {size}")
        _, l_a = drive_path(bf, torch, r_a, ("collapse_curves",
                                             "grid_cutout", "anis_finish"),
                            "grid 2D anisotropic paint", gpu,
                            check_map=painted(gm.map.shape), **calls)
        runs.append(l_a)
    return sum_launches(*runs), measured, gm3


def family_tables(bf):
    """name -> (a function making the table on a device, its grid, the
    small grid of its card-vs-CPU check, the kernels its build must
    launch)."""
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    P = bf.Profiles
    m20_par = dict(P.Mead20.Tagn2pars(M20_TAGN), proj_cutoff=100)
    s25_par = dict(S25, proj_cutoff=100)
    small_b = dict(B_GRID, N_samples_Mass=4, N_samples_R=16)

    def a20(device):
        return bf.Baryonification3D(
            P.Arico20.DarkMatterOnly(**A20), P.Arico20.DarkMatterBaryon(
                **A20), cosmo, epsilon_max=GRID_BARYON_EPS, device=device)

    def m20(device):
        return bf.Baryonification2D(
            P.Mead20.DarkMatterOnlywithLSS(**m20_par),
            P.Mead20.DarkMatterBaryonwithLSS(**m20_par), cosmo,
            epsilon_max=EPS_MAX, device=device)

    def s25(device):
        return bf.Baryonification2D(
            P.Schneider25.DarkMatterOnly(**s25_par),
            P.Schneider25.DarkMatterBaryon(**s25_par), cosmo,
            epsilon_max=EPS_MAX, device=device)

    def b12(device):
        return bf.utils.TabulatedProfile(
            P.Battaglia.ElectronPressure("200_AGN", proj_cutoff=100), cosmo,
            device=device)
    return {"a20_grid": (a20, B_GRID, small_b, ("table_rows",)),
            "m20_shell": (m20, BENCH_GRID, SMALL_GRID,
                          ("fht", "table_rows")),
            "s25_shell": (s25, BENCH_GRID, SMALL_GRID,
                          ("fht", "table_rows")),
            "b12_paint": (b12, BENCH_GRID, SMALL_GRID, ())}


def table_diff(g, c):
    """(max |diff|, scale) of two builds: the displacement table and its
    largest |d|, or a tabulated profile's logs (scale 1: the logs)."""
    if hasattr(c, "raw_input_d"):
        return (float(np.abs(g.raw_input_d - c.raw_input_d).max()),
                float(np.abs(c.raw_input_d).max()))
    return (float(max(np.abs(g.raw_input_3D - c.raw_input_3D).max(),
                      np.abs(g.raw_input_2D - c.raw_input_2D).max())), 1.0)


def build_family_table(bf, torch, gpu, name):
    """The path's table built on the card, timed, with the launch counts set
    to 0 just before and read just after; a small table on the card against
    the CPU's to 1e-9 (of the largest |d|, or in the logs); a second build
    timed too. Returns (table, launches, first build ms)."""
    from baryonforge_torch.ops import _build
    make, grid, small, required = family_tables(bf)[name]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab = make(DEVICE).setup_interpolator(**grid)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launches)
    n_z = grid["N_samples_z"]
    for k in required:
        if launches.get(k, 0) < n_z:
            raise AssertionError(f"{name} table build launched {k} "
                                 f"{launches.get(k, 0)} times: {launches}")
    shape = (n_z, grid["N_samples_Mass"], grid["N_samples_R"])
    vals = tab.raw_input_d if hasattr(tab, "raw_input_d") else \
        tab.raw_input_2D
    if vals.shape != shape or not np.isfinite(vals).all():
        raise AssertionError(f"{name} table: not finite / wrong shape")
    t0 = time.perf_counter()
    make(DEVICE).setup_interpolator(**grid)
    torch.cuda.synchronize()
    again = (time.perf_counter() - t0) * 1e3
    log(f"[{gpu}] {name} table build ({' x '.join(map(str, shape))}, "
        f"z x M x r) on the card: first {wall:.1f} ms, again {again:.1f} ms "
        f"= {again / n_z:.1f} ms per redshift; launches {launches}")
    err, scale = table_diff(make(DEVICE).setup_interpolator(**small),
                            make("cpu").setup_interpolator(**small))
    check(f"{name} table {small['N_samples_z']} x {small['N_samples_Mass']}"
          f" x {small['N_samples_R']}, card vs CPU", err, 1e-9 * scale)
    return tab, launches, wall


def family_paths(bf, torch, gpu, cat, shell, gm3):
    """The four paths of the remaining profile families, each its table
    built on the card (build_family_table) and its runner at full width,
    one warm and FAMILY_CALLS timed calls with the launch counts set to 0
    just before and read just after (drive_path):
      * Arico20 ΔP(k): BaryonifyGrid(epsilon_max=20) on the grid path's
        3D map (256^3, 7,088 halos of seed 3, z 0.2; BASELINE.md:14);
      * Mead20: the tiled shell engine at the bench;
      * Schneider25: the scatter shell path at the bench;
      * Battaglia12 tSZ: the tiled paint at the bench, epsilon_max 5.
    Returns {path: launches of its table build and runner}."""
    out = {}
    calls = dict(warm=1, calls=FAMILY_CALLS)
    tab, l_tab, _ = build_family_table(bf, torch, gpu, "a20_grid")
    cat3, _ = grid_inputs(bf, 3, GRID3D_N)
    log(f"main path (Arico20 ΔP(k)): BaryonifyGrid(epsilon_max="
        f"{GRID_BARYON_EPS}, Arico20 table).process() on the grid path's "
        f"map, {GRID3D_N}^3, {GRID_HALOS} halos")
    _, l_run = drive_path(
        bf, torch, bf.BaryonifyGrid(cat3, gm3, epsilon_max=GRID_BARYON_EPS,
                                    model=tab, device=DEVICE),
        ("collapse_curves", "grid_cutout", "grid_deposit"),
        "Arico20 grid baryonify", gpu, n_halos=GRID_HALOS,
        check_map=moved(gm3.map), **calls)
    out["a20_grid"] = sum_launches(l_tab, l_run)

    for name, label, kw, required in (
            ("m20_shell", "Mead20 shell, tiled",
             dict(regrid_dtype=torch.float32),
             ("collapse_curves", "tile_deposit", "stencil_hot", "stencil",
              "stencil_complement", "flat_view", "tile_view")),
            ("s25_shell", "Schneider25 shell, scatter",
             dict(deposit="scatter", regrid="scatter",
                  regrid_dtype=torch.float32),
             ("collapse_curves", "disc_deposit", "regrid"))):
        tab, l_tab, _ = build_family_table(bf, torch, gpu, name)
        log(f"main path ({label}): BaryonifyShell({kw}).process(), NSIDE "
            f"{NSIDE}, {N_HALOS} halos")
        _, l_run = drive_path(
            bf, torch, bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                         model=tab, device=DEVICE, **kw),
            required, label, gpu, n_halos=N_HALOS,
            check_map=moved(shell.map), **calls)
        out[name] = sum_launches(l_tab, l_run)

    tab, l_tab, _ = build_family_table(bf, torch, gpu, "b12_paint")
    log(f"main path (Battaglia12 tSZ paint, tiled): PaintProfilesShell("
        f"epsilon_max={PAINT_EPS}, ElectronPressure table).process(), NSIDE "
        f"{NSIDE}, {N_HALOS} halos")
    _, l_run = drive_path(
        bf, torch, bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS,
                                         model=tab, device=DEVICE),
        ("collapse_curves", "tile_paint", "flat_view"),
        "Battaglia12 tSZ paint, tiled", gpu, n_halos=N_HALOS,
        check_map=painted(shell.map.shape), **calls)
    out["b12_paint"] = sum_launches(l_tab, l_run)
    return out


# the snapshot bench (tools/snapshot_bench.py:29-73): 10^6 particles, 20,000
# halos in a 512 Mpc box, seed 11, z 0.2, float32, the DarkMatter /
# DarkMatter(epsilon 2) Baryonification3D table of 2 z x 12 M x 48 r
SNAP_PARTS, SNAP_HALOS, SNAP_L, SNAP_SEED, SNAP_Z = 1_000_000, 20_000, 512.0, \
    11, 0.2
SNAP_GRID = dict(z_min=0.1, z_max=0.3, N_samples_z=2, M_min=5e12, M_max=2e15,
                 N_samples_Mass=12, R_min=1e-3, R_max=50, N_samples_R=48,
                 verbose=False)
SNAP_CALLS = 3          # steady process() calls, after the first
# the large snapshot: tools/snapshot_bench.py:57-65's generator at 512^3
# particles and 40,000 halos (L 512, seed 11, z 0.2, float32, the bench
# table), over 2^31 - 1 (halo, particle) pairs; BIG_CALLS steady calls
# after the first, checked on BIG_CHECK_PARTS particles and
# BIG_CHECK_HALOS halos against brute force on the card
BIG_PARTS, BIG_HALOS, BIG_CALLS = 512 ** 3, 40_000, 2
BIG_CHECK_PARTS, BIG_CHECK_HALOS = 4096, 256
# the ΔCl recipe (examples/15_delta_cl.py) at NSIDE 1024, lmax 3 NSIDE - 1
CL_NSIDE, CL_HALOS, CL_SEED = 1024, 150, 1
CL_GRID = dict(z_min=0.05, z_max=0.3, N_samples_z=3, M_min=5e13, M_max=3e15,
               N_samples_Mass=8, R_min=1e-3, R_max=60, N_samples_R=64,
               verbose=False)


def snapshot_model(bf, device):
    """The snapshot bench's Baryonification3D(DarkMatter, DarkMatter(epsilon
    2)), built on ``device`` on SNAP_GRID."""
    P = bf.Profiles
    return bf.Baryonification3D(
        P.DarkMatter(**BPAR), P.DarkMatter(**{**BPAR, "epsilon": 2.0}),
        bf.cosmo.cosmology_from_dict(COSMO), epsilon_max=20,
        device=device).setup_interpolator(**SNAP_GRID)


def snapshot_inputs(bf, ndim, L, n_part, n_halos, seed, logM=(13.0, 14.8),
                    z=SNAP_Z):
    """(catalog, snapshot) of uniform particles and halos in a periodic box,
    as tools/snapshot_bench.py:57-65 makes them."""
    rng = np.random.default_rng(seed)
    cols = {c: rng.uniform(0, L, n_part) for c in "xyz"[:ndim]}
    hcols = {c: rng.uniform(0, L, n_halos) for c in "xyz"[:ndim]}
    snap = bf.utils.ParticleSnapshot(**cols, M=np.ones(n_part), L=L,
                                     cosmo=COSMO, redshift=z)
    cat = bf.utils.HaloNDCatalog(**hcols, M=10 ** rng.uniform(*logM, n_halos),
                                 redshift=z, cosmo=COSMO)
    return cat, snap


def moves(out, snap):
    """Minimum-image displacements (ndim, n) of a snapshot runner's
    output."""
    L = snap.L
    cols = "xy" if snap.is2D else "xyz"
    d = np.stack([np.asarray(out[c], float) - snap.cat[c] for c in cols])
    d = np.where(d > L / 2, d - L, d)
    return np.where(d < -L / 2, d + L, d)


def snapshot_f32_check(name, got, want):
    """tests/test_snapshot.py:67: atol 5e-4, rtol 1e-3, as the largest
    excess ratio (<= 1 passes)."""
    ratio = float((np.abs(got - want) / (5e-4 + 1e-3 * np.abs(want))).max())
    check(f"{name} (|diff| / (5e-4 + 1e-3 |value|))", ratio, 1.0)


def compare_snapshot_kernels(bf, torch, model):
    """K17 against its plain versions on the card (the halo-major reference
    and the gather in the particle-major layout), on small boxes (2D and
    3D) whose largest query radius exceeds L / 3, from a runner's own
    inputs: float64 to 1e-10 of the largest offset, float32 to tests/
    test_snapshot.py:67, two launches bitwise equal; then
    BaryonifySnapshot on the card against the plain versions on the CPU,
    float64, to 1e-10 of the largest displacement."""
    from baryonforge_torch.ops import snapshot
    from baryonforge_torch.utils.trace import PhaseClock
    for ndim in (3, 2):
        cat, snap = snapshot_inputs(bf, ndim, 96.0, 20000, 60, 17 + ndim,
                                    logM=(13.0, 15.2))
        kw = dict(epsilon_max=20, model=model)
        for dt in (torch.float64, torch.float32):
            r = bf.BaryonifySnapshot(cat, snap, dtype=dt, device=DEVICE, **kw)
            args = r._displace_inputs(PhaseClock(torch.device(DEVICE)))
            if ndim == 3 and not float(args[9].max()) > 96.0 / 3:
                raise AssertionError("snapshot box: no radius above L / 3")
            got = snapshot.snapshot_displace(*args)
            again = snapshot.snapshot_displace(*args)
            want = snapshot.snapshot_displace_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("K17: two launches differ")
            scale = float(want.abs().max())
            if not scale > 0:
                raise AssertionError("snapshot box: nothing displaced")
            gather = snapshot.snapshot_gather_plain(*args)
            for name, ref in (("", want), (", gather", gather)):
                label = (f"K17 snapshot_displace [{ndim}D, L 96, "
                         f"{int(args[3][-1])} pairs, "
                         f"{str(dt).replace('torch.', '')}{name}]")
                if dt == torch.float64:
                    check(label, float((got - ref).abs().max()),
                          1e-10 * scale)
                else:
                    snapshot_f32_check(label, got.double().cpu().numpy(),
                                       ref.double().cpu().numpy())
        k24_check(bf, torch, r, f"{ndim}D, L 96")
        kw["dtype"] = torch.float64
        g = moves(bf.BaryonifySnapshot(cat, snap, device=DEVICE,
                                       **kw).process(), snap)
        c = moves(bf.BaryonifySnapshot(cat, snap, device="cpu",
                                       **kw).process(), snap)
        check(f"BaryonifySnapshot {ndim}D, float64, card vs CPU",
              float(np.abs(g - c).max()), 1e-10 * float(np.abs(c).max()))


_HOST_SEARCHES = [0]


def count_host_searches():
    """Count the snapshot runner's calls of its host searches
    (native.cell_query, the cKDTree), which a card runner must not make."""
    from baryonforge_torch.Runners import SnapshotRunner as SR
    query, tree = SR.cell_query, SR.DefaultRunnerSnapshot.tree

    def counted_query(*a, **k):
        _HOST_SEARCHES[0] += 1
        return query(*a, **k)

    def counted_tree(self):
        _HOST_SEARCHES[0] += 1
        return tree.fget(self)
    SR.cell_query = counted_query
    SR.DefaultRunnerSnapshot.tree = property(counted_tree)


def same_sets(torch, counts, a, b, n_part):
    """Whether the pair lists ``a`` and ``b`` (grouped per halo, ``counts``
    a halo) hold the same particles per halo: each list's (halo, particle)
    keys sorted on the card and compared."""
    dev = torch.device(DEVICE)
    row = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  torch.as_tensor(counts, device=dev))

    def keys(x):
        return torch.sort(row * n_part + torch.as_tensor(x, device=dev)
                          .long()).values
    return bool(torch.equal(keys(a), keys(b)))


def k24_check(bf, torch, runner, label):
    """K24's pairs in a card runner (its counts and its one chunk's rows)
    against its plain version on the card, halo for halo; in 3D its counts
    and sets against native.cell_query's, in 2D against cKDTree's. Raises
    when one differs, or when the runner called a host search."""
    from baryonforge_torch import native
    from baryonforge_torch.ops import snapshot
    before = _HOST_SEARCHES[0]
    _, _, _, R_q, hpos, _ = runner._host_prep()
    (_, _, parts), _ = runner._neighbour_pairs(hpos, R_q)
    if _HOST_SEARCHES[0] != before or runner._tree is not None:
        raise AssertionError(f"K24 [{label}]: the card runner searched on "
                             "the host")
    counts = np.diff(runner._pairs[1])
    coords = runner._device_coords()
    n, ndim = coords.shape
    L = runner.ParticleSnapshot.L
    dev = torch.device(DEVICE)
    pc, _, pp = snapshot.cell_query_plain(
        coords, L, torch.as_tensor(hpos, device=dev),
        torch.as_tensor(R_q, device=dev))
    if pc.cpu().numpy().tolist() != counts.tolist() \
            or not same_sets(torch, counts, parts, pp, n):
        raise AssertionError(f"K24 [{label}]: not its plain version's sets")
    if ndim == 3:
        hc, hp = native.cell_query(runner._coords, L, hpos, R_q)
        host = "native.cell_query"
    else:
        from scipy.spatial import cKDTree
        lists = cKDTree(np.mod(runner._coords, L), boxsize=L) \
            .query_ball_point(np.mod(hpos, L), R_q)
        hc = np.array([len(x) for x in lists], dtype=np.int64)
        hp = np.concatenate([np.asarray(x, np.int64) for x in lists])
        host = "cKDTree"
    if hc.tolist() != counts.tolist() or not same_sets(torch, counts, parts,
                                                       hp, n):
        raise AssertionError(f"K24 [{label}]: not {host}'s sets")
    log(f"  K24 cell list [{label}, {int(counts.sum())} pairs of "
        f"{len(counts)} halos, radii up to {R_q.max():.2f}]: the sets of its "
        f"plain version and of {host}, halo for halo; no host search")


def k24_bench(bf, torch, gpu, runner):
    """K24 at the bench, on the runner's own positions and radii: one whole
    search by wrapper (the build, the count pass, the write pass of all
    halos), each launch on the device alone (CUDA graphs of 20), beside its
    plain version on the card and the host cell list on the same input;
    the sets checked against both. Returns K24's kernel row."""
    from baryonforge_torch import native
    from baryonforge_torch.ops import _build, snapshot
    _, _, _, R_q, hpos, _ = runner._host_prep()
    coords = runner._device_coords()
    n, ndim = coords.shape
    nh = len(R_q)
    L = runner.ParticleSnapshot.L
    dev = torch.device(DEVICE)
    ncell, cell = snapshot.cell_grid(n, ndim, L, R_q)

    def search():
        cells = snapshot.cell_build(coords, L, ncell)
        q = snapshot.cell_count(cells, hpos, R_q)
        return cells, q, snapshot.cell_write(cells, q, 0, nh)
    cells, q, parts = search()
    counts = np.diff(q.offsets)
    n_pairs = int(q.offsets[-1])
    ms = time_ms(torch, search, 5)
    hits = torch.empty(int(q.items[-1]), dtype=torch.int32, device=dev)
    lib = _build.library()

    def count_alone():
        lib.bf_cell_count(
            ndim, 0, hits.numel(), 0, nh, float(L), ncell,
            _build.ptr(cells.start), _build.ptr(cells.pos),
            _build.ptr(q.centers), _build.ptr(q.radii), _build.ptr(q.win),
            _build.ptr(q.item_start), _build.ptr(hits),
            _build.stream_of(hits))
    alone = [graph_ms(torch, lambda: snapshot.cell_build(coords, L, ncell)),
             graph_ms(torch, count_alone),
             graph_ms(torch, lambda: snapshot.cell_write(cells, q, 0, nh))]
    (pc, _, pp), plain_s = timed(torch, lambda: snapshot.cell_query_plain(
        coords, L, torch.as_tensor(hpos, device=dev),
        torch.as_tensor(R_q, device=dev)))
    (hc, hp), host_s = timed(torch, lambda: native.cell_query(
        runner._coords, L, hpos, R_q))
    err = float(np.abs(pc.cpu().numpy() - counts).max())
    if err != 0 or not same_sets(torch, counts, parts, pp, n):
        raise AssertionError("K24 at the bench: not its plain version's sets")
    if hc.tolist() != counts.tolist() or not same_sets(torch, counts, parts,
                                                       hp, n):
        raise AssertionError("K24 at the bench: not native.cell_query's sets")
    # bytes: the positions, centres and radii read once, the counts and
    # offsets (int64) and the pairs' particles (int32) written once;
    # operations: a pair's distance at least, ~10 float64
    nb = coords.numel() * 8 + nh * (ndim + 1) * 8 + (2 * nh + 1) * 8 \
        + 4 * n_pairs
    b_ms, b_by = bound(nb, 10 * n_pairs, F64_FLOPS)
    log(f"  K24 cell list [bench, {n_pairs} pairs, {ncell}^3 cells of "
        f"{cell:.3f}, {int(q.items[-1])} items]: the sets of its plain "
        "version and of native.cell_query, halo for halo")
    log(f"[{gpu}] K24 cell list at the bench: a whole search by wrapper "
        f"{ms:.4f} ms (build, count, write); the device alone: build "
        f"{alone[0]:.4f} ms, count {alone[1]:.4f} ms, write {alone[2]:.4f} "
        f"ms; plain (brute force on the card) {plain_s * 1e3:.1f} ms; the "
        f"host cell list on the same input {host_s * 1e3:.1f} ms; bound "
        f"{b_ms:.4f} ms ({b_by})")
    return {"cell_list": (err, ms, plain_s * 1e3, b_ms, b_by, None)}


def snapshot_chunks(bf, torch, gpu, model, cat, snap):
    """The snapshot bench in chunks: PAIR_BUDGET lowered to a quarter of
    its pairs (4 chunks or more), every run bit for bit the one-chunk run,
    on the curve path and the direct path (the model behind HideCurves),
    in float32 and float64."""
    from baryonforge_torch.Runners import SnapshotRunner as SR
    budget = SR.PAIR_BUDGET
    for direct in (False, True):
        m = HideCurves(model) if direct else model
        for dt in (torch.float32, torch.float64):
            kw = dict(epsilon_max=20, model=m, dtype=dt, verbose=False,
                      device=DEVICE)
            one = bf.BaryonifySnapshot(cat, snap, **kw)
            want = one.process()
            n_pairs = int(one._pairs[1][-1])
            del one
            SR.PAIR_BUDGET = n_pairs // 4
            try:
                r = bf.BaryonifySnapshot(cat, snap, **kw)
                t0 = time.perf_counter()
                got = r.process()
                wall = time.perf_counter() - t0
                n_chunks = len(r._shard_chunks(1)[0])
            finally:
                SR.PAIR_BUDGET = budget
            label = (f"snapshot bench in {n_chunks} chunks of at most "
                     f"{n_pairs // 4} pairs, {'direct' if direct else 'curve'}"
                     f" path, {str(dt).replace('torch.', '')}")
            if n_chunks < 4:
                raise AssertionError(f"{label}: fewer than 4 chunks")
            for c in "xyz":
                if not np.array_equal(got[c], want[c]):
                    raise AssertionError(f"{label}: not the one-chunk run's")
            log(f"  {label}: bitwise the one-chunk run (first call "
                f"{wall * 1e3:.1f} ms)")


def snapshot_halo_cut(bf, torch, gpu, model):
    """A halo of more pairs than a chunk takes, cut across chunks: a box of
    200,000 particles and 24 halos (L 96, logM 13-14.8, the bench's
    seed), PAIR_BUDGET lowered to a third of its largest halo's pairs, so
    that halo runs in three chunks or more of its own pairs; every chunk
    within the budget, K24's write pass launched once a chunk, and the run
    bit for bit the one-chunk run, on the curve path and the direct path
    (the model behind HideCurves), float32."""
    from baryonforge_torch.Runners import SnapshotRunner as SR
    from baryonforge_torch.ops import _build, snapshot
    cat, snap = snapshot_inputs(bf, 3, 96.0, 200_000, 24, SNAP_SEED)
    budget = SR.PAIR_BUDGET
    for direct in (False, True):
        kw = dict(epsilon_max=20, model=HideCurves(model) if direct
                  else model, dtype=torch.float32, verbose=False,
                  device=DEVICE)
        one = bf.BaryonifySnapshot(cat, snap, **kw)
        want = one.process()
        counts = np.diff(one._pairs[1])
        del one
        cut = int(counts.max()) // 3
        chunks = snapshot.pair_chunks(counts, cut)
        big = int(np.argmax(counts))
        pieces = sum(1 for c in chunks if c[:2] == (big, big + 1))
        label = (f"snapshot, {counts.size} halos, {int(counts.sum())} pairs, "
                 f"the largest halo's {int(counts[big])} in {pieces} chunks "
                 f"of at most {cut} ({len(chunks)} chunks), "
                 f"{'direct' if direct else 'curve'} path, float32")
        if pieces < 3 or max(c[3] - c[2] for c in chunks) > cut:
            raise AssertionError(f"{label}: not cut as planned")
        SR.PAIR_BUDGET = cut
        try:
            r = bf.BaryonifySnapshot(cat, snap, **kw)
            _build.reset_launches()
            t0 = time.perf_counter()
            got = r.process()
            wall = time.perf_counter() - t0
            writes = _build.launches["cell_write"]
        finally:
            SR.PAIR_BUDGET = budget
        if writes != len(chunks):
            raise AssertionError(f"{label}: {writes} write passes")
        for c in "xyz":
            if not np.array_equal(got[c], want[c]):
                raise AssertionError(f"{label}: not the one-chunk run's")
        log(f"  {label}: bitwise the one-chunk run, {writes} write passes "
            f"(first call {wall * 1e3:.1f} ms)")


def brute_force_subset(bf, torch, model, cat, snap, pidx, eps=20,
                       hchunk=2000):
    """tests/test_snapshot.py:50-64 for the particles ``pidx`` on the card:
    each one's min-image displacement by every halo within min(eps R / a,
    L / 2), from the model's table readout in float64 (one vmapped readout
    of all the pairs, a row each), summed in float64. Returns (3,
    len(pidx)) numpy."""
    from baryonforge_torch.ops.direct import readout, uniform_layout
    dev = torch.device(DEVICE)
    m = model.with_dtype(torch.float64, device=dev)
    L = snap.L
    a = 1.0 / (1.0 + cat.redshift)
    M = np.asarray(cat.cat["M"], float)
    R = m.mass_def.get_radius(bf.cosmo.cosmology_from_dict(COSMO), M,
                              a).numpy()
    lim = torch.as_tensor(np.minimum(eps * R / a, L / 2), device=dev)
    pos = torch.as_tensor(np.stack([snap.cat[c][pidx] for c in "xyz"], 1),
                          device=dev)
    hpos = torch.as_tensor(np.stack([cat.cat[c] for c in "xyz"], 1),
                           device=dev)
    found = []
    for h0 in range(0, len(M), hchunk):
        dx = pos[:, None, :] - hpos[None, h0:h0 + hchunk, :]
        dx = torch.where(dx > L / 2, dx - L, dx)
        dx = torch.where(dx < -L / 2, dx + L, dx)
        d = torch.sqrt((dx ** 2).sum(-1))
        p, h = torch.nonzero(d < lim[None, h0:h0 + hchunk], as_tuple=True)
        found.append((p, h + h0, dx[p, h], d[p, h]))
    p, h, dx, d = (torch.cat(x) for x in zip(*found))
    vals = readout(lambda r, M: m.displacement(r, M, a), d,
                   uniform_layout(d.numel(), 1),
                   {"M": torch.as_tensor(M, device=dev)[h]}, torch.float64)
    vals = torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))
    want = torch.zeros_like(pos)
    want.index_add_(0, p, vals[:, None] * dx / d[:, None])
    return want.T.cpu().numpy(), int(d.numel())


def large_snapshot(bf, torch, gpu, model):
    """BaryonifySnapshot past 2^31 - 1 pairs: tools/snapshot_bench.py:57-65's
    generator at 512^3 particles and 40,000 halos (L 512, seed 11, z 0.2,
    float32, the bench table), the first call and BIG_CALLS steady calls
    with their phases and the launch counts (K24 and K17 in every chunk,
    no host search), the pairs, chunks and peak device memory; 4,096
    random particles' offsets against a brute-force float64 sum over all
    40,000 halos on the card (tests/test_snapshot.py:67) and 256 random
    halos' counts against a brute-force count on the card; then two more
    calls of that runner with the chunks kept (PAIR_CACHE_BYTES raised
    above them: the first keeps them, the second reads them), the other
    choice of the cache. Returns the launches of the first run."""
    import gc
    from baryonforge_torch.Runners import SnapshotRunner as SR
    from baryonforge_torch.ops import _build, snapshot
    t_phase = time.perf_counter()
    cat, snap = snapshot_inputs(bf, 3, SNAP_L, BIG_PARTS, BIG_HALOS,
                                SNAP_SEED)
    log(f"large snapshot: {BIG_PARTS} particles, {BIG_HALOS} halos, L "
        f"{SNAP_L:g}, made in {time.perf_counter() - t_phase:.1f} s")
    rng = np.random.default_rng(5)
    pidx = np.sort(rng.choice(BIG_PARTS, BIG_CHECK_PARTS, replace=False))
    hidx = np.sort(rng.choice(BIG_HALOS, BIG_CHECK_HALOS, replace=False))
    fmt = (lambda p: ", ".join(f"{k} {v:.1f}" for k, v in p.items()))

    def drive(runner, label, calls, counted):
        """``calls`` + 1 calls of ``runner``, checked and logged; K24's
        build and count pass expected when ``counted`` (a new runner)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = _HOST_SEARCHES[0]
        _build.reset_launches()
        walls, phases = [], []
        for _ in range(1 + calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runner.process()
            walls.append(time.perf_counter() - t0)
            phases.append(runner.timings)
        launches = dict(_build.launches)
        first = runner._pairs[1]
        n_pairs = int(first[-1])
        n_chunks = sum(1 for c in snapshot.pair_chunks(
            np.diff(first), SR.PAIR_BUDGET) if c[3] > c[2])
        peak = torch.cuda.max_memory_allocated()
        if _HOST_SEARCHES[0] != before or runner._tree is not None:
            raise AssertionError("large snapshot: the card runner searched "
                                 "on the host")
        for k, want in (("cell_build", counted), ("cell_count", counted),
                        ("cell_write", n_chunks),
                        ("collapse_curves", 1 + calls),
                        ("snapshot_displace", n_chunks * (1 + calls))):
            if launches.get(k, 0) < want:
                raise AssertionError(f"large snapshot: {k} launched fewer "
                                     f"than {want} times: {launches}")
        label += (", the chunks kept" if 1 in runner._pairs[3]
                  else ", the chunks made anew each call")
        log(f"[{gpu}] large snapshot, {label}: {n_pairs} pairs (2^31 - 1 = "
            f"{2 ** 31 - 1}) in {n_chunks} chunks of at most "
            f"{SR.PAIR_BUDGET}; first call {walls[0] * 1e3:.1f} ms "
            f"(phases: {fmt(phases[0])}); steady calls " + "; ".join(
                f"{w * 1e3:.1f} ms ({fmt(p)})"
                for w, p in zip(walls[1:], phases[1:]))
            + f"; peak device memory {peak / 2 ** 30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); launches {launches}")
        return out, n_pairs, launches

    runner = bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=model,
                                  device=DEVICE)
    out, n_pairs, launches = drive(
        runner, f"PAIR_CACHE_BYTES {SR.PAIR_CACHE_BYTES} ("
        f"{SR.KEPT_PAIR_BYTES} bytes a pair kept)", BIG_CALLS, 1)
    if n_pairs <= 2 ** 31 - 1:
        raise AssertionError(f"large snapshot: {n_pairs} pairs, not past "
                             "2^31 - 1")
    got = np.stack([np.asarray(out[c][pidx]) - snap.cat[c][pidx]
                    for c in "xyz"])
    got = np.where(got > SNAP_L / 2, got - SNAP_L, got)
    got = np.where(got < -SNAP_L / 2, got + SNAP_L, got)
    if not np.isfinite(got).all():
        raise AssertionError("large snapshot: output not finite")
    want, n_bf = brute_force_subset(bf, torch, model, cat, snap, pidx)
    snapshot_f32_check(f"large snapshot, {BIG_CHECK_PARTS} particles ("
                       f"{n_bf} pairs) vs the brute-force float64 sum over "
                       f"{BIG_HALOS} halos on the card", got, want)
    _, _, _, R_q, hpos, _ = runner._host_prep()
    dev = torch.device(DEVICE)
    pc = snapshot.cell_query_plain(
        runner._device_coords(), SNAP_L,
        torch.as_tensor(hpos[hidx], device=dev),
        torch.as_tensor(R_q[hidx], device=dev), block=1 << 26)[0]
    counts = np.diff(runner._pairs[1])[hidx]
    if pc.cpu().numpy().tolist() != counts.tolist():
        raise AssertionError("large snapshot: K24's counts are not the "
                             "brute-force counts")
    log(f"  large snapshot: {BIG_CHECK_HALOS} halos' counts ({counts.min()}"
        f"-{counts.max()} pairs) equal the brute-force counts on the card")
    del out
    kept = SR.PAIR_CACHE_BYTES
    SR.PAIR_CACHE_BYTES = 1 << 40
    try:
        drive(runner, "the same runner, PAIR_CACHE_BYTES raised to 2^40", 1,
              0)
    finally:
        SR.PAIR_CACHE_BYTES = kept
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{gpu}] large snapshot phase: {time.perf_counter() - t_phase:.1f} "
        "s wall")
    return launches


def brute_force_moves(bf, torch, model, cat, snap, eps=20, chunk=8):
    """tests/test_snapshot.py:50-64 on the card: every halo's min-image
    displacements over all particles, from the model's table readout
    (float64), chunk halos at a time. Returns (3, n_part) numpy."""
    dev = torch.device(DEVICE)
    m = model.with_dtype(torch.float64, device=dev)
    L = snap.L
    a = 1.0 / (1.0 + cat.redshift)
    M = np.asarray(cat.cat["M"], float)
    R = m.mass_def.get_radius(bf.cosmo.cosmology_from_dict(COSMO), M,
                              a).numpy()
    pos = torch.as_tensor(np.stack([snap.cat[c] for c in "xyz"]), device=dev)
    hpos = np.stack([cat.cat[c] for c in "xyz"], 1)
    want = torch.zeros_like(pos)
    for j in range(len(M)):
        dx = pos - torch.as_tensor(hpos[j], device=dev)[:, None]
        dx = torch.where(dx > L / 2, dx - L, dx)
        dx = torch.where(dx < -L / 2, dx + L, dx)
        d = torch.sqrt((dx ** 2).sum(0))
        sel = d < min(eps * R[j] / a, L / 2)
        off = m.displacement(d[sel], M[j], a).reshape(-1)
        want[:, sel] += off[None, :] * dx[:, sel] / d[sel][None, :]
    return want.cpu().numpy()


def snapshot_bench(bf, torch, gpu):
    """The snapshot path at tools/snapshot_bench.py:29-73 (10^6 particles,
    20,000 halos, L 512, seed 11, z 0.2, float32), its table built on the
    card: the first call (it includes the cell list) and SNAP_CALLS steady
    calls timed, with the launch counts set to 0 just before and read just
    after; halos/s, particles/s and phases printed; the output finite; a
    256-halo subcatalog held against the brute-force sum on the card
    (tests/test_snapshot.py:67); K17 on the runner's own inputs against its
    plain version (timed) and a torch index_add_ of the same pair vectors.
    Returns (launches, K17's kernel row)."""
    from baryonforge_torch.ops import _build, snapshot
    from baryonforge_torch.utils.trace import PhaseClock
    t0 = time.perf_counter()
    model = snapshot_model(bf, DEVICE)
    log(f"[{gpu}] snapshot table on the card (Baryonification3D, 2 z x 12 M "
        f"x 48 r): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not np.isfinite(model.raw_input_d).all():
        raise AssertionError("snapshot table: not finite")
    compare_snapshot_kernels(bf, torch, model)
    cat, snap = snapshot_inputs(bf, 3, SNAP_L, SNAP_PARTS, SNAP_HALOS,
                                SNAP_SEED)
    runner = bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=model,
                                  device=DEVICE)
    log(f"main path (snapshot): BaryonifySnapshot(epsilon_max=20, "
        f"Baryonification3D).process(), {SNAP_PARTS} particles, "
        f"{SNAP_HALOS} halos, L {SNAP_L:g}")
    searches = _HOST_SEARCHES[0]
    _build.reset_launches()
    walls, phases = [], []
    for _ in range(1 + SNAP_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.process()
        walls.append(time.perf_counter() - t0)
        phases.append(runner.timings)
    launches = dict(_build.launches)
    for k, n in (("collapse_curves", 1 + SNAP_CALLS),
                 ("snapshot_displace", 1 + SNAP_CALLS), ("cell_build", 1),
                 ("cell_count", 1), ("cell_write", 1)):
        if launches.get(k, 0) < n:
            raise AssertionError(f"the snapshot path did not launch {k} "
                                 f"{n} times: {launches}")
    if _HOST_SEARCHES[0] != searches or runner._tree is not None:
        raise AssertionError("the snapshot path searched on the host")
    if len(runner._shard_chunks(1)[0]) != 1 or 1 not in runner._pairs[3]:
        raise AssertionError("the snapshot bench is not one kept chunk")
    for c in "xyz":
        if not np.isfinite(out[c]).all():
            raise AssertionError("snapshot bench: output not finite")
    steady = np.array(walls[1:]) * 1e3
    med = float(np.median(steady))
    fmt = (lambda p: ", ".join(f"{k} {v:.3f}" for k, v in p.items()))
    log(f"[{gpu}] snapshot bench: first call {walls[0] * 1e3:.1f} ms "
        f"(phases: {fmt(phases[0])})")
    log(f"[{gpu}] snapshot bench: {SNAP_CALLS} steady calls "
        f"{', '.join(f'{t:.3f}' for t in steady)} ms, median {med:.3f} ms = "
        f"{SNAP_HALOS / (med / 1e3):.1f} halos/s = "
        f"{SNAP_PARTS / (med / 1e3):.1f} particles/s; median phases (ms, "
        "CUDA events): " + ", ".join(
            f"{k} {np.median([p[k] for p in phases[1:]]):.3f}"
            for k in phases[1]))
    log(f"launches in the snapshot path's {1 + SNAP_CALLS} calls: {launches}"
        "; one chunk, kept; no host search")
    k24 = k24_bench(bf, torch, gpu, runner)
    snapshot_chunks(bf, torch, gpu, model, cat, snap)
    snapshot_halo_cut(bf, torch, gpu, model)

    sub = cat[np.arange(256)]
    got = moves(bf.BaryonifySnapshot(sub, snap, epsilon_max=20, model=model,
                                     device=DEVICE).process(), snap)
    snapshot_f32_check("snapshot bench, 256 halos, float32 vs the brute-"
                       "force sum on the card", got,
                       brute_force_moves(bf, torch, model, sub, snap))

    args = runner._displace_inputs(PhaseClock(torch.device(DEVICE)))
    coords, hpos, halos, offsets, parts, curves = args[:6]
    layout = args[11]
    n_pairs = int(offsets[-1])
    cnt = (layout[1][1:] - layout[1][:-1]).double()
    layout_ms = time_ms(torch, lambda: snapshot.particle_layout(
        coords, args[10], offsets, parts), 3)
    log(f"[{gpu}] K17's particle-major layout at the bench: pairs a particle "
        f"mean {cnt.mean().item():.3f}, 99th percentile "
        f"{torch.quantile(cnt, 0.99).item():.0f}, max {cnt.max().item():.0f}"
        f", {int((cnt == 0).sum())} particles without pairs; built (the "
        f"space order and the sort, once per pair set) in {layout_ms:.3f} ms")
    k = snapshot.snapshot_displace(*args)
    k2 = snapshot.snapshot_displace(*args)
    p = snapshot.snapshot_displace_plain(*args)
    gp = snapshot.snapshot_gather_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(k, k2):
        raise AssertionError("K17 at the bench: two launches differ")
    log("  K17 at the bench: two launches bitwise equal")
    for name, ref in (("", p), (", gather", gp)):
        snapshot_f32_check(f"K17 snapshot_displace [bench, {n_pairs} pairs"
                           f"{name}]", k.double().cpu().numpy(),
                           ref.double().cpu().numpy())
    err = float((k - p).abs().max())
    ms = time_ms(torch, lambda: snapshot.snapshot_displace(*args), 10)
    plain_ms = time_ms(torch, lambda: snapshot.snapshot_displace_plain(*args),
                       3)
    # the library yardstick, a partial one: the pair vectors, made once
    # and untimed, summed per particle by one index_add_; the displacement
    # of each pair, most of K17's work, is left out, so no single call
    # computes K17's function
    h = torch.repeat_interleave(halos.long(), (offsets[1:] - offsets[:-1])
                                .long())
    vec = (coords[parts.long()] - hpos[h]).float().T.contiguous()
    pl = parts.long()
    library_ms = time_ms(torch, lambda: torch.zeros_like(k).index_add_(
        1, pl, vec), 10)
    # bytes: the particle-major layout, the positions, the rows' halos,
    # curves and per-halo columns read once, the offsets written once;
    # operations: per pair ~14 float64 (3 differences, 6 wrap compares and
    # adds, 3 squares and sums, a square root, 3 divisions) and ~12 float32
    # (log, lerp, cut, 3 products)
    nb = nbytes(coords, hpos, halos, layout, curves, args[8], args[9]) + \
        k.numel() * k.element_size()
    b_ms, b_by = max(bound(nb, 14 * n_pairs, F64_FLOPS),
                     bound(nb, 12 * n_pairs, F32_FLOPS))
    log(f"[{gpu}] K17 snapshot_displace at the bench ({n_pairs} pairs): "
        f"kernel {ms:.4f} ms (the 0.30 ms target "
        f"{'met' if ms <= 0.30 else 'missed'}; device alone, a CUDA graph "
        f"of 20 calls: "
        f"{graph_ms(torch, lambda: snapshot.snapshot_displace(*args)):.4f} "
        f"ms), plain {plain_ms:.3f} ms, index_add_ {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return launches, {"snapshot_displace": (err, ms, plain_ms, b_ms, b_by,
                                            library_ms), **k24}, \
        (model, cat, snap)


def rfft_per_ring(torch, hmap, nside):
    """K18's library yardstick: torch.fft.rfft of the rings, one call per
    ring length, on the rings gathered beforehand (it leaves out the phi0
    turn and the wrap of m past nr)."""
    from baryonforge_torch.ops import sht
    sp, nr, _, _ = sht.ring_geometry(nside)
    rings = [hmap[torch.as_tensor(sp[nr == n][:, None] + np.arange(n)[None, :],
                                  device=hmap.device)] for n in np.unique(nr)]
    return lambda: [torch.fft.rfft(x, dim=-1) for x in rings]


def compare_sht_kernels(bf, torch, gpu, nside, lmax, timing):
    """K18 and K19 against their plain versions on the card, float64: K18
    within ops.sht.ring_modes_tolerance (the plain version's angle rounding,
    8 eps (2 pi (m + 1) + nr) sum_j |map_j| a ring), K19 within 4 n_ring
    eps of the absolute contraction sum_r |F| |lambda| (the sums over rings
    in another order). When ``timing``, times both with 2 repetitions and
    returns their kernel rows."""
    from baryonforge_torch.ops import sht
    g = torch.Generator(device=DEVICE).manual_seed(nside)
    hmap = torch.randn(12 * nside * nside, dtype=torch.float64,
                       device=DEVICE, generator=g)
    fr, fi = sht.ring_modes(hmap, nside, lmax)
    pr, pi = sht.ring_modes_plain(hmap, nside, lmax)
    tol = sht.ring_modes_tolerance(hmap, nside, lmax)
    e18 = max(float(((fr - pr).abs() / tol).max()),
              float(((fi - pi).abs() / tol).max()))
    check(f"K18 ring_modes [NSIDE {nside}, lmax {lmax}] (|diff| / "
          "tolerance)", e18, 1.0)
    # the main path's mirrored heights (every ring in a pair) and the JAX
    # heights (the south belt's rings alone)
    z = torch.as_tensor(sht.ring_heights(nside), device=DEVICE)
    zj = torch.as_tensor(sht.ring_geometry(nside)[2], device=DEVICE)
    ar, ai = sht.legendre_alm(z, pr, pi, lmax)
    wr, wi = sht.legendre_alm_plain(z, pr, pi, lmax)
    sr, si = sht.legendre_alm_plain(z, pr, pi, lmax, absolute=True)
    eps = float(np.finfo(np.float64).eps)
    tol19 = 4 * z.numel() * eps

    def rel(xr, xi, yr, yi):
        return max(float(((xr - yr).abs() / (sr + 1e-300)).max()),
                   float(((xi - yi).abs() / (si + 1e-300)).max()))
    n_chain = len(sht.mirror_pairs(z.cpu().numpy()))
    e19 = rel(ar, ai, wr, wi)
    check(f"K19 legendre_alm [NSIDE {nside}, lmax {lmax}, {n_chain} chains "
          f"of {z.numel()} rings] (|diff| / sum |F| |lambda|)", e19, tol19)
    jr, ji = sht.legendre_alm(zj, pr, pi, lmax)
    qr, qi = sht.legendre_alm_plain(zj, pr, pi, lmax)
    n_chain_j = len(sht.mirror_pairs(zj.cpu().numpy()))
    check(f"K19 legendre_alm [NSIDE {nside}, lmax {lmax}, JAX heights, "
          f"{n_chain_j} chains] (|diff| / sum |F| |lambda|)",
          rel(jr, ji, qr, qi), tol19)
    # what the mirrored heights move (the plain version on both): they are
    # kept only while that stays under half of K19's tolerance
    dz = rel(wr, wi, qr, qi)
    log(f"  K19 plain version, mirrored against JAX heights [NSIDE {nside}, "
        f"lmax {lmax}]: {dz:.3e} of sum |F| |lambda| = {dz / tol19:.4f} of "
        f"K19's tolerance ({tol19:.3e}); max |z - z_JAX| "
        f"{float((z - zj).abs().max()):.3e}")
    check(f"mirrored heights [NSIDE {nside}]: plain-version difference / "
          "K19's tolerance", dz / tol19, 0.5)
    if not timing:
        return {}
    L, n_ring = lmax + 1, z.numel()
    _, nr, _, _ = sht.ring_geometry(nside)
    out = {}
    ms = time_ms(torch, lambda: sht.ring_modes(hmap, nside, lmax), 2)
    plain_ms = time_ms(torch, lambda: sht.ring_modes_plain(hmap, nside, lmax),
                       2)
    lib_ms = time_ms(torch, rfft_per_ring(torch, hmap, nside), 2)
    # bytes: the map read once, the modes written once; operations: a real
    # FFT of each ring, ~2.5 nr log2 nr float64 operations
    ops18 = float(np.sum(2.5 * nr * np.log2(nr)))
    b = bound(hmap.numel() * 8 + 2 * n_ring * L * 8, ops18, F64_FLOPS)
    out["ring_modes"] = (float((fr - pr).abs().max()), ms, plain_ms, *b,
                         lib_ms)
    ms = time_ms(torch, lambda: sht.legendre_alm(z, pr, pi, lmax), 2)
    plain_ms = time_ms(torch, lambda: sht.legendre_alm_plain(z, pr, pi,
                                                             lmax), 2)
    # operations: 8 float64 a (chain, l, m) with l >= m (3 products and a
    # difference of the recurrence, 2 multiply-adds of the contraction),
    # on this run's chains (a pair of mirrored rings runs one recurrence);
    # bytes: the modes read once, a_lm written once
    steps = n_chain * L * (L + 1) / 2
    b = bound(2 * n_ring * L * 8 + 2 * L * L * 8, 8.0 * steps, F64_FLOPS)
    out["legendre_alm"] = (float(max((ar - wr).abs().max(),
                                     (ai - wi).abs().max())), ms, plain_ms,
                           *b, None)
    log(f"  K19 bound: {b[0]:.4f} ms on {n_chain} chains (8 operations a "
        f"chain-step over {F64_FLOPS:.3g} FLOP/s); on every ring "
        f"{8.0 * n_ring * L * (L + 1) / 2 / F64_FLOPS * 1e3:.4f} ms; the "
        f"unfused float64 instructions ({6.0 * steps:.4g}: 4 of the "
        f"recurrence and 2 fma) over {F64_INSTR:.3g}/s: "
        f"{6.0 * steps / F64_INSTR * 1e3:.4f} ms")
    log(f"[{gpu}] K18 ring_modes NSIDE {nside}, lmax {lmax}: kernel "
        f"{out['ring_modes'][1]:.3f} ms, plain {out['ring_modes'][2]:.3f} "
        f"ms, torch.fft.rfft per ring length {lib_ms:.3f} ms; K19 "
        f"legendre_alm: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return out


def ring_modes_cases(torch):
    """K18 where its design splits: NSIDE 8 with lmax 23 (m wraps past
    nr), NSIDE 48 (Bluestein for every ring whose n = nr / 2 is not a power
    of two, the belt's 96 among them) and NSIDE 64 with 2048 bytes of
    shared memory a ring (its longer rings on slots of device memory), each
    against the plain version within ops.sht.ring_modes_tolerance."""
    from baryonforge_torch.ops import sht
    card = sht.shared_memory_optin(torch.device(DEVICE))
    log(f"  K18: {card} bytes of shared memory a block (the card's opt-in)")
    for nside, lmax, smem in ((8, 23, card), (48, 143, card),
                              (64, 191, 2048)):
        g = torch.Generator(device=DEVICE).manual_seed(nside)
        hmap = torch.randn(12 * nside * nside, dtype=torch.float64,
                           device=DEVICE, generator=g)
        groups = sht.ring_plan(nside, smem)[1]
        fr, fi = sht._ring_modes_kernel(hmap, nside, lmax, smem_bytes=smem)
        pr, pi = sht.ring_modes_plain(hmap, nside, lmax)
        tol = sht.ring_modes_tolerance(hmap, nside, lmax)
        routes = (f"{int(groups[groups[:, 3] == 1, 1].sum())} Bluestein "
                  f"rings, {int(groups[groups[:, 4] == 0, 1].sum())} in "
                  "device memory")
        check(f"K18 ring_modes [NSIDE {nside}, lmax {lmax}, {routes}] "
              "(|diff| / tolerance)",
              max(float(((fr - pr).abs() / tol).max()),
                  float(((fi - pi).abs() / tol).max())), 1.0)


def sht_checks(bf, torch, gpu):
    """anafast on the card against its plain version on the CPU (NSIDE 64,
    float64, to 1e-10 of the largest C_l), and the analytic checks of
    tests/test_sht.py:38-58 at NSIDE 1024: a constant map is a monopole
    (C_0 = 4 pi v^2 to 1e-10, the rest under 1e-5 of it) and Re Y_40 has
    its power at l = 4 (1/9 within 10%, the rest under 5e-3 of it)."""
    from scipy.special import sph_harm_y
    from baryonforge_torch.ops import healpix
    from baryonforge_torch.utils import sht
    hmap = np.random.default_rng(64).standard_normal(12 * 64 * 64)
    cg = sht.anafast(hmap, device=DEVICE)
    cc = sht.anafast(hmap, device="cpu")
    check("anafast NSIDE 64, card vs CPU", float(np.abs(cg - cc).max()),
          1e-10 * float(np.abs(cc).max()))
    nside = CL_NSIDE
    cl = sht.anafast(np.full(12 * nside * nside, 2.5), lmax=6,
                     device=DEVICE)
    check(f"anafast NSIDE {nside}: constant map, C_0 / (4 pi v^2) - 1",
          abs(cl[0] / (4 * np.pi * 2.5 ** 2) - 1), 1e-10)
    check(f"anafast NSIDE {nside}: constant map, max |C_l>0| / C_0",
          float(np.abs(cl[1:]).max() / cl[0]), 1e-5)
    pix = torch.arange(12 * nside * nside, device=DEVICE)
    theta, phi = (x.cpu().numpy() for x in healpix.pix2ang(nside, pix))
    cl = sht.anafast(np.real(sph_harm_y(4, 0, theta, phi)), lmax=10,
                     device=DEVICE)
    check(f"anafast NSIDE {nside}: Re Y_40, |9 C_4 - 1|",
          abs(9 * cl[4] - 1), 0.1)
    check(f"anafast NSIDE {nside}: Re Y_40, max C_l!=4 / C_4",
          float(np.delete(cl, 4).max() / cl[4]), 5e-3)
    log(f"[{gpu}] analytic maps at NSIDE {nside}: C_4 of Re Y_40 = "
        f"{cl[4]:.6f} (1/9 = {1 / 9:.6f})")


def delta_cl(bf, torch, gpu):
    """The ΔCl recipe of examples/15_delta_cl.py at NSIDE 1024: 150 halos of
    seed 1, its DMO paint table and S19 displacement table built on the
    card, the DMO paint plus its mean, its baryonification, and anafast of
    both contrasts (lmax 3071), all on the card, with the launch counts set
    to 0 just before the paint and read after the second anafast; prints
    the four band ratios and each phase's time; the ratios finite and the
    largest scales (l 2-10) within 5% of 1 (tests/test_deltacl.py:69).
    Returns the launches."""
    from baryonforge_torch.ops import _build
    from baryonforge_torch.utils import sht
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    P = bf.Profiles
    rng = np.random.default_rng(CL_SEED)
    n = CL_HALOS
    cat = bf.utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(14.0, 15.0, n), z=rng.uniform(0.08, 0.15, n),
        cosmo=COSMO)
    phases = {}
    t0 = time.perf_counter()
    tab = bf.utils.TabulatedProfile(
        P.DarkMatterOnly(**BPAR, proj_cutoff=100), cosmo,
        device=DEVICE).setup_interpolator(**CL_GRID)
    phases["paint table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = bf.Baryonification2D(
        P.DarkMatterOnly(**BPAR, proj_cutoff=100),
        P.DarkMatterBaryon(**BPAR, proj_cutoff=100), cosmo, epsilon_max=20,
        device=DEVICE).setup_interpolator(**CL_GRID)
    phases["displacement table"] = time.perf_counter() - t0
    npix = 12 * CL_NSIDE ** 2
    lmax = 3 * CL_NSIDE - 1
    log(f"main path (ΔCl): PaintProfilesShell(epsilon_max=10) + "
        f"BaryonifyShell(epsilon_max=20) + 2 x anafast, NSIDE {CL_NSIDE}, "
        f"{n} halos, lmax {lmax}")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero = bf.utils.LightconeShell(map=np.zeros(npix), cosmo=COSMO)
    mass = bf.PaintProfilesShell(cat, zero, epsilon_max=10, model=tab,
                                 include_pixel_size=True,
                                 device=DEVICE).process()
    mass = mass + mass.mean()
    phases["paint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    new = bf.BaryonifyShell(cat, bf.utils.LightconeShell(map=mass,
                                                         cosmo=COSMO),
                            epsilon_max=20, model=model,
                            device=DEVICE).process()
    phases["baryonify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cl0 = sht.anafast(mass / mass.mean() - 1, lmax=lmax, device=DEVICE)
    phases["anafast (DMO)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cl1 = sht.anafast(new / new.mean() - 1, lmax=lmax, device=DEVICE)
    phases["anafast (baryonified)"] = time.perf_counter() - t0
    launches = dict(_build.launches)
    for k in ("ring_modes", "legendre_alm"):
        if launches.get(k, 0) != 2:
            raise AssertionError(f"the ΔCl path launched {k} "
                                 f"{launches.get(k, 0)} times: {launches}")
    ell = np.arange(lmax + 1)
    bands = []
    for lo, hi in [(2, 10), (10, 40), (40, 100), (100, lmax)]:
        m = (ell >= lo) & (ell <= hi)
        bands.append((lo, hi, float(np.mean(cl1[m] / np.maximum(cl0[m],
                                                                 1e-300)))))
    if not all(np.isfinite(b[2]) for b in bands):
        raise AssertionError(f"ΔCl ratios not finite: {bands}")
    check("ΔCl: |C_l ratio - 1| at l 2-10", abs(bands[0][2] - 1), 0.05)
    log(f"[{gpu}] ΔCl NSIDE {CL_NSIDE}: " + ", ".join(
        f"l {lo}-{hi}: {r:.4f}" for lo, hi, r in bands))
    log(f"[{gpu}] ΔCl phases (ms, host clock): " + ", ".join(
        f"{k} {v * 1e3:.1f}" for k, v in phases.items()))
    log(f"launches in the ΔCl path: {launches}")
    return launches


# H100 per-SM limits for resident warps: registers, shared memory (bytes,
# with 1 KB a block reserved), warps, blocks
SM_REGS, SM_SMEM, SM_WARPS, SM_BLOCKS = 65536, 233472, 64, 32


def tile_pairs_shape(mode, dtype_bytes):
    """K4's, K10's and K12's launch at the bench (csrc/tile_deposit.cu:
    launch): threads a block (a warp a tile) and dynamic shared memory,
    for 16 x 32 shell tiles (K4) or 8 x 16 paint tiles (K10, K12), 64
    curve points (both curves for K12), a row of ring values 16 + 4 T + 8
    bytes, up to 16 halos a chunk of 7 + n_r (+ n_r2) values."""
    RB = 16 if mode == 0 else 8
    rows = RB * (24 + 4 * dtype_bytes)
    per_halo = dtype_bytes * (7 + 64 + (64 if mode == 2 else 0))
    hc = min(16, (48 * 1024 - 16 - rows) // per_halo)
    return 32, rows + hc * per_halo


def ptxas_report(bf):
    """Registers and spills of K1's, K3's, K4's (and K10's, K12's), K5's,
    K6's, K8's, K9's, K11's, K13's, K16's, K17's, K19's, K22's, K23's and
    K24's kernels (nvcc -Xptxas -v with the
    build's own flags, their sources at once) and the warps an SM holds at
    the bench's launch shapes (the stencil with its dynamic shared memory,
    K4's template with its rows and halo chunk (tile_pairs_shape), K8
    with correlation_3d's 1 x 1024 row, 32 KB, and its Bluestein route
    with N = 100's, 12 KB, and its passes' 4096 points a block, 64 KB
    (the mode of a pass is not parsed: its lines are in build order);
    K16's window and K11's and K13's flat-walk
    layout are static shared memory, which ptxas reports)."""
    import re
    import tempfile
    from baryonforge_torch.ops import _build
    lib = _build.library()
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    threads = {"stencil_kernel": 256, "stencil_hot_kernel": 256,
               "legendre_kernel": 256, "fht_kernel": 512,
               "disc_paint_anis_kernel": 256, "disc_paint_kernel": 256,
               "grid_deposit_kernel": 256, "snapshot_gather_kernel": 128,
               "tile_pairs_kernel": 256, "regrid_init_kernel": 256,
               "regrid_move_kernel": 256, "collapse_curves_kernel": 256,
               "table_rows_kernel": 512, "stencil_complement_kernel": 256,
               "stencil_geo_kernel": 256, "grid_direct_kernel": 512,
               "grid_radii_kernel": 256, "snapshot_direct_kernel": 128,
               "snapshot_radii_kernel": 256, "cell_query_kernel": 256,
               "cell_bin_kernel": 256, "cell_place_kernel": 256,
               "collapse_curves_wide": 256, "deposit_list_kernel": 256,
               "fht_pass": 512, "fht_coeff": 256, "fht_setup": 256}
    smem = {("stencil_kernel", "f"): lib.bf_stencil_smem_bytes(
                16, 32, 2, 5, 0),
            ("stencil_kernel", "d"): lib.bf_stencil_smem_bytes(
                16, 32, 2, 5, 1),
            ("fht_kernel", "0"): 4 * 1024 * 8,
            ("fht_kernel", "1"): 6 * 256 * 8,
            # K8's passes: 4096 points a block, Re and Im
            ("fht_pass", ""): 2 * 4096 * 8,
            # K9 at the bench (500 grid points, 64 radii): the inversion's
            # 8 doubles and 2 flags a radius, the grid's logs, each curve's
            # 3 doubles and a flag a grid point
            ("table_rows_kernel", ""): (8 * 64 + 500 + 2 * 3 * 500) * 8
            + 2 * 64 + 2 * 500}
    sources = ("stencil.cu", "sht.cu", "fftlog.cu", "disc_paint.cu",
               "grid_deposit.cu", "snapshot.cu", "tile_deposit.cu",
               "regrid.cu", "curves.cu", "table_rows.cu",
               "stencil_finish.cu", "grid_cutout.cu", "cell_list.cu")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc()] + flags + ["-Xptxas", "-v", "-c",
                                        str(_build._CSRC / src), "-o",
                                        os.path.join(tmp, src + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources]
        outs = [p.communicate()[0] for p in procs]
    names = "|".join(threads)
    for p, text in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text}")
        key, spill = None, 0
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the kernel's name, then its template arguments: types
                # (f, d), a dimension (Li3E) or a flag (Lb1E)
                m = re.search(r"'\w*?\d+(" + names + r")"
                              r"(?:I([fd]*)((?:Li\d+E)*)(?:Lb([01])E)?E)?",
                              line)
                key = m.group(1) if m else None
                types, ints, flag = (m.groups()[1:] if m
                                     else (None, None, None))
                # the int arguments: (dimension) or (mode, dimension)
                ints = re.findall(r"Li(\d+)E", ints or "")
                dim = ints[-1] if ints else None
                mode = ints[0] if len(ints) == 2 else None
                if key == "tile_pairs_kernel" and dim is None:
                    key = None      # K15's pair kernel (grid_cutout.cu)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if not (m and key):
                continue
            regs = int(m.group(1))
            st = re.search(r"(\d+) bytes smem", line)
            sm = smem.get((key, flag or (types or "")[-1:]), 0) + (
                int(st.group(1)) if st else 0)
            n_threads = threads[key]
            if key == "grid_direct_kernel" and dim == "2":
                n_threads = 256
            if key == "tile_pairs_kernel":
                n_threads, dyn = tile_pairs_shape(
                    int(dim), 4 if types == "f" else 8)
                sm += dyn
            warps = n_threads // 32
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(SM_REGS // (per_warp * warps), SM_WARPS // warps,
                         SM_BLOCKS, SM_SMEM // (sm + 1024) if sm
                         else SM_BLOCKS)
            args = ["float" if c == "f" else "double" for c in types or ""]
            if key in ("fht_kernel", "fht_coeff"):
                args = ["Bluestein" if flag == "1" else "power of two"]
            elif key == "tile_pairs_kernel":
                args += [("K4", "K10", "K12")[int(dim)]]
            elif key == "cell_query_kernel":
                args += [f"{dim}D", "write" if flag == "1" else "count"]
            else:
                args += [("displace", "paint", "anis")[int(mode)]] \
                    if mode else []
                args += [f"{dim}D"] if dim else []
            name = f"{key}<{', '.join(args)}>" if args else key
            log(f"  ptxas: {name}: {regs} registers, {spill} bytes spilled, "
                f"{sm} bytes of shared memory; {n_threads} threads a "
                f"block: {blocks} blocks, {blocks * warps} warps an SM")
            key = None


# -- the last modules: validation, the correlation hook, the halo
# model, meshes and the parallel front-ends, FITS shells ------------------
PARITY = os.path.join(HERE, "PARITY.json")
MESH_SHARDS = 4         # halo_mesh(4, device="cuda"): four shards of one card
PAR_SHELLS = 4          # SimpleParallel's shells
MESH_CALLS = 3          # timed calls of each runner with and without a mesh
# the hook's table is an interpolation (40 z x 500 ln r, linear in z over
# steps of 0.15 of D^2(z), 0 outside 1e-3-300 Mpc): a build with it differs
# from the direct correlation_3d build by ~1e-3 of max |d| (a CPU build of
# the small grid: 9.7e-4)
HOOK_BOUND = 2e-3


def timed(torch, fn):
    """(result, host-clock seconds of ``fn()`` with the card synchronized
    before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def require(launches, kernels, label):
    missing = [k for k in kernels if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}: {launches}")


def parity_row(gpu, label, got, ref):
    log(f"[{gpu}] {label}: torch ratio {got['ratio']:.4f} (resid "
        f"{got['resid']:+.4f}), PARITY.json's JAX row {ref['ratio']:.4f} "
        f"(resid {ref['resid']:+.4f}), torch - JAX "
        f"{got['ratio'] - ref['ratio']:+.4f}; Fig. 2 {got['fig2']:.4f}")


def validation_paths(bf, torch, gpu):
    """The S19 validation pipelines of utils/validation.py at full width on
    the card, each with the launch counts set to 0 just before and read
    just after, every row printed beside PARITY.json's (the JAX package's,
    written on a CPU by tools/parity.py) and held to the JAX tests' bounds:
    limber_shell_run at NSIDE 256 and 512 (tests/test_deltacl.py:80-127:
    |resid| < 0.07, |lo_band - 1| < 0.03, the NSIDE 512 k = 1.4 row under
    0.0381), deltapk_s19_residuals on the 256^3 s19_box
    (tests/test_deltapk_golden.py:46-59: |resid| < 0.07, the Mc4e14 ratio
    at k = 3 below the Mc1e14 one by more than 0.02), and
    tiled_vs_scatter_residual(64, 300) under 0.02
    (tests/test_tiled_deposit.py:53-63). Returns the launches by path."""
    from baryonforge_torch.ops import _build
    from baryonforge_torch.utils import validation as V
    with open(PARITY) as f:
        ref = json.load(f)
    launches = {}
    for key, nside in (("deltacl_limber", 256),
                       ("deltacl_limber_nside512", 512)):
        ph = {}
        _build.reset_launches()
        res, sec = timed(torch, lambda: V.limber_shell_run(
            nside=nside, device=DEVICE, timings=ph))
        lk = dict(_build.launches)
        launches[f"limber{nside}"] = lk
        require(lk, ("collapse_curves", "tile_paint", "flat_view", "fht",
                     "table_rows", "tile_deposit", "stencil_hot", "stencil",
                     "stencil_complement", "ring_modes", "legendre_alm"),
                f"limber_shell_run(nside={nside})")
        j = ref[key]
        log(f"[{gpu}] limber_shell_run(nside={nside}): {sec * 1e3:.1f} ms "
            f"wall; phases (ms, host clock, synchronized): " + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in ph.items())
            + f"; n_halos {res['meta']['n_halos']} (PARITY.json "
            f"{j['meta']['n_halos']}), chi_bar {res['meta']['chi_bar']}, "
            f"lmax {res['meta']['lmax']}; launches {lk}")
        log(f"[{gpu}] limber NSIDE {nside} lo_band (ell 2-20): torch "
            f"{res['lo_band']:.4f}, JAX {j['lo_band']:.4f}")
        if not abs(res["lo_band"] - 1) < 0.03:
            raise AssertionError(f"limber NSIDE {nside}: lo_band {res}")
        for got, want in zip(res["rows"], j["rows"]):
            parity_row(gpu, f"limber NSIDE {nside} k={got['k_h']} "
                       f"(ell {got['ell']})", got, want)
            if not abs(got["resid"]) < 0.07:
                raise AssertionError(f"limber NSIDE {nside}: {got}")
        if nside == 512:
            r14 = next(r for r in res["rows"] if r["k_h"] == 1.4)
            if not abs(r14["resid"]) < 0.0381:
                raise AssertionError(f"limber NSIDE 512 k=1.4: {r14}")

    ph = {}
    _build.reset_launches()
    box, t_box = timed(torch, lambda: V.s19_box(device=DEVICE))
    rows, t_pk = timed(torch, lambda: V.deltapk_s19_residuals(
        box=box, device=DEVICE, timings=ph))
    lk = dict(_build.launches)
    launches["deltapk"] = lk
    require(lk, ("collapse_curves", "grid_cutout", "tile_pairs",
                 "grid_deposit", "fht", "table_rows"),
            "deltapk_s19_residuals")
    log(f"[{gpu}] s19_box (256^3, {len(box[0].cat)} halos): "
        f"{t_box * 1e3:.1f} ms; deltapk_s19_residuals: {t_pk * 1e3:.1f} ms "
        "(per M_c, ms: " + "; ".join(
            f"{k} " + ", ".join(f"{v * 1e3:.1f}" for v in vs)
            for k, vs in ph.items()) + f"); launches {lk}")
    got = {}
    for row, want in zip(rows, ref["deltapk_s19"]["rows"]):
        parity_row(gpu, f"deltaPk {row['curve']} k={row['k_h']}", row, want)
        got[(row["curve"], row["k_h"])] = row["ratio"]
        if not abs(row["resid"]) < 0.07:
            raise AssertionError(f"deltaPk: {row}")
    if not got[("Mc4e14", 3.0)] < got[("Mc1e14", 3.0)] - 0.02:
        raise AssertionError(f"deltaPk: no deepening with M_c: {got}")

    _build.reset_launches()
    res, sec = timed(torch, lambda: V.tiled_vs_scatter_residual(
        64, 300, device=DEVICE))
    lk = dict(_build.launches)
    launches["tiled_vs_scatter"] = lk
    require(lk, ("collapse_curves", "tile_deposit", "flat_view", "regrid",
                 "disc_deposit"), "tiled_vs_scatter_residual")
    j = ref["tiled_vs_scatter"]["max_rel_residual"]
    log(f"[{gpu}] tiled_vs_scatter_residual(64, 300): torch "
        f"{res['max_rel_residual']:.3e}, PARITY.json (JAX) {j:.3e}, "
        f"{sec * 1e3:.1f} ms")
    if not res["max_rel_residual"] < 0.02:
        raise AssertionError(f"tiled vs scatter: {res}")
    return launches


def correlation_hook(bf, torch, gpu, card_model):
    """TabulatedCorrelation3D at its defaults (40 z x 500 r) built on the
    card (K8 once a redshift) and on the CPU, held to 1e-9 of max |xi|
    (table and readout); then the S19 bench table built on the card with it
    as the xi_mm hook, against the card's build without it within
    HOOK_BOUND of max |d|. Returns the launches."""
    from baryonforge_torch.ops import _build
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    _build.reset_launches()
    tc, t_card = timed(torch, lambda: bf.utils.TabulatedCorrelation3D(
        cosmo, device=DEVICE))
    lk = dict(_build.launches)
    if lk.get("fht", 0) != 40:
        raise AssertionError(f"TabulatedCorrelation3D: {lk}")
    t0 = time.perf_counter()
    tc_cpu = bf.utils.TabulatedCorrelation3D(cosmo, device="cpu")
    t_cpu = time.perf_counter() - t0
    scale = float(tc_cpu._tab.abs().max())
    check("TabulatedCorrelation3D, card vs CPU table, / max |xi|",
          float((tc._tab.cpu() - tc_cpu._tab).abs().max()) / scale, 1e-9)
    r = np.geomspace(5e-4, 500, 3001)
    for a in (1.0, 0.55, 1 / 1.9):
        got = tc(torch.as_tensor(r, device=DEVICE), a)
        if got.device.type != "cuda":
            raise AssertionError("TabulatedCorrelation3D: readout off the "
                                 "card")
        check(f"TabulatedCorrelation3D readout a={a:.3f}, card vs CPU, / "
              "max |xi|", float((got.cpu() - tc_cpu(torch.as_tensor(r), a))
                                .abs().max()) / scale, 1e-9)
    log(f"[{gpu}] TabulatedCorrelation3D (40 x 500): card {t_card * 1e3:.1f}"
        f" ms ({lk['fht']} K8 launches), CPU {t_cpu * 1e3:.1f} ms")
    hooked = bf.Baryonification2D(
        bf.Profiles.DarkMatterOnly(**BPAR, proj_cutoff=100, xi_mm=tc),
        bf.Profiles.DarkMatterBaryon(**BPAR, proj_cutoff=100, xi_mm=tc),
        cosmo, epsilon_max=EPS_MAX, device=DEVICE)
    _build.reset_launches()
    _, t_b = timed(torch, lambda: hooked.setup_interpolator(**BENCH_GRID))
    lh = dict(_build.launches)
    d0 = np.asarray(card_model.raw_input_d)
    d1 = np.asarray(hooked.raw_input_d)
    if not np.isfinite(d1).all():
        raise AssertionError("hooked table: not finite")
    err = float(np.abs(d1 - d0).max()) / float(np.abs(d0).max())
    log(f"[{gpu}] S19 bench table with the xi_mm hook: {t_b * 1e3:.1f} ms, "
        f"launches {lh} (no K8 for xi: the hook)")
    check("S19 bench table, hook vs correlation_3d, / max |d|", err,
          HOOK_BOUND)
    return sum_launches(lk, lh)


def halomodel_check(bf, torch, gpu):
    """halomodel_power (Sheth-Tormen, the S19 DarkMatter profile,
    Mdelta_to_Mtot, nM 64, 16 k) on the card against the CPU, 1e-9
    relative. Returns the launches."""
    from baryonforge_torch.ops import _build
    from baryonforge_torch.utils import halomodel as hm
    cosmo = bf.cosmo.cosmology_from_dict(COSMO)
    k = np.geomspace(1e-3, 10, 16)
    out = {}
    for dev in (DEVICE, "cpu"):
        dm = bf.Profiles.DarkMatter(**BPAR)
        hmc = hm.FlexibleHMCalculator(
            mass_function=hm.MassFuncShethTormen(device=dev),
            halo_bias=hm.HaloBiasShethTormen(device=dev),
            halo_m_to_mtot=bf.Profiles.misc.Mdelta_to_Mtot(dm),
            log10M_min=10, log10M_max=16, nM=64, device=dev)
        _build.reset_launches()
        out[dev] = timed(torch, lambda: hm.halomodel_power(cosmo, k, 1.0, dm,
                                                           hmc))
        out[dev] += (dict(_build.launches),)
    card, t_card, lk = out[DEVICE]
    cpu, t_cpu, _ = out["cpu"]
    require(lk, ("fht",), "halomodel_power")
    check("halomodel_power, card vs CPU, relative",
          float(((card.cpu() - cpu) / cpu).abs().max()), 1e-9)
    log(f"[{gpu}] halomodel_power (nM 64, 16 k): card {t_card * 1e3:.1f} ms "
        f"(launches {lk}), CPU {t_cpu * 1e3:.1f} ms")
    return lk


def time_calls(torch, runner, calls=MESH_CALLS):
    """One warm and ``calls`` timed ``process()`` calls: (last output,
    median ms, the phases of the last call)."""
    runner.process()
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.process()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(walls)), runner.timings


def mesh_pair(bf, torch, gpu, make, label, compare, required):
    """``make(mesh)`` without and with halo_mesh(MESH_SHARDS, "cuda"), both
    timed, the launch counts set to 0 just before the sharded calls and
    read just after; ``compare(single, sharded)`` checks. Returns the
    sharded run's launches."""
    from baryonforge_torch.ops import _build
    mesh = bf.parallel.halo_mesh(MESH_SHARDS, device=DEVICE)
    single, ms1, ph1 = time_calls(torch, make(None))
    _build.reset_launches()
    sharded, ms4, ph4 = time_calls(torch, make(mesh))
    lk = dict(_build.launches)
    require(lk, required, label)
    compare(single, sharded)
    fmt = (lambda p: ", ".join(f"{k} {v:.2f}" for k, v in p.items()))
    log(f"[{gpu}] {label}: no mesh {ms1:.1f} ms ({fmt(ph1)}), "
        f"{MESH_SHARDS} shards of one card {ms4:.1f} ms ({fmt(ph4)}), "
        f"median of {MESH_CALLS}; launches {lk}")
    return lk


def near(name, got, want, atol, rtol=0.0):
    err = float(np.max(np.abs(got - want) - rtol * np.abs(want)))
    check(name, max(err, 0.0), atol)


def mesh_paths(bf, torch, gpu, model, tsz_card, cat, shell, grid_b3,
               snap_inputs):
    """The runners' mesh= and the parallel front-ends at the bench
    configuration: BaryonifyShell (tiled and scatter, the runner's default
    dtypes) with halo_mesh(4, "cuda") against no mesh, within 1e-4 of the
    largest move (tests/test_multichip.py:66-69; the card's atomics make
    even two unsharded scatter runs differ in the float32 offsets' last
    bits, so the CPU tests hold the scatter shell's 1e-12); the scatter
    tSZ paint through SplitJoinParallel at rtol 1e-12 / atol 1e-15
    (:128-129), the tiled one sharded at 1e-5 of its largest value (float32
    sums); the anisotropic paint (tiled and scatter, float64) at 1e-10
    (:92-94); BaryonifyGrid on the 3D ΔP(k) map within 1e-5 of its largest
    move; the snapshot bench to 2e-5 in position (tests/test_snapshot.py:
    84-88); SimpleParallel of PAR_SHELLS bench shells against the same in
    sequence at 1e-12 (:108-111), both timed. Returns the launches."""
    from baryonforge_torch.ops import _build
    launches = []
    for kw, label, req in (
            (dict(), "tiled", ("collapse_curves", "tile_deposit",
                               "stencil", "stencil_complement")),
            (dict(deposit="scatter", regrid="scatter"), "scatter",
             ("collapse_curves", "disc_deposit", "regrid"))):
        def make(mesh, kw=kw):
            return bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                     model=model, mesh=mesh, device=DEVICE,
                                     **kw)

        def compare(a, b, label=label):
            scale = float(np.abs(a - shell.map).max())
            near(f"BaryonifyShell {label}, {MESH_SHARDS} shards vs none, "
                 f"/ max move", b / scale, a / scale, 1e-4)
            if not np.isclose(b.sum(), shell.map.sum(), rtol=1e-8):
                raise AssertionError(f"sharded {label} shell lost mass")
        launches.append(mesh_pair(bf, torch, gpu, make,
                                  f"BaryonifyShell {label}", compare, req))

    paint = bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS,
                                  model=tsz_card, deposit="scatter",
                                  device=DEVICE)
    single = paint.process()
    _build.reset_launches()
    split, t_split = timed(torch, bf.parallel.SplitJoinParallel(
        paint, mesh=bf.parallel.halo_mesh(MESH_SHARDS, DEVICE)).process)
    lk = dict(_build.launches)
    require(lk, ("collapse_curves", "disc_paint"), "SplitJoinParallel paint")
    near("SplitJoinParallel scatter tSZ paint vs the runner", split, single,
         1e-15, rtol=1e-12)
    log(f"[{gpu}] SplitJoinParallel scatter tSZ paint: {t_split * 1e3:.1f} "
        f"ms; launches {lk}")
    launches.append(lk)

    def make_paint(mesh):
        return bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS,
                                     model=tsz_card, mesh=mesh, device=DEVICE)

    def compare_paint(a, b):
        near("tiled tSZ paint, 4 shards vs none, / max", b / a.max(),
             a / a.max(), 1e-5)
    launches.append(mesh_pair(bf, torch, gpu, make_paint, "tiled tSZ paint",
                              compare_paint,
                              ("collapse_curves", "tile_paint", "flat_view")))

    sh = anis_shell(bf, shell)
    for deposit, req in (("auto", ("tile_paint", "tile_paint2",
                                   "anis_finish")),
                         ("scatter", ("disc_paint", "disc_paint_anis",
                                      "anis_finish"))):
        def make_anis(mesh, deposit=deposit):
            return bf.PaintProfilesAnisShell(
                cat, sh, epsilon_max=PAINT_EPS, model=tsz_card,
                Tracer_model=tsz_card, Mtot_model=tsz_card,
                background_val=ANIS_BG, global_tracer_fraction=ANIS_FRAC,
                dtype=torch.float64, deposit=deposit, mesh=mesh,
                device=DEVICE)

        def compare_anis(a, b, deposit=deposit):
            near(f"Anis shell {deposit}, float64, 4 shards vs none, / max",
                 b / np.abs(a).max(), a / np.abs(a).max(), 1e-10, 1e-10)
        launches.append(mesh_pair(bf, torch, gpu, make_anis,
                                  f"Anis shell {deposit}, float64",
                                  compare_anis, req))

    gcat, gm, b3 = grid_b3

    def make_grid(mesh):
        return bf.BaryonifyGrid(gcat, gm, epsilon_max=GRID_BARYON_EPS,
                                model=b3, mesh=mesh, device=DEVICE)

    def compare_grid(a, b):
        scale = float(np.abs(a - gm.map).max())
        near("BaryonifyGrid 256^3, 4 shards vs none, / max move", b / scale,
             a / scale, 1e-5)
    launches.append(mesh_pair(bf, torch, gpu, make_grid, "BaryonifyGrid 3D",
                              compare_grid, ("collapse_curves",
                                             "grid_cutout", "grid_deposit")))

    smodel, scat, snap = snap_inputs

    def make_snap(mesh):
        return bf.BaryonifySnapshot(scat, snap, epsilon_max=20, model=smodel,
                                    mesh=mesh, device=DEVICE)

    def compare_snap(a, b):
        for c in "xyz":
            dx = np.asarray(b[c]) - np.asarray(a[c])
            dx = np.where(dx > snap.L / 2, dx - snap.L, dx)
            dx = np.where(dx < -snap.L / 2, dx + snap.L, dx)
            near(f"BaryonifySnapshot {c}, 4 shards vs none", dx, 0 * dx,
                 2e-5)
    launches.append(mesh_pair(bf, torch, gpu, make_snap, "snapshot bench",
                              compare_snap, ("collapse_curves",
                                             "snapshot_displace")))

    rng = np.random.default_rng(SEED + 16)
    shells = [bf.utils.LightconeShell(map=rng.exponential(1.0, shell.map.size),
                                      cosmo=COSMO) for _ in range(PAR_SHELLS)]

    def runners():
        return [bf.BaryonifyShell(cat, s, epsilon_max=EPS_MAX, model=model,
                                  device=DEVICE) for s in shells]
    for r in runners():
        r.process()                         # the per-NSIDE state warm
    seq_r, par_r = runners(), runners()
    seq, t_seq = timed(torch, lambda: [r.process() for r in seq_r])
    _build.reset_launches()
    par, t_par = timed(torch, bf.parallel.SimpleParallel(par_r).process)
    lk = dict(_build.launches)
    require(lk, ("collapse_curves", "tile_deposit", "stencil",
                 "stencil_complement"), "SimpleParallel")
    for i, (a, b) in enumerate(zip(par, seq)):
        near(f"SimpleParallel shell {i} vs the sequential run", a, b, 1e-12,
             rtol=1e-12)
    log(f"[{gpu}] {PAR_SHELLS} bench shells (tiled engine, first calls of "
        f"new runners): in sequence {t_seq * 1e3:.1f} ms, SimpleParallel "
        f"({PAR_SHELLS} threads, a stream each) {t_par * 1e3:.1f} ms; "
        f"launches {lk}")
    launches.append(lk)
    return sum_launches(*launches)


def fits_shell(bf, torch, gpu, model, cat, shell):
    """The bench shell written as FITS (>f8 and >f4) and read back through
    LightconeShell(path=...): >f8 bitwise, >f4 to 2e-7; the >f8 shell
    baryonified (tiled engine) equal to the run from the array (1e-12).
    Returns the launches."""
    import tempfile
    from baryonforge_torch.ops import _build
    with tempfile.TemporaryDirectory() as tmp:
        p8, p4 = (os.path.join(tmp, f"shell_{d}.fits") for d in ("f8", "f4"))
        bf.utils.write_healpix_fits(p8, shell.map, dtype=">f8")
        bf.utils.write_healpix_fits(p4, shell.map, dtype=">f4")
        s8 = bf.utils.LightconeShell(path=p8, cosmo=COSMO)
        s4 = bf.utils.LightconeShell(path=p4, cosmo=COSMO)
    if not np.array_equal(s8.map, shell.map) or s8.NSIDE != NSIDE:
        raise AssertionError("FITS >f8 shell does not read back bitwise")
    near("FITS >f4 shell, relative", s4.map / shell.map, 1.0, 2e-7)
    ref = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                            device=DEVICE).process()
    _build.reset_launches()
    out, sec = timed(torch, bf.BaryonifyShell(
        cat, s8, epsilon_max=EPS_MAX, model=model, device=DEVICE).process)
    lk = dict(_build.launches)
    require(lk, ("collapse_curves", "tile_deposit"), "FITS shell")
    near("FITS shell baryonified vs the array's", out, ref, 1e-12, 1e-12)
    log(f"[{gpu}] FITS shell (NSIDE {NSIDE}) baryonified: {sec * 1e3:.1f} "
        f"ms; launches {lk}")
    return lk



# the direct readout (models without halo_curves): each runner with the
# bench's model behind HideCurves, DIRECT_CALLS timed calls after one warm
DIRECT_CALLS = 2
DIRECT_EDGE = 1e-12     # relative reach of an eps_max edge that two R roundings may flip


class HideCurves:
    """A model's readout surface alone, as tests/test_runners_extra.py:
    201-208 wraps one: a runner given it takes the direct readout (K20-K23)
    instead of the curves (K1)."""

    def __init__(self, m):
        self._m = m

    def displacement(self, *a, **k):
        return self._m.displacement(*a, **k)

    def projected(self, *a, **k):
        return self._m.projected(*a, **k)

    def real(self, *a, **k):
        return self._m.real(*a, **k)


def on_card(model, torch, dt):
    """``model`` with its tables in ``dt`` on the card, behind HideCurves."""
    return HideCurves(model.with_dtype(dt, device=DEVICE))


def direct_vs_curve(torch, label, make, scale_of):
    """One float64 call of the curve path and one of the direct path
    (``make(direct)`` builds the runner), held to 1e-9 of ``scale_of``
    (the curve map's largest value or move); returns the direct map."""
    curve = make(False).process()
    direct = make(True).process()
    scale = float(scale_of(curve))
    if not scale > 0:
        raise AssertionError(f"{label}: the curve path did nothing")
    check(f"{label}: direct vs curve path, float64, card",
          float(np.abs(direct - curve).max()), 1e-9 * scale)
    return direct


def edge_members(bf, torch, runner, mode, eps, Rcom):
    """The (halo, pixel) rows of ``runner``'s direct readout whose r lies
    within DIRECT_EDGE (relative) of eps Rcom: the members that the curve
    path's host R and the model's card R may cut differently."""
    from baryonforge_torch.ops.deposit import disc_radii
    hd = runner._host_halo_data(bf.cosmo.cosmology_from_dict(COSMO))
    rows, _ = disc_radii(runner.LightconeShell.NSIDE,
                         runner._direct_halos(hd), mode, torch.float64)
    live = rows["pix"] >= 0
    edge = eps * torch.as_tensor(Rcom(hd), device=DEVICE)[
        rows["hid"][live].long()]
    return int(((rows["r"][live] / edge - 1).abs() < DIRECT_EDGE).sum())


def k20_r_cause(torch, halos, rows, lay, ref):
    """Where K20's float64 r parts from its plain version's, at the bench:
    each member's plain r is formed again from its ring's colatitude, once
    as torch forms it (ops/healpix.ring_theta, the plain walk's: the plain
    r bit for bit) and once as the device forms it (csrc/healpix.cuh:
    ring_theta, read from the ring table that K3's first launch fills, the
    function K20's walk calls). Returns (max |kernel r - plain r|, max
    |kernel r - plain r on the device's colatitudes|, max |plain r - plain
    r formed again|, rings whose two colatitudes differ, their largest gap
    in radians and in ulps, the largest |d r / d theta_r| bound D / a over
    the members of those rings). Discs of fewer than 4 members (the
    fallback's rows, which K20 forms in float64 from pix2ang) are left
    out."""
    from baryonforge_torch.ops import healpix as hpx, regrid
    f64 = torch.float64
    n = hpx.npix(NSIDE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    po = torch.randn((n, 2), generator=gen, device=DEVICE,
                     dtype=f64) * (0.5 / NSIDE)
    orig = torch.ones(n, dtype=f64, device=DEVICE)
    scratch = regrid._scratch(NSIDE, f64, DEVICE)
    regrid._launch(NSIDE, po, orig, scratch, torch.empty_like(orig))
    torch.cuda.synchronize()
    th_dev = scratch[:4 * NSIDE * 4 * 8].view(f64).view(4 * NSIDE, 4)[:, 0]
    ring_ids = torch.arange(1, 4 * NSIDE, dtype=torch.int32, device=DEVICE)
    th_torch = torch.zeros_like(th_dev)
    th_torch[1:] = hpx.ring_theta(NSIDE, ring_ids, f64)
    gap = (th_dev[1:] - th_torch[1:]).abs()
    ulp = torch.nextafter(th_torch[1:], torch.full_like(gap, 4.0)) \
        - th_torch[1:]
    differ = gap > 0
    counts = torch.as_tensor(lay.counts, device=DEVICE)
    live = rows["pix"] >= 0
    live &= (counts >= 4)[rows["hid"].long()]
    pix, h = rows["pix"][live], rows["hid"][live].long()
    ring = hpx.pixel_ring(NSIDE, pix)
    sp, nr, _, shifted = hpx.ring_info(NSIDE, ring, f64)
    dphi = hpx.ring_dphi(nr)
    th0, ph0 = halos["theta"][h], halos["phi"][h]
    dphi_pix = ((pix - sp) + 0.5 * shifted) * dphi - ph0
    sdp = torch.sin(0.5 * dphi_pix)
    D_a = halos["D"][h], halos["a"][h]

    def r_on(theta):
        t = theta[ring.long()]
        sdt = torch.sin(0.5 * (t - th0))
        hav = sdt * sdt + torch.sin(t) * torch.sin(th0) * (sdp * sdp)
        return 2.0 * torch.sqrt(torch.clamp(hav, 0.0, 1.0)) * D_a[0] / D_a[1]
    r_k, r_p = rows["r"][live], ref["r"][live]
    again = float((r_on(th_torch) - r_p).abs().max())
    err = float((r_k - r_p).abs().max())
    err_dev = float((r_k - r_on(th_dev)).abs().max())
    on_gap = differ[(ring - 1).long()]
    slope = float((D_a[0] / D_a[1])[on_gap].max()) if on_gap.any() else 0.0
    return (err, err_dev, again, int(differ.sum()), float(gap.max()),
            float((gap / ulp).max()), slope)


def k20_layout_check(lay, want, rows):
    """K20's layout, formed on the card, equal to the host layout ``want``
    (row_layout's) bit for bit, and every pad slot of its rows written as
    the fills it replaces left it (pixel -1, halo, r and geometry 0)."""
    got = lay.numpy()
    same = (np.array_equal(got.counts, want.counts)
            and np.array_equal(got.base, want.base)
            and got.n_slots == want.n_slots
            and len(got.groups) == len(want.groups)
            and all(K == K0 and s0 == s00 and np.array_equal(h, h0)
                    for (h, K, s0), (h0, K0, s00) in zip(got.groups,
                                                         want.groups)))
    if not same:
        raise AssertionError("K20: its layout is not row_layout's")
    live = rows["pix"] >= 0
    pads = [rows[k][~live] for k in ("hid", "r", "geo")
            if rows[k] is not None]
    if int(live.sum()) != int(got.counts.sum()) \
            or any(bool((p != 0).any()) for p in pads):
        raise AssertionError("K20: a pad slot not written as a pad")
    log(f"  K20 layout: row_layout's bit for bit ({len(got.groups)} groups, "
        f"{got.n_slots} slots); {int((~live).sum())} pad slots written")


def direct_kernel_rows(bf, torch, gpu, halos, mode_rows, grid_part,
                       snap_part):
    """K20-K23 against their plain versions on the card at the bench
    shapes, timed beside them; returns their kernel rows."""
    from baryonforge_torch.ops import deposit, direct, paint, snapshot
    from baryonforge_torch.ops import healpix as hpx
    measured = {}
    f32, f64 = torch.float32, torch.float64
    # K20 at the bench shell, displacement mode, float32 (and float64 for
    # the error: the rows' integers equal, r as k20_r_cause explains it)
    rows, lay = deposit.disc_radii(NSIDE, halos, "displace", f64)
    ref, lref = deposit.disc_radii_plain(NSIDE, halos, "displace", f64)
    if not (np.array_equal(lay.numpy().counts, lref.counts)
            and torch.equal(rows["pix"], ref["pix"])):
        raise AssertionError("K20: rows differ from the plain version's")
    k20_layout_check(lay, lref, rows)
    # r: its residual against the plain version's is held to what the two
    # ring colatitudes' gap explains (k20_r_cause)
    err, err_dev, again, n_gap, gap, gap_ulp, slope = k20_r_cause(
        torch, halos, rows, lay, ref)
    log(f"  K20 float64 r: {n_gap} of {4 * NSIDE - 1} ring colatitudes "
        f"differ between the device's ring_theta and torch's, by at most "
        f"{gap:.3e} rad ({gap_ulp:.2f} ulp); plain r formed again differs "
        f"from the plain version's by {again:.3e}")
    if again != 0:
        raise AssertionError("K20: the plain r formed again is not the "
                             "plain version's")
    r_ulp = 2.2e-16 * float(ref["r"].abs().max())
    check(f"K20 disc_radii [bench, displace, float64, {lay.n_radii} members"
          "] r against the plain r on the device's ring colatitudes, "
          "bitwise", err_dev, 0.0)
    check(f"K20 disc_radii [bench, displace, float64, {lay.n_radii} members"
          "] r (the colatitude gap times D / a, plus 4 ulp)", err,
          gap * slope + 4 * r_ulp)
    rows, lay = deposit.disc_radii(NSIDE, halos, "displace", f32)
    ref, lref = deposit.disc_radii_plain(NSIDE, halos, "displace", f32)
    k20_layout_check(lay, direct.row_layout(lay.numpy().counts), rows)
    flips = int(np.abs(lay.numpy().counts - lref.counts).sum())
    check("K20 disc_radii [bench, displace, float32] members flipped on a "
          "disc's edge (the device's sinf)", flips, 1e-3 * lref.n_radii)
    ms = time_ms(torch, lambda: deposit.disc_radii(NSIDE, halos, "displace",
                                                   f32), 10)
    plain_ms = time_ms(torch, lambda: deposit.disc_radii_plain(
        NSIDE, halos, "displace", f32), 2)
    n_slots = lay.n_slots
    # bytes: 5 float64 halo columns read, 24 bytes a slot written (pixel,
    # halo, r, 3 geometry values in float32) and the layout's three int64
    # arrays a halo (counts, bases, the ids in class order) written once;
    # operations: ~30 float32 a candidate (members / 0.78, the disc's share
    # of its walk's square-ish rings) and 3 float64 transcendentals a ring
    nb = nbytes(halos) + 24 * n_slots + 24 * len(lay.counts)
    b = bound(nb, 30 * lay.n_radii / 0.78, F32_FLOPS)
    log(f"[{gpu}] K20 disc_radii at the bench ({lay.n_radii} members in "
        f"{len(lay.groups)} groups, {n_slots} slots, "
        f"{100 * lay.padded_share:.1f}% padding): kernel {ms:.4f} ms (three "
        f"launches, the layout formed on the card, one copy of its "
        f"{direct.CLASSES} class counts to the host), plain {plain_ms:.3f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]})")
    measured["disc_radii"] = (err, ms, plain_ms, b[0], b[1], None)
    # K21 on those rows and the readout's values, float32 offsets
    vals = mode_rows(rows, lay)
    got = paint.disc_apply("displace", NSIDE, rows, vals, halos)
    want = paint.disc_apply_plain("displace", NSIDE, rows, vals, halos)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check("K21 disc_apply [bench, displace, float32]", err, 1e-5 * scale)
    ms = time_ms(torch, lambda: paint.disc_apply("displace", NSIDE, rows,
                                                 vals, halos), 10)
    plain_ms = time_ms(torch, lambda: paint.disc_apply_plain(
        "displace", NSIDE, rows, vals, halos), 3)
    live = rows["pix"] >= 0
    pl = rows["pix"][live].long()
    delta = torch.randn((int(live.sum()), 2), device=DEVICE, dtype=f32)
    # a partial yardstick: the tangent offsets formed beforehand, summed by
    # one index_add_ (the amplitude and geometry of each slot left out)
    library_ms = time_ms(torch, lambda: torch.zeros(
        (hpx.npix(NSIDE), 2), device=DEVICE, dtype=f32).index_add_(
            0, pl, delta), 10)
    # bytes: a member slot's pixel, halo, geometry and float64 value read
    # (28), a pad slot's pixel (4), a read, the offsets written once
    n_live = int(live.sum())
    nb = 28 * n_live + 4 * (n_slots - n_live) + 8 * halos["a"].numel() \
        + got.numel() * got.element_size()
    b = bound(nb, 10 * lay.n_radii, F32_FLOPS)
    log(f"[{gpu}] K21 disc_apply at the bench ({n_slots} slots): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ {library_ms:.4f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]})")
    measured["disc_apply"] = (err, ms, plain_ms, b[0], b[1], library_ms)
    measured["grid_direct"] = k22_group(torch, gpu, grid_part)
    # K23 at the snapshot bench
    coords, hpos, halos_s, offsets, parts, layout, dlay, L, sdt = snap_part
    # the records: each entry's slot and halo, as the parent formed them
    # on every call (the row's base plus the pair's place, in
    # particle_major_pairs' order; halos[prow])
    counts = (offsets[1:] - offsets[:-1]).long()
    row = torch.repeat_interleave(torch.arange(counts.numel(),
                                               device=DEVICE), counts)
    pslot = torch.as_tensor(dlay.rows.base, device=DEVICE)[row] \
        + torch.arange(row.numel(), device=DEVICE) - offsets.long()[row]
    pm = snapshot.particle_major_pairs(parts, layout[0])
    if not (torch.equal(dlay.rec[:, 0].long(), pslot[pm]) and torch.equal(
            dlay.rec[:, 1], halos_s[layout[2].long()])):
        raise AssertionError("K23 records: not the parent's slots and halos")
    # the layout's positions: each pair's particle's, in K17's order
    if not torch.equal(dlay.coords[dlay.parts.long()], coords[parts.long()]):
        raise AssertionError("K23 layout: not the pairs' positions")
    order_poff = layout[:2]
    svals = torch.randn(dlay.rows.n_slots, device=DEVICE, dtype=sdt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rr = snapshot.snapshot_radii(hpos, halos_s, offsets, dlay, L)
        got = snapshot.snapshot_direct(hpos, order_poff, dlay, svals, L)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rr0 = snapshot.snapshot_radii_plain(hpos, halos_s, offsets, dlay, L)
    if not torch.equal(rr, rr0):
        raise AssertionError("K23 snapshot_radii: not its plain version's")
    want = snapshot.snapshot_direct_plain(hpos, order_poff, dlay, svals, L)
    if not torch.equal(got, want):
        raise AssertionError("K23 snapshot_direct: not its plain version's")
    err = 0.0
    log(f"  K23 at the snapshot bench ({parts.numel()} pairs, "
        f"{dlay.rows.n_slots} slots, {100 * dlay.rows.padded_share:.1f}% "
        f"padding, {dlay.pieces.shape[0]} radii pieces): records the "
        "parent's, radii and gather bitwise their plain versions, neither "
        "synchronizing with the host")
    ms_r = time_ms(torch, lambda: snapshot.snapshot_radii(
        hpos, halos_s, offsets, dlay, L), 10)
    ms_g = time_ms(torch, lambda: snapshot.snapshot_direct(
        hpos, order_poff, dlay, svals, L), 10)
    plain_ms = time_ms(torch, lambda: snapshot.snapshot_radii_plain(
        hpos, halos_s, offsets, dlay, L), 2) + time_ms(
        torch, lambda: snapshot.snapshot_direct_plain(
            hpos, order_poff, dlay, svals, L), 2)
    pl = parts.long()
    vec = torch.randn((3, pl.numel()), device=DEVICE, dtype=svals.dtype)
    library_ms = time_ms(torch, lambda: torch.zeros_like(got).index_add_(
        1, pl, vec), 10)
    n_pairs = parts.numel()
    out_b = got.numel() * got.element_size()
    # bytes, the function's own work: positions and halo positions read
    # once, per pair its particle (radii) and its value (gather) read, r
    # written once, the offsets written once; operations: ~14 float64 a
    # pair, twice. The parent's count (beside) also took the layout, the
    # halos and offsets, and per pair its row, its slot twice and its value
    nb = nbytes(coords, hpos) + n_pairs * (4 + svals.element_size()) \
        + 8 * dlay.rows.n_slots + out_b
    nb_old = nbytes(coords, hpos, halos_s, layout, offsets) + n_pairs * (
        4 + 4 + 8 + 8 + 8 + svals.element_size()) + out_b
    b = bound(nb, 28 * n_pairs, F64_FLOPS)
    b_old = bound(nb_old, 28 * n_pairs, F64_FLOPS)
    log(f"[{gpu}] K23 at the snapshot bench: radii {ms_r:.4f} ms, gather "
        f"{ms_g:.4f} ms, plain {plain_ms:.3f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; {nb} bytes; "
        f"the parent's count {b_old[0]:.4f} ms, {nb_old} bytes)")
    measured["snapshot_direct"] = (err, ms_r + ms_g, plain_ms, b[0], b[1],
                                   library_ms)
    return measured


def k22_group(torch, gpu, grid_part):
    """K22 on ``grid_part``, (npix, Ns, res, halos, values, halos a readout
    chunk): the 3D baryonify's first apply group of its largest size
    bucket as the runner cuts it and reads the model on it. The radii
    bitwise their plain version's, the apply against its plain version and
    bitwise the applies of the group's readout chunks in turn; both timed
    on the group, and on its first chunk for the log. Returns its
    kernel-row figures (err, ms, plain_ms, bound_ms, bound_by, None)."""
    from baryonforge_torch.ops import grid
    npix, Ns, res, part, gvals, chunk = grid_part
    m, cells = part["cen"].shape[0], Ns ** 3
    r = grid.grid_radii(npix, Ns, res, part)
    if not torch.equal(r, grid.grid_radii_plain(npix, Ns, res, part)):
        raise AssertionError("K22 grid_radii: not its plain version's")
    del r
    acc0 = torch.zeros((3, npix ** 3), dtype=gvals.dtype, device=DEVICE)
    got = grid.grid_direct("displace", npix, Ns, res, part, gvals,
                           acc0.clone())
    want = grid.grid_direct_plain("displace", npix, Ns, res, part, gvals,
                                  acc0.clone())
    err = float((got - want).abs().max())
    check(f"K22 grid_direct [3D {npix}^3, {m} halos x {Ns}^3 cells, "
          "displace, float32] (the plain version's index_add_ sums in "
          "another order)", err, 1e-5 * float(want.abs().max()))
    del want

    def rows_of(a, b):
        return ({k: None if v is None else v[a:b] for k, v in part.items()},
                gvals[a * cells:b * cells])
    # one apply over the group equals the applies of its readout chunks in
    # turn, bit for bit (each tile adds its halos in ascending order)
    acc = acc0.clone()
    for a in range(0, m, chunk):
        grid.grid_direct("displace", npix, Ns, res, *rows_of(a, a + chunk),
                         acc)
    if not torch.equal(acc, got):
        raise AssertionError("K22 grid_direct: one apply differs from its "
                             "chunks' applies in turn")
    log(f"  K22 grid_direct: one apply bitwise the {-(-m // chunk)} applies "
        "of its readout chunks in turn")
    del acc, got
    ms_r = time_ms(torch, lambda: grid.grid_radii(npix, Ns, res, part), 5)
    ms_a = time_ms(torch, lambda: grid.grid_direct(
        "displace", npix, Ns, res, part, gvals, acc0), 5)
    plain_ms = time_ms(torch, lambda: grid.grid_direct_plain(
        "displace", npix, Ns, res, part, gvals,
        torch.zeros_like(acc0)), 1) + time_ms(
        torch, lambda: grid.grid_radii_plain(npix, Ns, res, part), 1)
    # bytes: r written (8 a cell), the values read (4 a cell), and
    # k22_apply_bytes (the map's touched tiles read and written once);
    # operations: ~20 float64 a cell
    nb_a, touched = k22_apply_bytes(torch, npix, Ns, res, part,
                                    2 * 3 * acc0.element_size())
    b = bound(12 * m * cells + nb_a, 20 * m * cells, F64_FLOPS)
    log(f"[{gpu}] K22 at the 3D baryonify's first apply group ({m} halos x "
        f"{Ns}^3 = {m * cells} cutout cells, {touched} of "
        f"{npix ** 3 // grid.TILE[3] ** 3} tiles touched): radii {ms_r:.4f} ms, apply {ms_a:.4f} ms (with "
        f"its lists), plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]})")
    row = (err, ms_r + ms_a, plain_ms, b[0], b[1], None)
    # the group's first readout chunk alone, for the per-chunk figure
    cpart, cvals = rows_of(0, chunk)
    mc = cpart["cen"].shape[0]
    ms_r = time_ms(torch, lambda: grid.grid_radii(npix, Ns, res, cpart), 5)
    ms_a = time_ms(torch, lambda: grid.grid_direct(
        "displace", npix, Ns, res, cpart, cvals, acc0), 5)
    nb_a, touched = k22_apply_bytes(torch, npix, Ns, res, cpart,
                                    2 * 3 * acc0.element_size())
    b = bound(12 * mc * cells + nb_a, 20 * mc * cells, F64_FLOPS)
    log(f"[{gpu}] K22 at the group's first readout chunk ({mc} halos, "
        f"{touched} tiles touched): radii {ms_r:.4f} ms, apply {ms_a:.4f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]})")
    return row


def k22_apply_bytes(torch, npix, Ns, res, grp, cell_bytes):
    """The bytes one K22 apply over the halos ``grp`` (cutouts of Ns^d
    cells) moves besides the radii and values: the halo columns and K15's
    lists read, and ``cell_bytes`` a cell of every tile that the lists
    touch (the map read and written once, the Anis grid's Mtot and input
    map read). Returns (bytes, touched tiles)."""
    from baryonforge_torch.ops import grid
    ndim = grp["cen"].shape[1]
    start, tile_halo = grid.cutout_tiles(npix, Ns, res, grp)
    touched = int(grid.touched_tiles(start)[1][0])
    return (nbytes(grp, start, tile_halo)
            + touched * grid.TILE[ndim] ** ndim * cell_bytes, touched)


def k22_per_call(torch, gpu, grid_runs):
    """K22 as a runner call spends it: for each (label, runner, value bytes
    a cell, K22 applies a call as the runs launched it) of ``grid_runs``
    (its calls' phases in PHASES), the median of the radii + apply phases
    (CUDA events) beside the call's K22 bound: r written (8 bytes a cutout
    cell), the values read once, each apply's k22_apply_bytes, ~20
    float64 operations a cell. The applies are the runner's groups
    (Map2DRunner.direct_groups); fails if the runs launched another
    number. Returns {label: (ms, bound_ms, bound_by)}."""
    from baryonforge_torch.utils.trace import PhaseClock
    from baryonforge_torch.Runners.Map2DRunner import direct_groups
    out = {}
    for label, runner, vbytes, applies in grid_runs:
        phases = PHASES[label]
        ms = float(np.median([p["radii"] + p["apply"] for p in phases]))
        gm = runner.GriddedMap
        inp = runner._cutout_inputs(PhaseClock(torch.device(DEVICE)))
        ndim = 2 if gm.is2D else 3
        cell_b = {"displace": 2 * ndim * (4 if runner.dtype == torch.float32
                                          else 8),
                  "paint": 2 * 8, "anis": 2 * 8 + 2 * 8}[inp["mode"]]
        cells = groups = touched = nb = 0
        for idx, Ns in runner._buckets(inp["Nsize"]):
            ix = torch.as_tensor(idx, device=DEVICE)
            for gs in direct_groups(idx.size, Ns ** ndim)[1]:
                grp = {k: None if v is None else v[ix[gs]]
                       for k, v in inp["halos"].items()}
                b_g, t_g = k22_apply_bytes(torch, gm.Npix, Ns, gm.res, grp,
                                           cell_b)
                nb, touched, groups = nb + b_g, touched + t_g, groups + 1
            cells += idx.size * Ns ** ndim
        if groups != applies:
            raise AssertionError(f"{label}: {applies} K22 applies a call, "
                                 f"the runner's groups {groups}")
        b = bound(nb + cells * (8 + vbytes), 20 * cells, F64_FLOPS)
        log(f"[{gpu}] K22 a call of {label}: radii + apply {ms:.3f} ms "
            f"(median of {len(phases)} calls; {cells} cutout cells, "
            f"{groups} applies, {touched} tiles touched in all), bound "
            f"{b[0]:.4f} ms ({b[1]})")
        out[label] = (ms, b[0], b[1])
    return out


def direct_paths(bf, torch, gpu, model, tsz, cat, shell, tabs, snap_inputs):
    """The direct readout of every runner at full width, each given its
    model behind HideCurves: the bench shell (scatter: K20, K21, K3), the
    tSZ paint at epsilon_max 5 (K20, K21), the anisotropic scatter shell
    of tools/anis_bench.py:76-93 (K20, K21, K14; Mtot through its curves),
    the 3D ΔP(k) BaryonifyGrid and its DMO paint at 256^3 and the 2D
    anisotropic grid at 2048^2 (K22, then K16 or K14), and the snapshot
    bench (K23). Each is held in float64 against its curve path to 1e-9 of
    the largest value (of the largest move for a baryonification), and
    driven in the runner's default dtype (one warm call, DIRECT_CALLS
    timed, the launch counts set to 0 just before and read just after);
    then K20-K23 against their plain versions. Returns (launches, kernel
    rows)."""
    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    runs = []
    calls = dict(warm=1, calls=DIRECT_CALLS)

    def kw_shell(direct, dt=f64):
        m = on_card(model, torch, dt) if direct else model
        return dict(epsilon_max=EPS_MAX, model=m, deposit="scatter",
                    regrid="scatter", dtype=dt, regrid_dtype=dt,
                    device=DEVICE)
    log(f"direct readout: the bench shell (NSIDE {NSIDE}, {N_HALOS} halos),"
        " the S19 table behind HideCurves")
    r64 = bf.BaryonifyShell(cat, shell, **kw_shell(True))
    n_edge = edge_members(bf, torch, r64, "displace", EPS_MAX,
                          lambda hd: hd["R"] / hd["a"])
    log(f"  members within {DIRECT_EDGE:g} of eps_max Rcom: {n_edge}")
    direct_vs_curve(torch, "BaryonifyShell", lambda d: bf.BaryonifyShell(
        cat, shell, **kw_shell(d)), lambda m: np.abs(m - shell.map).max())
    _, lk = drive_path(bf, torch, bf.BaryonifyShell(cat, shell, **kw_shell(
        True, f32)), ("disc_radii", "disc_apply", "regrid"),
        "direct BaryonifyShell (float32)", gpu, N_HALOS,
        check_map=moved(shell.map), **calls)
    runs.append(lk)

    def kw_paint(direct, dt=f64):
        m = on_card(tsz, torch, dt) if direct else tsz
        return dict(epsilon_max=PAINT_EPS, model=m, deposit="scatter",
                    dtype=dt, device=DEVICE)
    direct_vs_curve(torch, "PaintProfilesShell (tSZ)",
                    lambda d: bf.PaintProfilesShell(cat, shell,
                                                    **kw_paint(d)),
                    lambda m: np.abs(m).max())
    _, lk = drive_path(bf, torch, bf.PaintProfilesShell(
        cat, shell, **kw_paint(True, f32)), ("disc_radii", "disc_apply"),
        "direct PaintProfilesShell (tSZ, float32)", gpu, N_HALOS,
        check_map=painted(shell.map.shape), **calls)
    runs.append(lk)

    sh = anis_shell(bf, shell)

    def kw_anis(direct, dt=f64):
        m = on_card(tsz, torch, f64) if direct else tsz
        return dict(epsilon_max=PAINT_EPS, model=m, Tracer_model=m,
                    Mtot_model=tsz, background_val=ANIS_BG,
                    global_tracer_fraction=ANIS_FRAC, deposit="scatter",
                    dtype=dt, device=DEVICE)
    direct_vs_curve(torch, "PaintProfilesAnisShell",
                    lambda d: bf.PaintProfilesAnisShell(cat, sh,
                                                        **kw_anis(d)),
                    lambda m: np.abs(m).max())
    _, lk = drive_path(bf, torch, bf.PaintProfilesAnisShell(
        cat, sh, **kw_anis(True, f32)), ("disc_radii", "disc_apply",
                                         "anis_finish"),
        "direct PaintProfilesAnisShell (float32)", gpu, N_HALOS,
        check_map=painted(sh.map.shape), **calls)
    runs.append(lk)

    log(f"direct readout: the ΔP(k) grids (3D {GRID3D_N}^3, 2D "
        f"{GRID2D_N}^2, {GRID_HALOS} halos)")
    cat3, gm0 = grid_inputs(bf, 3, GRID3D_N)
    dmo3 = tabs["dmo3"]

    def grid_run(cls, c, gm, m, direct, dt=f64, **kw):
        return cls(c, gm, model=on_card(m, torch, f64) if direct else m,
                   dtype=dt, device=DEVICE, **kw)
    dmo = direct_vs_curve(torch, "PaintProfilesGrid 3D", lambda d: grid_run(
        bf.PaintProfilesGrid, cat3, gm0, dmo3, d,
        epsilon_max=GRID_PAINT_EPS), lambda m: np.abs(m).max())
    gm3 = grid_map(bf, dmo + dmo.mean() * 0.1)
    direct_vs_curve(torch, "BaryonifyGrid 3D", lambda d: grid_run(
        bf.BaryonifyGrid, cat3, gm3, tabs["b3"], d,
        epsilon_max=GRID_BARYON_EPS), lambda m: np.abs(m - gm3.map).max())
    rb = grid_run(bf.BaryonifyGrid, cat3, gm3, tabs["b3"], True, f32,
                  epsilon_max=GRID_BARYON_EPS)
    _, lk = drive_path(bf, torch, rb, ("grid_radii", "grid_direct",
                                       "grid_deposit"),
                       "direct BaryonifyGrid 3D (float32)", gpu, GRID_HALOS,
                       check_map=moved(gm3.map), **calls)
    runs.append(lk)
    rp = grid_run(bf.PaintProfilesGrid, cat3, gm0, dmo3, True, f32,
                  epsilon_max=GRID_PAINT_EPS)
    _, lk = drive_path(bf, torch, rp, ("grid_radii", "grid_direct"),
                       "direct PaintProfilesGrid 3D (float32)", gpu,
                       GRID_HALOS, check_map=painted(gm0.map.shape), **calls)
    runs.append(lk)
    cat2, gm2 = grid_inputs(bf, 2, GRID2D_N)
    dmo2 = tabs["dmo2"]
    paint2 = bf.PaintProfilesGrid(cat2, gm2, epsilon_max=GRID_PAINT_EPS,
                                  model=dmo2, device=DEVICE).process()
    gm2 = grid_map(bf, paint2 + paint2.mean() * 0.1)

    def anis_grid(d, dt=f64):
        m = on_card(dmo2, torch, f64) if d else dmo2
        return bf.PaintProfilesAnisGrid(
            cat2, gm2, epsilon_max=GRID_ANIS_EPS, model=m, Tracer_model=m,
            Mtot_model=dmo2, background_val=ANIS_BG,
            global_tracer_fraction=ANIS_FRAC, dtype=dt, device=DEVICE)
    direct_vs_curve(torch, "PaintProfilesAnisGrid 2D", anis_grid,
                    lambda m: np.abs(m).max())
    ra = anis_grid(True, f32)
    _, lk = drive_path(bf, torch, ra,
                       ("grid_radii", "grid_direct", "anis_finish"),
                       "direct PaintProfilesAnisGrid 2D (float32)", gpu,
                       GRID_HALOS, check_map=painted(gm2.map.shape), **calls)
    runs.append(lk)
    # (label, runner, value bytes a cell, K22 applies a call): K22 a call
    # (k22_per_call)
    n_calls = calls["warm"] + calls["calls"]
    grid_runs = [(label, run, vb, runs[k]["grid_direct"] / n_calls)
                 for k, label, run, vb in (
                     (-3, "direct BaryonifyGrid 3D (float32)", rb, 4),
                     (-2, "direct PaintProfilesGrid 3D (float32)", rp, 8),
                     (-1, "direct PaintProfilesAnisGrid 2D (float32)", ra,
                      16))]

    snap_model, scat, snap = snap_inputs
    log(f"direct readout: the snapshot bench ({SNAP_PARTS} particles, "
        f"{SNAP_HALOS} halos)")

    def snap_run(d, dt=f64):
        m = on_card(snap_model, torch, f64) if d else snap_model
        return bf.BaryonifySnapshot(scat, snap, epsilon_max=20, model=m,
                                    dtype=dt, device=DEVICE, verbose=False)
    curve = moves(snap_run(False).process(), snap)
    rs = snap_run(True)
    got = moves(rs.process(), snap)
    check("BaryonifySnapshot: direct vs curve path, float64, card",
          float(np.abs(got - curve).max()), 1e-9 * float(np.abs(curve).max()))
    rs32 = snap_run(True, f32)
    from baryonforge_torch.ops import _build
    _build.reset_launches()
    walls = []
    for _ in range(1 + DIRECT_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rs32.process()
        walls.append(time.perf_counter() - t0)
    lk = dict(_build.launches)
    require(lk, ("snapshot_radii", "snapshot_direct"), "direct snapshot")
    if not all(np.isfinite(out[c]).all() for c in "xyz"):
        raise AssertionError("direct snapshot: output not finite")
    log(f"[{gpu}] direct BaryonifySnapshot (float32): calls "
        + ", ".join(f"{w * 1e3:.1f}" for w in walls) + " ms (the first "
        "builds the pairs and K23's layout); last phases (ms, CUDA "
        "events): " + ", ".join(f"{k} {v:.3f}"
                                for k, v in rs32.timings.items())
        + f"; K23 a call (radii + apply) "
        f"{rs32.timings['radii'] + rs32.timings['apply']:.3f} ms")
    runs.append(lk)
    launches = sum_launches(*runs)
    require(launches, ("disc_radii", "disc_apply", "grid_radii",
                       "grid_direct", "snapshot_radii", "snapshot_direct"),
            "the direct readout's paths")

    # K20-K23 at the bench shapes, on the runners' own inputs
    from baryonforge_torch.ops import direct as _direct, grid
    from baryonforge_torch.utils.trace import PhaseClock
    rd = bf.BaryonifyShell(cat, shell, **kw_shell(True, f32))
    halos = rd._direct_halos(rd._host_halo_data(
        bf.cosmo.cosmology_from_dict(COSMO)))
    m32 = model.with_dtype(f32, device=DEVICE)

    def mode_rows(rows, lay):
        return _direct.readout(lambda r, M, a: m32.displacement(r, M, a),
                               rows["r"], lay, {"M": halos["M"],
                                                "a": halos["a"]}, f64)
    # K22 on the 3D baryonify's first apply group of its largest size
    # bucket: its halos, the readout's values on them and the halos a
    # readout chunk, as Map2DRunner._direct_groups makes them
    from baryonforge_torch.Runners.Map2DRunner import direct_groups
    inp = rb._cutout_inputs(PhaseClock(torch.device(DEVICE)))
    idx, Ns = rb._buckets(inp["Nsize"])[-1]
    ix = torch.as_tensor(idx, device=DEVICE)
    part, (gvals,) = next(rb._direct_groups(
        inp, ix, Ns, {k: None if v is None else v[ix]
                      for k, v in inp["halos"].items()},
        torch.device(DEVICE)))
    chunk = direct_groups(idx.size, Ns ** 3)[0]
    _, _, _, R_q, hpos, _ = rs32._host_prep()
    (halos_s, offsets, parts), layout = rs32._neighbour_pairs(hpos, R_q)
    snap_part = (rs32._coords_dev, torch.as_tensor(hpos, device=DEVICE),
                 halos_s, offsets, parts, layout, rs32._direct_layout(),
                 snap.L, f32)
    measured = direct_kernel_rows(bf, torch, gpu, halos, mode_rows,
                                  (GRID3D_N, Ns, gm3.res, part, gvals,
                                   chunk),
                                  snap_part)
    k22_per_call(torch, gpu, grid_runs)
    log(f"[{gpu}] direct readout phase: {time.perf_counter() - t_phase:.1f}"
        " s")
    return launches, measured


# -- the last gaps to the JAX package: a five-key ParamTabulatedProfile
# paint (K1's wide kernel), the public grid deposits (K16's list entry) and
# FFTLog rows past shared memory (K8) ---------------------------------------
# five parameters of the bench's Schneider19 gas profile, two or three
# values each; each halo draws its own from the seed, over each axis
# widened by P5_REACH of its span a side, so some fall off an axis (fill 0)
P5_KEYS = {"theta_ej": (3.0, 4.0, 5.0), "theta_co": (0.05, 0.1),
           "M_c": (5e13 / H, 2e14 / H), "mu_beta": (0.3, 0.5),
           "delta": (6.0, 8.0)}
P5_REACH = 0.02
P5_SMALL = dict(BENCH_GRID, N_samples_z=1, N_samples_Mass=3, N_samples_R=16)
DEPOSIT_CALLS = 10


def p5_table(bf, device, grid):
    """The five-key ParamTabulatedProfile of the bench's gas profile,
    built on ``device`` over ``grid``."""
    tab = bf.utils.ParamTabulatedProfile(
        bf.Profiles.Gas(**BPAR, proj_cutoff=100),
        bf.cosmo.cosmology_from_dict(COSMO), device=device)
    return tab.setup_interpolator(
        other_params={k: np.array(v) for k, v in P5_KEYS.items()}, **grid)


def p5_inputs(bf, nside, n_halos, seed):
    """bench_inputs' catalog and map with the five per-halo columns (from
    seed + 1), and which halos lie off an axis."""
    cat, shell = bench_inputs(bf, nside, n_halos, seed)
    rng = np.random.default_rng(seed + 1)
    cols = {k: np.asarray(cat.cat[k], dtype=float)
            for k in ("ra", "dec", "M", "z")}
    off = np.zeros(n_halos, dtype=bool)
    for k, v in P5_KEYS.items():
        lo, hi = min(v), max(v)
        cols[k] = rng.uniform(lo - P5_REACH * (hi - lo),
                              hi + P5_REACH * (hi - lo), n_halos)
        off |= (cols[k] < lo) | (cols[k] > hi)
    return (bf.utils.HaloLightConeCatalog(**cols, cosmo=COSMO), shell,
            cols, off)


def p5_paint(bf, torch, gpu):
    """The paint shell with five per-halo properties: the table built on
    the card (timed, its shape logged; a small one card vs CPU to 1e-9),
    K1 as the runner calls it on the bench's columns (the halos off an axis
    rows of 0), the tiled (K1, K10, K7) and disc (K1, K11) paints at the
    bench configuration through drive(), their agreement, and the paint
    card vs CPU in float64 on a small catalog. Returns (the two paths'
    launches, summed; the kernels line's row of K1's wide kernel: that
    call's error against the plain version, its time from host columns,
    the plain version's, its bound, no library call)."""
    from baryonforge_torch.ops import _build, interp
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab = p5_table(bf, DEVICE, BENCH_GRID)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    shape = tuple(tab._tab2D.shape)
    log(f"[{gpu}] five-key table ParamTabulatedProfile(Gas(bench bpar, "
        f"proj_cutoff=100)) over {list(P5_KEYS)} built on the card: shape "
        f"{shape} ({tab._tab2D.numel()} values a table), "
        f"{build_s:.2f} s, launches {dict(_build.launches)}")
    for name in ("_tab2D", "_tab3D"):
        t = getattr(tab, name)
        if not (torch.isfinite(t).all() and (t != 0).any()):
            raise AssertionError(f"five-key table {name} not finite")
    small_g = p5_table(bf, DEVICE, P5_SMALL)
    small_c = p5_table(bf, "cpu", P5_SMALL)
    for name in ("_tab2D", "_tab3D"):
        g, c = getattr(small_g, name), getattr(small_c, name)
        check(f"five-key table {name} {tuple(c.shape)}, card vs CPU",
              (g.cpu() - c).abs().max().item(), 1e-9 * c.abs().max().item())

    cat, shell, cols, off = p5_inputs(bf, NSIDE, N_HALOS, SEED)
    log(f"  five-key catalog: {int(off.sum())} of {N_HALOS} halos off an "
        "axis (fill 0)")
    m32 = tab.with_dtype(torch.float32, device=DEVICE)
    hd = bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS, model=tab,
                               device=DEVICE)._host_halo_data(
        bf.cosmo.cosmology_from_dict(COSMO))
    pk = {k: cols[k] for k in P5_KEYS}
    _build.reset_launches()
    ck = m32.halo_curves(hd["M"], hd["a"], **pk)[0]
    if dict(_build.launches) != {"collapse_curves_wide": 1}:
        raise AssertionError(f"five-key curves: {dict(_build.launches)}")
    p_args = (m32._tab2D, m32._axes, 2, hd["M"], hd["a"], list(P5_KEYS), pk)
    cp = interp.collapse_curves_plain(*p_args)[0]
    torch.cuda.synchronize()
    offk = torch.as_tensor(off, device=ck.device)
    if not ((ck[offk] == 0).all() and (ck[~offk] != 0).any(1).all()):
        raise AssertionError("five-key curves: the halos off an axis are "
                             "not the fill")
    err = (ck - cp).abs().max().item()
    check("K1 collapse_curves_wide, five-key table, bench columns "
          "[float32]", err, 1e-6 * cp.abs().max().item())
    ms = time_ms(torch, lambda: m32.halo_curves(hd["M"], hd["a"], **pk), 20)
    plain_ms = time_ms(torch, lambda: interp.collapse_curves_plain(*p_args),
                       3)
    dev_cols = {k: torch.as_tensor(v, device=DEVICE)
                for k, v in dict(pk, M=hd["M"], a=hd["a"]).items()}
    alone = graph_ms(torch, lambda: m32.halo_curves(**dev_cols))
    # the table, the axes and the curves once, seven float64 host columns;
    # per output value a multiply and an add a corner
    bnd = bound(nbytes(m32._tab2D, m32._axes, ck) + 8 * N_HALOS *
                (2 + len(P5_KEYS)), 2 * ck.numel() * 2 ** (2 + len(P5_KEYS)),
                F32_FLOPS)
    log(f"[{gpu}] K1's wide kernel on the five-key table as the paint "
        f"runner calls it (host columns, {N_HALOS} halos, "
        f"{ck.shape[1]} radii, 128 corners): {ms:.4f} ms; the device alone "
        f"(columns on the card) {alone:.4f} ms; plain {plain_ms:.3f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")

    kw = dict(epsilon_max=PAINT_EPS, model=tab, device=DEVICE)
    out_t, l_t = drive(bf, torch, bf.PaintProfilesShell(cat, shell, **kw),
                       ("collapse_curves_wide", "tile_paint", "flat_view"),
                       "five-key tiled paint", gpu, paint=True)
    out_s, l_s = drive(bf, torch, bf.PaintProfilesShell(
        cat, shell, deposit="scatter", **kw), ("collapse_curves_wide",
                                               "disc_paint"),
        "five-key scatter paint", gpu, paint=True)
    paint_bound_check("five-key paint: tiled vs scatter, per pixel", out_t,
                      out_s)
    cat_s, shell_s, _, _ = p5_inputs(bf, 64, 400, SEED)
    paint_card_vs_cpu(bf, torch, tab, cat_s, shell_s, 60,
                      "five-key, NSIDE 64")
    launches = {k: l_t.get(k, 0) + l_s.get(k, 0)
                for k in set(l_t) | set(l_s)}
    return launches, (err, ms, plain_ms) + bnd + (None,)


def public_deposits(bf, torch, gpu):
    """ops.scatter.deposit_3d of 256^3 sources onto a 256^3 grid and
    deposit_2d of 2048^2 onto 2048^2, float32 and float64, positions from a
    seed in [-N/4, 5N/4) (a tenth exact integers), on a random grid: the
    four calls with the launch counts set to 0 just before and read just
    after (K16's list entry, no other kernel), each against its plain
    version on the card (float64 to 1e-12 of the largest value, float32 to
    1e-5; the mass added the values' sum), timed beside it and, 3D float64
    (the kernels line's row), beside one torch.index_add of the 8 corner
    shares formed beforehand, untimed. Returns (launches, the row)."""
    from baryonforge_torch.ops import _build, scatter
    dev = torch.device(DEVICE)
    cases = []
    for ndim, N in ((3, GRID3D_N), (2, GRID2D_N)):
        g = torch.Generator(device=dev).manual_seed(SEED + ndim)
        M = N ** ndim
        pos = (torch.rand((M, ndim), dtype=torch.float64, device=dev,
                          generator=g) * 1.5 - 0.25) * N
        pos[::10] = torch.floor(pos[::10])
        vals = 2 * torch.rand(M, dtype=torch.float64, device=dev,
                              generator=g)
        grid = torch.rand((N,) * ndim, dtype=torch.float64, device=dev,
                          generator=g)
        for dt in (torch.float32, torch.float64):
            cases.append((ndim, N, dt, grid.to(dt), pos.to(dt), vals.to(dt)))
        del pos, vals, grid
    fns = {2: (scatter.deposit_2d, scatter.deposit_2d_plain),
           3: (scatter.deposit_3d, scatter.deposit_3d_plain)}
    _build.reset_launches()
    outs = [fns[c[0]][0](*c[3:]) for c in cases]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    if launches != {"deposit_list": len(cases)}:
        raise AssertionError(f"the public deposits launched {launches}")
    row = None
    for (ndim, N, dt, grid, pos, vals), ok in zip(cases, outs):
        tag = f"{ndim}D, {N}^{ndim} sources and cells, " + \
            str(dt).replace("torch.", "")
        fn, plain = fns[ndim]
        op = plain(grid, pos, vals)
        torch.cuda.synchronize()
        err = (ok - op).abs().max().item()
        rel = 1e-12 if dt == torch.float64 else 1e-5
        check(f"deposit_list [{tag}]", err, rel * op.abs().max().item())
        added = (ok.double().sum() - grid.double().sum()).item()
        check(f"deposit_list mass [{tag}]",
              abs(added / vals.double().sum().item() - 1), 10 * rel)
        ms = time_ms(torch, lambda: fn(grid, pos, vals), DEPOSIT_CALLS)
        plain_ms = time_ms(torch, lambda: plain(grid, pos, vals), 3)
        # positions and values read once, the grid read and the new one
        # written; ~15 operations an axis and one a corner
        bnd = bound(nbytes(grid, pos, vals, grid), (15 * ndim + 2 ** ndim)
                    * vals.numel(), F32_FLOPS if dt == torch.float32
                    else F64_FLOPS)
        line = (f"[{gpu}] deposit_{ndim}d [{tag}]: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if ndim == 3 and dt == torch.float64:
            idx, share = deposit_shares(torch, pos, vals, N, ndim)
            flat = grid.reshape(-1)
            check(f"deposit_list library yardstick [{tag}]",
                  (torch.index_add(flat, 0, idx, share).reshape(grid.shape)
                   - op).abs().max().item(), rel * op.abs().max().item())
            lib_ms = time_ms(torch, lambda: torch.index_add(flat, 0, idx,
                                                            share), 3)
            del idx, share
            line += f", library {lib_ms:.4f} ms (index_add of the shares)"
            row = (err, ms, plain_ms) + bnd + (lib_ms,)
        log(line)
    return launches, row


def deposit_shares(torch, pos, vals, N, ndim):
    """The 2^d corner shares of each source (flat cell, value), as the
    plain deposits form them: the library call's input."""
    from baryonforge_torch.ops.scatter import _corner_weights_1d
    cw = [_corner_weights_1d(pos[:, d], N) for d in range(ndim)]
    idx, share = [], []
    for corner in range(2 ** ndim):
        g, v = 0, vals
        for d in range(ndim):
            a = (corner >> (ndim - 1 - d)) & 1
            g = g * N + cw[d][a]
            v = v * cw[d][2 + a]
        idx.append(g)
        share.append(v)
    return torch.cat(idx), torch.cat(share)


def sm_count(torch):
    """The card's SM count (K8's plan takes it)."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def fht_route(plan):
    """K8's route in words, from ops.fftlog.fht_plan."""
    how = ("shared memory" if plan.in_shared else
           f"{len(plan.passes)} passes {plan.passes}" if plan.passes else
           "one block a row on device memory")
    return (f"{'Bluestein' if plan.bluestein else 'power of two'}, M = "
            f"{plan.M}, {how}")


def long_fht(bf, torch, gpu):
    """fht past shared memory on the card, mu 0.5, q -0.5, B rows of N
    points: 1 x 16,384 and 20 x 16,384, 200 x 8192 (one block a row), 1 x
    2^22 and Bluestein N = 2^20 + 1 (M = 2^22), 1 x 2^28 and Bluestein N =
    2^27 - 1 (M = 2^28). Each with the launch counts set to 0 just before
    and read just after (they must be the plan's, ops.fftlog.fht_launches),
    against fht_plain on the card to 1e-11 of the row's largest value,
    timed beside fht_plain and the partial library call (torch.fft.fft of
    the biased rows, the product with the coefficients formed beforehand,
    torch.fft.fft again), with its bound (the row's own formula:
    compare_table_kernels' fht_case); at 2^22 K8 no slower than fht_plain.
    Returns the launches and the rows [B, N, plan, err, ms, plain_ms,
    bound_ms, bound_by, library_ms]."""
    from baryonforge_torch.ops import _build, fftlog
    dev = torch.device(DEVICE)
    smem, sms = fftlog.shared_memory_optin(dev), sm_count(torch)
    launches, rows = {}, []
    for B, N, reps in ((1, 16384, 20), (20, 16384, 20), (200, 8192, 10),
                       (1, 1 << 22, 5), (1, (1 << 20) + 1, 5),
                       (1, 1 << 28, 1), (1, (1 << 27) - 1, 1)):
        x = torch.as_tensor(np.geomspace(1e-4, 1e4, N), device=dev)
        a = (torch.exp(-x[None] * torch.linspace(
            0.5, 2.0, B, dtype=torch.float64, device=dev)[:, None])
            * x ** 0.5).contiguous()
        plan = fftlog.fht_plan(N, smem, B, sms)
        _build.reset_launches()
        k, ok = fftlog.fht(x, a, 0.5, -0.5)
        torch.cuda.synchronize()
        for name, n in _build.launches.items():
            launches[name] = launches.get(name, 0) + n
        want = fftlog.fht_launches(plan, B, B)
        if _build.launches["fht"] != want:
            raise AssertionError(f"fht {B} x {N}: {dict(_build.launches)}, "
                                 f"the plan {want}")
        del k
        lx, ln_kcrc = fftlog._fht_grids(x, 1.0)
        op = fftlog.fht_plain(a, lx, 0.5, -0.5, ln_kcrc)
        torch.cuda.synchronize()
        rel = ((ok - op).abs() / op.abs().amax(-1, keepdim=True)).max().item()
        label = f"{B} x {N} ({fht_route(plan)})"
        check(f"K8 fht, {label}, relative to the row's largest value", rel,
              1e-11)
        ops = (B * (5.0 * N * math.log2(N) + 8.0 * N) + 40.0 * N
               + 450.0 * (N // 2 + 1))
        bnd = bound(nbytes(a, lx, op), ops, F64_FLOPS)
        del ok, op
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: fftlog.fht(x, a, 0.5, -0.5), reps)
        plain_ms = time_ms(torch, lambda: fftlog.fht_plain(
            a, lx, 0.5, -0.5, ln_kcrc), reps)
        dln = (lx[-1] - lx[0]) / (N - 1)
        u = fftlog._u_coefficients(N, dln, 0.5, -0.5,
                                   ln_kcrc - lx[-1] + lx[0], dev) / N
        b = (a * torch.exp(0.5 * (lx - lx[0]))).to(torch.float64)
        lib_ms = time_ms(torch, lambda: torch.fft.fft(
            torch.fft.fft(b) * u).real, reps)
        del u, b
        torch.cuda.empty_cache()
        log(f"[{gpu}] K8 fht {label}: kernel {ms:.4f} ms, {want} launches; "
            f"plain {plain_ms:.4f} ms; library (torch.fft.fft twice, "
            f"partial) {lib_ms:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})")
        if N in (1 << 22, (1 << 20) + 1) and ms > plain_ms:
            raise AssertionError(f"K8 fht {label}: {ms:.4f} ms, slower "
                                 f"than fht_plain's {plain_ms:.4f} ms")
        rows.append([B, N, plan, rel, ms, plain_ms, bnd[0], bnd[1], lib_ms])
        del x, a, lx
        torch.cuda.empty_cache()
    return launches, rows


KERNELS = [
    # name, entry points, source, TPU kernel replaced, its main path (the
    # kernels line names every path that launched it, the main one first)
    ("collapse_curves", ("collapse_curves",),
     "baryonforge_torch/csrc/curves.cu",
     "baryonforge_tpu/ops/interp.py:252", "tiled"),
    # K1 past four parameter axes (a ParamTabulatedProfile of five p_keys)
    ("collapse_curves_wide", ("collapse_curves_wide",),
     "baryonforge_torch/csrc/curves.cu",
     "baryonforge_tpu/ops/interp.py:252", "p5_paint"),
    ("disc_deposit", ("disc_deposit",), "baryonforge_torch/csrc/deposit.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:849", "scatter"),
    ("regrid", ("regrid",), "baryonforge_torch/csrc/regrid.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:1346", "scatter"),
    ("tile_deposit", ("tile_deposit",),
     "baryonforge_torch/csrc/tile_deposit.cu",
     "baryonforge_tpu/ops/tiles.py:775", "tiled"),
    ("stencil", ("stencil_hot", "stencil"),
     "baryonforge_torch/csrc/stencil.cu",
     "baryonforge_tpu/ops/tiles.py:1387", "tiled"),
    ("stencil_finish", ("stencil_geo", "stencil_complement"),
     "baryonforge_torch/csrc/stencil_finish.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:1208", "tiled"),
    ("tile_layout", ("tile_view", "flat_view"),
     "baryonforge_torch/csrc/tile_layout.cu",
     "baryonforge_tpu/ops/tiles.py:425", "tiled"),
    ("fht", ("fht",), "baryonforge_torch/csrc/fftlog.cu",
     "baryonforge_tpu/ops/fftlog.py:194", "table"),
    ("table_rows", ("table_rows",),
     "baryonforge_torch/csrc/table_rows.cu",
     "baryonforge_tpu/Profiles/BaryonCorrection.py:62", "table"),
    ("tile_paint", ("tile_paint",), "baryonforge_torch/csrc/tile_deposit.cu",
     "baryonforge_tpu/ops/tiles.py:775", "paint"),
    ("disc_paint", ("disc_paint",), "baryonforge_torch/csrc/disc_paint.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:1948", "paint"),
    ("tile_paint2", ("tile_paint2",),
     "baryonforge_torch/csrc/tile_deposit.cu",
     "baryonforge_tpu/ops/tiles.py:985", "anis"),
    ("disc_paint_anis", ("disc_paint_anis",),
     "baryonforge_torch/csrc/disc_paint.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:2377", "anis"),
    ("anis_finish", ("anis_finish",), "baryonforge_torch/csrc/anis_finish.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:2349", "anis"),
    ("grid_cutout", ("grid_cutout", "tile_pairs"),
     "baryonforge_torch/csrc/grid_cutout.cu",
     "baryonforge_tpu/Runners/Map2DRunner.py:366", "grid"),
    ("grid_deposit", ("grid_deposit",),
     "baryonforge_torch/csrc/grid_deposit.cu",
     "baryonforge_tpu/ops/scatter.py:28", "grid"),
    # the public deposit_2d / deposit_3d: K16's list entry
    ("deposit_list", ("deposit_list",),
     "baryonforge_torch/csrc/grid_deposit.cu",
     "baryonforge_tpu/ops/scatter.py:47", "deposits"),
    ("snapshot_displace", ("snapshot_displace",),
     "baryonforge_torch/csrc/snapshot.cu",
     "baryonforge_tpu/Runners/SnapshotRunner.py:175", "snapshot"),
    ("ring_modes", ("ring_modes",), "baryonforge_torch/csrc/sht.cu",
     "baryonforge_tpu/utils/sht.py:49", "delta_cl"),
    ("legendre_alm", ("legendre_alm",), "baryonforge_torch/csrc/sht.cu",
     "baryonforge_tpu/utils/sht.py:92", "delta_cl"),
    ("disc_radii", ("disc_radii",), "baryonforge_torch/csrc/disc_direct.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:866", "direct"),
    ("disc_apply", ("disc_apply",), "baryonforge_torch/csrc/disc_direct.cu",
     "baryonforge_tpu/Runners/HealpixRunner.py:914", "direct"),
    ("grid_direct", ("grid_radii", "grid_direct"),
     "baryonforge_torch/csrc/grid_cutout.cu",
     "baryonforge_tpu/Runners/Map2DRunner.py:410", "direct"),
    ("snapshot_direct", ("snapshot_radii", "snapshot_direct"),
     "baryonforge_torch/csrc/snapshot.cu",
     "baryonforge_tpu/Runners/SnapshotRunner.py:196", "direct"),
    # the JAX package's cell list is host C++ (no TPU kernel); K24 finds
    # its sets on the card
    ("cell_list", ("cell_build", "cell_count", "cell_write"),
     "baryonforge_torch/csrc/cell_list.cu",
     "baryonforge_tpu/native/kernels.cpp:87", "snapshot"),
]


def kernel_rows(measured, launches, gpu):
    """The ``kernels`` line's rows: each kernel's launches on every path
    that ran it (its main path first, which must have launched it), its
    error and times from ``measured``; each logged."""
    rows = []
    for name, entries, src, rep, path in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by, library_ms = measured[name]

        def count(p):
            return sum(launches[p].get(e, 0) for e in entries)
        if count(path) < 1:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 "path")
        paths = [path] + [p for p in launches if p != path and count(p)]
        n = sum(count(p) for p in paths)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": n, "path": paths,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        was = "" if name not in EARLIER_MS else (
            f" (earlier: {EARLIER_MS[name][0]:.3f} ms, "
            f"{EARLIER_MS[name][1]}, from PERF.md, not measured in this "
            "run)")
        log(f"[{gpu}] {name}: kernel {ms:.4f} ms{was}, plain {plain_ms:.3f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}), library {lib}, "
            f"{n} launches on the paths " + ", ".join(
                f"{p} {count(p)}" for p in paths))
    if not all(math.isfinite(k["ms"]) for k in rows):
        raise AssertionError("kernel timing failed")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        import baryonforge_torch as bf
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    if os.path.dirname(os.path.abspath(bf.__file__)) != os.path.join(
            HERE, "baryonforge_torch"):
        print("chip_smoke: baryonforge_torch is not this checkout's",
              file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    from baryonforge_torch.ops import _build
    t_start = time.perf_counter()

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build().name})")

    model = bf.Baryonification2D(
        None, None, bf.cosmo.cosmology_from_dict(COSMO),
        epsilon_max=EPS_MAX).load_table(TABLE)
    log("kernels against their plain versions, polar catalog (NSIDE 64)")
    cat_p, shell_p = polar_inputs(bf, 64, 400, SEED)
    compare_kernels(bf, torch, model, cat_p, shell_p, "NSIDE 64 poles",
                    False)
    pole_regrid(bf, torch, 64)
    compare_tiled_kernels(bf, torch, model, cat_p, shell_p, "NSIDE 64 poles",
                          False)
    p_key_curves(torch, 400, False, (2, 5, 6))
    log("K7 on every tiling the runners build, K2 on poles, phi = 0, "
        "discs under 4 members and discs of several degrees")
    layout_cases(torch)
    disc_cases(bf, torch, model)

    tsz_file = tsz_models(bf, bf.utils.TabulatedProfile(
        None, bf.cosmo.cosmology_from_dict(COSMO),
        mass_def=bf.cosmo.MassDef200c).load_table(TSZ_TABLE))
    log("paint kernels against their plain versions, polar catalog "
        "(NSIDE 64, epsilon_max 60), the JAX file's tSZ table")
    compare_paint_kernels(bf, torch, tsz_file, cat_p, shell_p, 60,
                          "NSIDE 64 poles", False)

    log("tiled kernels against their plain versions, NSIDE 256 catalog")
    cat_m, shell_m = bench_inputs(bf, 256, 2000, SEED)
    compare_tiled_kernels(bf, torch, model, cat_m, shell_m, "NSIDE 256",
                          False)
    compare_paint_kernels(bf, torch, tsz_file, cat_m, shell_m, 20,
                          "NSIDE 256", False)

    log(f"kernels against their plain versions, bench shapes (NSIDE {NSIDE},"
        f" {N_HALOS} halos)")
    cat, shell = bench_inputs(bf, NSIDE, N_HALOS, SEED)
    measured = compare_kernels(bf, torch, model, cat, shell,
                               f"NSIDE {NSIDE}", True)
    measured.update(compare_tiled_kernels(bf, torch, model, cat, shell,
                                          f"NSIDE {NSIDE}", True))
    measured.update(compare_paint_kernels(bf, torch, tsz_file, cat, shell,
                                          PAINT_EPS, f"NSIDE {NSIDE}", True))
    for n_p, k1p in p_key_curves(torch, N_HALOS, True, (2, 5, 6)).items():
        log(f"[{gpu}] collapse_curves, {n_p} parameter axes, {N_HALOS} "
            f"halos, float32, from host columns: kernel {k1p[1]:.4f} ms, "
            f"the device alone {k1p[5]:.4f} ms, plain {k1p[2]:.3f} ms, "
            f"bound {k1p[3]:.4f} ms ({k1p[4]})")

    log("whole paths on the card against the plain versions on the CPU "
        "(float64)")
    card_vs_cpu(bf, torch, model, cat_p, shell_p,
                "NSIDE 64 poles, scatter path", deposit="scatter",
                regrid="scatter")
    polar = card_vs_cpu(bf, torch, model, cat_p, shell_p,
                        "NSIDE 64 poles, default path")
    if polar.get("disc_deposit", 0) < 1:
        raise AssertionError(f"the polar default run did not launch K2: "
                             f"{polar}")
    card_vs_cpu(bf, torch, model, cat_m, shell_m, "NSIDE 256, default path")
    paint_card_vs_cpu(bf, torch, tsz_file["log"], cat_p, shell_p, 60,
                      "NSIDE 64 poles")

    log("table build kernels against their plain versions (float64)")
    measured.update(compare_table_kernels(bf, torch, gpu))
    log("table path: the bench's Schneider19 table built on the card")
    card_model, launches_table = build_bench_table(bf, torch, gpu)

    log(f"main path (scatter): BaryonifyShell(deposit='scatter', "
        f"regrid='scatter', regrid_dtype=float32).process(), NSIDE {NSIDE}, "
        f"{N_HALOS} halos")
    runner_s = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                                 deposit="scatter", regrid="scatter",
                                 regrid_dtype=torch.float32, device=DEVICE)
    out_s, launches_s = drive(bf, torch, runner_s,
                              ("collapse_curves", "disc_deposit", "regrid"),
                              "scatter path", gpu)
    log(f"[{gpu}] scatter path, last call: curves "
        f"{runner_s.timings['curves']:.3f} ms (K1's call), regrid "
        f"{runner_s.timings['regrid']:.3f} ms (K3), CUDA events")
    moved = np.abs(out_s - shell.map)
    out_plain, plain_s = plain_pipeline(bf, torch, runner_s)
    # float32 deposit and regrid on both sides: per pixel, the JAX
    # package's edge-jitter bound or the float32 regrid weight noise
    # (~1e-6 * nside of the source value), whichever is larger
    tol_map = max(0.02 * float(moved.max()),
                  1e-6 * NSIDE * float(shell.map.max()))
    check("scatter path vs its plain pipeline, per pixel",
          float(np.abs(out_s - out_plain).max()), tol_map)
    log(f"[{gpu}] plain-version scatter path, one call: "
        f"{plain_s * 1e3:.1f} ms = {N_HALOS / plain_s:.1f} halos/s")

    log(f"main path (default, tiled engine): BaryonifyShell("
        f"regrid_dtype=float32).process(), NSIDE {NSIDE}, {N_HALOS} halos")
    runner_t = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                                 regrid_dtype=torch.float32, device=DEVICE)
    out_t, launches_t = drive(
        bf, torch, runner_t, ("collapse_curves", "tile_deposit",
                              "stencil_hot", "stencil", "stencil_complement",
                              "flat_view", "tile_view"), "tiled engine", gpu)
    if launches_t.get("stencil_geo", 0) < 1:
        raise AssertionError(f"tiled engine never built its source list: "
                             f"{launches_t}")
    check("tiled engine vs scatter path, per pixel",
          float(np.abs(out_t - out_s).max()), tol_map)
    log(f"  moved mass: scatter {moved.sum():.6e}, tiled "
        f"{np.abs(out_t - shell.map).sum():.6e}; mean |tiled - scatter| "
        f"{np.abs(out_t - out_s).mean():.3e}")

    # with the JAX runner's default float64 regrid, the regrid's weight
    # noise is gone and the two engines differ by disc-edge jitter only:
    # the JAX package's bounds (tests/test_tiled_deposit.py:53-63)
    kw = dict(epsilon_max=EPS_MAX, model=model, device=DEVICE)
    out_s64 = bf.BaryonifyShell(cat, shell, deposit="scatter",
                                regrid="scatter", **kw).process()
    out_t64 = bf.BaryonifyShell(cat, shell, **kw).process()
    moved64 = np.abs(out_s64 - shell.map)
    diff64 = np.abs(out_t64 - out_s64)
    check("tiled engine vs scatter path, float64 regrid, per pixel",
          float(diff64.max()), 0.02 * float(moved64.max()))
    check("tiled engine vs scatter path, float64 regrid, summed",
          float(diff64.sum()), 3e-3 * float(moved64.sum()))

    log(f"main path from the card-built table: BaryonifyShell("
        f"regrid_dtype=float32).process(), NSIDE {NSIDE}, {N_HALOS} halos")
    runner_c = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX,
                                 model=card_model,
                                 regrid_dtype=torch.float32, device=DEVICE)
    out_c, _ = drive(
        bf, torch, runner_c, ("collapse_curves", "tile_deposit",
                              "stencil_hot", "stencil", "stencil_complement",
                              "flat_view", "tile_view"),
        "tiled engine, card-built table", gpu)
    # the two tables differ by the JAX file's drift (<= 2.5e-4 of max |d|):
    # per pixel, the edge-jitter bound or the float32 regrid weight noise
    check("tiled engine: card-built table vs the file's table, per pixel",
          float(np.abs(out_c - out_t).max()), tol_map)
    log(f"  moved mass: file's table {np.abs(out_t - shell.map).sum():.6e}, "
        f"card's table {np.abs(out_c - shell.map).sum():.6e}")

    full_width_table(bf, torch, gpu)

    log("paint path: the bench's tSZ table built on the card")
    tsz_card = build_tsz_table(bf, torch, gpu)
    log(f"main path (paint, tiled): PaintProfilesShell(epsilon_max="
        f"{PAINT_EPS}, model=tSZ table).process(), NSIDE {NSIDE}, "
        f"{N_HALOS} halos")
    paint_kw = dict(epsilon_max=PAINT_EPS, model=tsz_card, device=DEVICE)
    out_pt, launches_pt = drive(
        bf, torch, bf.PaintProfilesShell(cat, shell, **paint_kw),
        ("collapse_curves", "tile_paint", "flat_view"), "tiled paint", gpu,
        paint=True)
    log(f"main path (paint, scatter): PaintProfilesShell(deposit='scatter', "
        f"epsilon_max={PAINT_EPS}, model=tSZ table).process()")
    out_ps, launches_ps = drive(
        bf, torch, bf.PaintProfilesShell(cat, shell, deposit="scatter",
                                         **paint_kw),
        ("collapse_curves", "disc_paint"), "scatter paint", gpu, paint=True)
    paint_bound_check("paint: tiled vs scatter, per pixel", out_pt, out_ps)
    log(f"  painted pixels: tiled {int((out_pt > 0).sum())}, scatter "
        f"{int((out_ps > 0).sum())}; sum tiled {out_pt.sum():.6e}, scatter "
        f"{out_ps.sum():.6e}")
    out_pf = bf.PaintProfilesShell(cat, shell, epsilon_max=PAINT_EPS,
                                   model=tsz_file["log"],
                                   device=DEVICE).process()
    paint_bound_check("tiled paint: card-built tSZ table vs the JAX file's",
                      out_pt, out_pf)
    north_star_paint(bf, torch, tsz_card, gpu)
    log("the paint with five per-halo properties: a five-key "
        "ParamTabulatedProfile built on the card, both engines")
    launches_p5, measured["collapse_curves_wide"] = p5_paint(bf, torch,
                                                             gpu)

    log("anisotropic paint kernels against their plain versions, polar "
        "catalog (NSIDE 64, epsilon_max 60), the JAX file's tSZ table")
    compare_anis_kernels(bf, torch, tsz_file, cat_p, shell_p, 60,
                         "NSIDE 64 poles", False)
    log(f"anisotropic paint kernels, bench shapes (NSIDE {NSIDE}, "
        f"{N_HALOS} halos, epsilon_max {PAINT_EPS})")
    measured.update(compare_anis_kernels(bf, torch, tsz_file, cat, shell,
                                         PAINT_EPS, f"NSIDE {NSIDE}", True))
    anis_card_vs_cpu(bf, torch, tsz_card, cat_p, shell_p, 60,
                     "NSIDE 64 poles")
    launches_anis = anis_paths(bf, torch, tsz_card, cat, shell, gpu)

    log("grid paths: the ΔP(k) recipe's tables built on the card")
    tabs = grid_tables(bf, torch, gpu)
    grid_card_vs_cpu(bf, torch, tabs)
    launches_grid, grid_measured, gm3 = grid_paths(bf, torch, tabs, gpu)
    measured.update(grid_measured)

    log("the remaining families' paths: Arico20, Mead20, Schneider25 and "
        "Battaglia12 tables built on the card, and their runners")
    launches_family = family_paths(bf, torch, gpu, cat, shell, gm3)

    log("snapshot path: the snapshot bench's table built on the card")
    count_host_searches()
    launches_snap, snap_measured, snap_inputs = snapshot_bench(bf, torch,
                                                               gpu)
    measured.update(snap_measured)
    log(f"the large snapshot: {BIG_PARTS} particles, {BIG_HALOS} halos, past "
        "2^31 - 1 pairs, in chunks")
    launches_big = large_snapshot(bf, torch, gpu, snap_inputs[0])

    log("the direct readout (models without halo_curves) of every runner "
        "at full width")
    launches_direct, direct_measured = direct_paths(
        bf, torch, gpu, model, tsz_card, cat, shell, tabs, snap_inputs)
    measured.update(direct_measured)

    log("spherical-harmonic kernels against their plain versions (float64)")
    compare_sht_kernels(bf, torch, gpu, 64, 191, False)
    ring_modes_cases(torch)
    measured.update(compare_sht_kernels(bf, torch, gpu, CL_NSIDE,
                                        3 * CL_NSIDE - 1, True))
    sht_checks(bf, torch, gpu)
    log("ΔCl path: its tables built on the card")
    launches_cl = delta_cl(bf, torch, gpu)

    log("the S19 validation pipelines at full width (utils/validation.py),"
        " each row beside PARITY.json's")
    launches_val = validation_paths(bf, torch, gpu)
    log("TabulatedCorrelation3D on the card, and as the xi_mm hook of the "
        "bench table")
    launches_hook = correlation_hook(bf, torch, gpu, card_model)
    log("halomodel_power on the card against the CPU")
    launches_hm = halomodel_check(bf, torch, gpu)
    log(f"meshes (halo_mesh({MESH_SHARDS}, 'cuda')) and the parallel "
        "front-ends at the bench configuration")
    launches_mesh = mesh_paths(
        bf, torch, gpu, model, tsz_card, cat, shell,
        (grid_inputs(bf, 3, GRID3D_N)[0], gm3, tabs["b3"]), snap_inputs)
    log("a FITS shell through LightconeShell(path=...)")
    launches_fits = fits_shell(bf, torch, gpu, model, cat, shell)

    log("the public grid deposits (ops.scatter.deposit_2d / deposit_3d) "
        "at full width")
    launches_dep, measured["deposit_list"] = public_deposits(bf, torch, gpu)
    log("FFTLog rows past shared memory: the passes over the whole card")
    launches_fht, _ = long_fht(bf, torch, gpu)

    launches_paint = {k: launches_pt.get(k, 0) + launches_ps.get(k, 0)
                      for k in set(launches_pt) | set(launches_ps)}
    launches = {"scatter": launches_s, "tiled": launches_t,
                "table": launches_table, "paint": launches_paint,
                "anis": launches_anis, "grid": launches_grid,
                "snapshot": launches_snap, "large_snapshot": launches_big,
                "delta_cl": launches_cl,
                **launches_family, **launches_val,
                "correlation_hook": launches_hook, "halomodel": launches_hm,
                "mesh": launches_mesh, "fits": launches_fits,
                "direct": launches_direct, "p5_paint": launches_p5,
                "deposits": launches_dep, "fht_long": launches_fht}
    kernels = kernel_rows(measured, launches, gpu)
    hot_ms, st_ms, live = measured["stencil_entries"]
    log(f"[{gpu}] K5 entries apart at the bench: stencil_hot {hot_ms:.4f} "
        f"ms, stencil {st_ms:.4f} ms ({live:.3f} of the tap rows run); "
        f"for context K3 (the scatter path's regrid of the same map) "
        f"{measured['regrid'][1]:.4f} ms")
    ptxas_report(bf)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(gpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
