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
         parameter axes;
  4. runs the whole path on the card against the plain versions on the CPU
     (float64) for the polar catalog through the default engine (its small
     discs take K2) and the scatter path, and the NSIDE 256 catalog through
     the default engine;
  5. holds the table build's kernels against their plain versions on the
     card (float64): K8 FFTLog on correlation_3d's P(k) grid (1 x 1024) and
     on a batch of profile rows (20 x 2048, mu = 0 and 1/2), and K9 on the
     bench table's first redshift (20 masses, 64 radii);
  6. builds the Schneider19 displacement table on the card from the bench's
     profile parameters (bench.py:42-55: 8 z x 20 M x 64 r) through
     Baryonification2D(DarkMatterOnly, DarkMatterBaryon).setup_interpolator,
     with the launch counts set to 0 just before and read just after; checks
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
     finite, that the scatter path agrees with its plain-version pipeline
     and the tiled engine with the scatter path (also with a float64
     regrid, to the JAX package's edge-jitter bounds), and prints each
     path's halos/s and per-phase milliseconds; then the default engine
     again from the card-built table (the table file is not read on that
     path), against the run from the file's table within the edge-jitter
     bound;
  8. times the full-width table (setup_interpolator() at its defaults, 30 z
     x 30 M x 100 r) and counts its broken-row warnings;
  9. prints one JSON line with each kernel's launches, error, times, bound
     and library-call time, and last the line {"ok": true, "device": ...}.

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
# H100 SXM data sheet: HBM bytes/s, FLOP/s outside the tensor cores
HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12


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
        ck, r0, dl = interp.collapse_curves(*args)
        cp, _, _ = interp.collapse_curves_plain(*args)
        torch.cuda.synchronize()
        err1 = (ck - cp).abs().max().item()
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
            # K1: per output value 4 corner weights and multiply-adds
            out["collapse_curves"] = (err1, time_ms(
                torch, lambda: interp.collapse_curves(*args), 50),
                time_ms(torch, lambda: interp.collapse_curves_plain(*args),
                        10)) + bound(
                nbytes(m._table, m._axes, cp) + 2 * 4 * n, 16 * n * nr,
                F32_FLOPS) + (None,)
            # K2: its disc pixels (sum of pi r^2 over the pixel area), ~40
            # operations each; the (npix, 2) offsets written once
            pairs = npix * float(np.sum(hd["radius"] ** 2)) / 4.0
            out["disc_deposit"] = (err2, time_ms(
                torch, lambda: deposit.disc_deposit(nside, halos, cp, r0, dl,
                                                    EPS_MAX), 10),
                time_ms(torch, lambda: deposit.disc_deposit_plain(
                    nside, halos, cp, r0, dl, EPS_MAX), 3)) + bound(
                nbytes(halos, cp, pk), 40 * pairs, F32_FLOPS) + (None,)
            # K3: per pixel its offset and value read, its value written,
            # ~60 operations of neighbour geometry and weights
            out["regrid"] = ((ok - op).abs().max().item(), time_ms(
                torch, lambda: regrid.regrid(nside, pk, orig), 10),
                time_ms(torch, lambda: regrid.regrid_plain(nside, pk, orig),
                        3)) + bound(nbytes(pk, orig, op), 60 * npix,
                                    F32_FLOPS) + (None,)
    return out


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
        err_ang = max((a - b).abs().max().item() if a.numel() else 0.0
                      for a, b in zip(gk[2:], gp[2:]))
        # the device's asin / sin against torch's: a few ulps
        check(f"K6 stencil_geo angles [{tag}]", err_ang,
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
            # K6: per source (the geometric list and the hot tiles' slots)
            # its offset, value and geometry read and four neighbours
            # updated, ~80 operations
            n_src = gp[0].numel() + hot.numel() * tiling.P
            out["stencil_finish"] = (err6, time_ms(
                torch, lambda: st.stencil_complement(
                    tiling, base.clone(), ap, og_p, gp, hot), 20),
                time_ms(torch, lambda: st.stencil_complement_plain(
                    tiling, base.clone(), ap, og_p, gp, hot), 3)) + bound(
                n_src * (8 + 4 + 12 + 4 * 8), 80.0 * n_src,
                F32_FLOPS) + (None,)
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
            log(f"  K6 stencil_geo (once per NSIDE): kernel {geo_ms[0]:.3f} "
                f"ms, plain {geo_ms[1]:.3f} ms")
    return out


def p_key_curves(torch, n, timing):
    """K1 against its plain version on a table with two parameter axes
    (made from a seed), for ``n`` halos; returns (err, ms, plain_ms)."""
    from baryonforge_torch.ops import interp
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    shape = (8, 20, 64, 4, 3)
    res = None
    for dt in (torch.float64, torch.float32):
        axes = tuple(torch.as_tensor(np.cumsum(rng.uniform(0.2, 1.0, k)),
                                     dtype=dt, device=dev) for k in shape)
        table = torch.as_tensor(rng.normal(size=shape), dtype=dt, device=dev)
        M = np.exp(rng.uniform(axes[1][0].item(), axes[1][-1].item(), n))
        a = 1.0 / np.exp(rng.uniform(axes[0][0].item(), axes[0][-1].item(),
                                     n))
        p = {f"p{k}": rng.uniform(axes[3 + k][0].item(),
                                  axes[3 + k][-1].item(), n) for k in (0, 1)}
        args = (table, axes, 2, M, a, ["p0", "p1"], p)
        ck = interp.collapse_curves(*args)[0]
        cp = interp.collapse_curves_plain(*args)[0]
        torch.cuda.synchronize()
        err = (ck - cp).abs().max().item()
        rel = 1e-6 if dt == torch.float32 else 1e-12
        check(f"K1 collapse_curves, 2 parameter axes [{n} halos, {dt}]", err,
              rel * cp.abs().max().item())
        if timing and dt == torch.float32:
            res = (err, time_ms(torch, lambda: interp.collapse_curves(*args),
                                20),
                   time_ms(torch, lambda: interp.collapse_curves_plain(*args),
                           5))
    return res


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

        def kern():
            return fftlog.fht(x, a, mu, q)[1]

        def plain():
            return fftlog.fht_plain(a, lx, mu, qs, ln_kcrc)
        ok, op = kern(), plain()
        torch.cuda.synchronize()
        err = (ok - op).abs().max().item()
        # direct DFT sums against torch.fft's, each row against its own
        # largest value. Two correct orders of the sums (the JAX package's
        # matmul DFT and torch.fft) differ by up to 2.2e-12 of a row's
        # largest value on the 20 x 2048 batch
        # (tests/test_torch_fftlog.py::test_fht_summation_orders), so the
        # bound is 1e-11
        rel = ((ok - op).abs() / op.abs().amax(-1, keepdim=True)).max()
        check(f"K8 fht [{label}] (per row, of the row's largest value)",
              rel.item(), 1e-11)
        B, N = a.shape
        # what the function needs: per row two real-data FFTs (2.5 N log2 N
        # operations each), the bias and unbias products and the product
        # with the coefficients (~8 operations a point); once for all rows
        # the bias and unbias factors (an exp each, ~20 operations a point)
        # and the coefficients of the N/2 + 1 distinct frequencies (the
        # others are their conjugates), ~450 operations each (two Lanczos
        # log-gammas with their complex logs, a complex exponential)
        ops = (B * (5.0 * N * math.log2(N) + 8.0 * N) + 40.0 * N
               + 450.0 * (N // 2 + 1))
        return (err, time_ms(torch, kern, reps), time_ms(torch, plain, reps)
                ) + bound(nbytes(a, lx, op), ops, F64_FLOPS) + (None,)

    # correlation_3d's transform: P(k) k^1.5 on K_GRID, mu = 1/2, q = -1/2
    k, pk = power.pk_grid(cosmo, a0, device=dev)
    out["fht"] = fht_case("correlation_3d, 1 x 1024", k,
                          (pk * k ** 1.5)[None], 0.5, -0.5, 50)
    # a batch of 20 DarkMatter rows on a 2048-point Fourier-like grid
    x = torch.as_tensor(np.geomspace(1e-7, 1e9, 2048), device=dev)
    M20 = torch.as_tensor(np.geomspace(5e12, 2e15, 20), device=dev)
    rows = bf.Profiles.DarkMatter(**BPAR).real(cosmo, x, M20, a0)
    for mu in (0.0, 0.5):
        res = fht_case(f"20 x 2048, mu = {mu}", x, rows * x ** 1.5, mu, -0.5,
                       10)
        log(f"[{gpu}] K8 fht 20 x 2048, mu = {mu}: kernel {res[1]:.4f} ms, "
            f"plain {res[2]:.4f} ms, bound {res[3]:.4f} ms ({res[4]})")

    # K9 on the bench table's first redshift
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

    def k9(enc, disp):
        def run():
            ms = [enc(i, d, lnr_int, lnr) for i, d in ins]
            return disp(lnr, *ms)
        return run
    B, n_int, n_r = ins[0][0].shape[0], ins[0][0].shape[1], lnr.numel()
    # per row: Simpson, mask, compaction and PCHIP slopes ~30 operations a
    # grid point, ~40 per evaluation; the inversion two masked PCHIPs of n_r
    k9_bytes = 2 * (nbytes(*ins[0]) + nbytes(lnr_int, lnr)
                    + B * n_r * 8) + nbytes(lnr, *masses, dp)
    k9_ops = 2 * B * (30.0 * n_int + 40.0 * n_r) + B * 120.0 * n_r
    out["table_rows"] = (max(err, e), time_ms(torch, k9(
        table_rows.enclosed_mass, table_rows.displacement_rows), 50),
        time_ms(torch, k9(table_rows.enclosed_mass_plain,
                          table_rows.displacement_rows_plain), 5)
    ) + bound(k9_bytes, k9_ops, F64_FLOPS) + (None,)
    log(f"[{gpu}] K8 fht 1 x 1024: kernel {out['fht'][1]:.4f} ms, plain "
        f"{out['fht'][2]:.4f} ms; K9 one redshift: kernel "
        f"{out['table_rows'][1]:.4f} ms, plain {out['table_rows'][2]:.4f} ms")
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
    Mo = clock("DMO enclosed mass (profile + K9)",
               lambda: model._enclosed_mass_curve(model.DMO, r, M, a0, True))
    Mb = clock("DMB enclosed mass (profile + K9)",
               lambda: model._enclosed_mass_curve(model.DMB, r, M, a0, True))
    lnr = torch.log(torch.as_tensor(r, device=DEVICE))
    clock("displacement rows (K9)",
          lambda: table_rows.displacement_rows(lnr, Mo, Mb))
    log(f"[{gpu}] one redshift of the bench table, host clock (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ph.items()))
    return ph


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
    model = s19_model(bf, DEVICE).setup_interpolator(**BENCH_GRID)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    want = {"fht": 2 * n_z, "enclosed_mass": 2 * n_z,
            "displacement_rows": n_z}
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


def drive(bf, torch, runner, required, label, gpu):
    """Two warm calls and N_CALLS timed ones of ``runner.process()``, with
    the launch counts set to 0 just before and read just after. Checks the
    kernels in ``required`` were launched and the map is finite, of the
    right shape, moved and mass-conserving. Returns (map, launches)."""
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
    if not np.isclose(out.sum(), shell.map.sum()):
        raise AssertionError(f"{label} lost mass")
    if not np.abs(out - shell.map).max() > 0:
        raise AssertionError(f"{label} moved nothing")
    q = np.percentile(np.array(walls) * 1e3, [25, 50, 75])
    log(f"[{gpu}] {label}: {N_CALLS} calls, median {q[1]:.3f} ms "
        f"({q[0]:.3f}-{q[2]:.3f}) = {N_HALOS / (q[1] / 1e3):.1f} halos/s; "
        "median phases (ms, CUDA events): " + ", ".join(
            f"{k} {np.median([p[k] for p in phases]):.3f}"
            for k in phases[0]))
    log(f"launches in {label}'s {2 + N_CALLS} calls: {launches}")
    return out, launches


KERNELS = [
    # name, entry points, source, TPU kernel replaced, the path it runs on
    ("collapse_curves", ("collapse_curves",),
     "baryonforge_torch/csrc/curves.cu",
     "baryonforge_tpu/ops/interp.py:252", "tiled"),
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
    ("table_rows", ("enclosed_mass", "displacement_rows"),
     "baryonforge_torch/csrc/table_rows.cu",
     "baryonforge_tpu/Profiles/BaryonCorrection.py:62", "table"),
]


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
    p_key_curves(torch, 400, False)

    log("tiled kernels against their plain versions, NSIDE 256 catalog")
    cat_m, shell_m = bench_inputs(bf, 256, 2000, SEED)
    compare_tiled_kernels(bf, torch, model, cat_m, shell_m, "NSIDE 256",
                          False)

    log(f"kernels against their plain versions, bench shapes (NSIDE {NSIDE},"
        f" {N_HALOS} halos)")
    cat, shell = bench_inputs(bf, NSIDE, N_HALOS, SEED)
    measured = compare_kernels(bf, torch, model, cat, shell,
                               f"NSIDE {NSIDE}", True)
    measured.update(compare_tiled_kernels(bf, torch, model, cat, shell,
                                          f"NSIDE {NSIDE}", True))
    k1p = p_key_curves(torch, N_HALOS, True)
    log(f"[{gpu}] collapse_curves, 2 parameter axes, {N_HALOS} halos: "
        f"kernel {k1p[1]:.3f} ms, plain {k1p[2]:.3f} ms")

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

    launches = {"scatter": launches_s, "tiled": launches_t,
                "table": launches_table}
    kernels = []
    for name, entries, src, rep, path in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by, library_ms = measured[name]
        n = sum(launches[path].get(e, 0) for e in entries)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n, "path": path,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[{gpu}] {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), library {lib}, "
            f"{n} launches on the {path} path")
        if n < 1:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 "path")
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("kernel timing failed")
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
