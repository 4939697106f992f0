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
  5. runs, at the bench configuration, the scatter path
     BaryonifyShell(deposit="scatter", regrid="scatter",
     regrid_dtype=float32) and the default (tiled) engine
     BaryonifyShell(regrid_dtype=float32), each with the launch counts set
     to 0 just before and read just after: it checks that every kernel of
     each path was launched, that mass is conserved, that the maps are
     finite, that the scatter path agrees with its plain-version pipeline
     and the tiled engine with the scatter path (also with a float64
     regrid, to the JAX package's edge-jitter bounds), and prints each
     path's halos/s and per-phase milliseconds;
  6. prints one JSON line with each kernel's launches, error and times, and
     last the line {"ok": true, "device": {...}}.

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
            out["collapse_curves"] = (err1, time_ms(
                torch, lambda: interp.collapse_curves(*args), 50),
                time_ms(torch, lambda: interp.collapse_curves_plain(*args),
                        10))
            out["disc_deposit"] = (err2, time_ms(
                torch, lambda: deposit.disc_deposit(nside, halos, cp, r0, dl,
                                                    EPS_MAX), 10),
                time_ms(torch, lambda: deposit.disc_deposit_plain(
                    nside, halos, cp, r0, dl, EPS_MAX), 3))
            out["regrid"] = ((ok - op).abs().max().item(), time_ms(
                torch, lambda: regrid.regrid(nside, pk, orig), 10),
                time_ms(torch, lambda: regrid.regrid_plain(nside, pk, orig),
                        3))
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
            out["tile_deposit"] = (err4, time_ms(
                torch, lambda: td.tile_deposit(tiling, csr, pack, r0, inv),
                20), time_ms(torch, lambda: td.tile_deposit_plain(
                    tiling, csr, pack, r0, inv), 3))
            out["stencil"] = (err5, time_ms(torch, lambda: st.stencil_regrid(
                tiling, tables, ap, og_p, st.hot_tiles(ap, tables)), 20),
                time_ms(torch, lambda: st.stencil_regrid_plain(
                    tiling, tables, ap, og_p,
                    st.hot_tiles_plain(ap, tables)), 3))
            out["stencil_finish"] = (err6, time_ms(
                torch, lambda: st.stencil_complement(
                    tiling, base.clone(), ap, og_p, gp, hot), 20),
                time_ms(torch, lambda: st.stencil_complement_plain(
                    tiling, base.clone(), ap, og_p, gp, hot), 3))
            out["tile_layout"] = (err7, time_ms(
                torch, lambda: tiling.flat_view(tiling.tile_view(orig)), 20),
                time_ms(torch, lambda: tiling.flat_view_plain(
                    tiling.tile_view_plain(orig)), 3))
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

    launches = {"scatter": launches_s, "tiled": launches_t}
    kernels = []
    for name, entries, src, rep, path in KERNELS:
        err, ms, plain_ms = measured[name]
        n = sum(launches[path].get(e, 0) for e in entries)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n, "path": path,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        log(f"[{gpu}] {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("kernel timing failed")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
