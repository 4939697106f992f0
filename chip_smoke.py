#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` (on PATH or under CUDA_HOME) and the
repository's ``baryonforge_torch`` package; it imports nothing of JAX. It

  1. prints the card's name and power limit (nvidia-smi),
  2. builds the CUDA kernels from ``baryonforge_torch/csrc``,
  3. holds each kernel (K1 curve collapse, K2 disc deposit, K3 scatter
     regrid) against its plain PyTorch version on the card, at the shapes of
     the bench configuration (bench.py:81-123: NSIDE 1024, 18,512 halos,
     seed 7, epsilon_max 20, the Schneider19 table in
     tools/_northstar_table.npz) in float32 and float64, and on a small
     catalog with halos at the poles, timing both with CUDA events,
  4. runs BaryonifyShell(deposit="scatter", regrid="scatter",
     regrid_dtype=float32).process() twice at that configuration, checks
     that each kernel was launched, that mass is conserved and the map is
     finite and agrees with the plain-version pipeline, and compares a small
     run on the card with the plain versions on the CPU in float64,
  5. prints one JSON line with each kernel's launches, error and times, and
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

    log(f"kernels against their plain versions, bench shapes (NSIDE {NSIDE},"
        f" {N_HALOS} halos)")
    cat, shell = bench_inputs(bf, NSIDE, N_HALOS, SEED)
    measured = compare_kernels(bf, torch, model, cat, shell,
                               f"NSIDE {NSIDE}", True)

    log("whole path on the card against the plain versions on the CPU "
        "(NSIDE 64, float64)")
    kw = dict(epsilon_max=EPS_MAX, model=model, deposit="scatter",
              regrid="scatter", dtype=torch.float64,
              regrid_dtype=torch.float64)
    out_gpu = bf.BaryonifyShell(cat_p, shell_p, device=DEVICE,
                                **kw).process()
    out_cpu = bf.BaryonifyShell(cat_p, shell_p, device="cpu", **kw).process()
    check("shell NSIDE 64 float64, card vs CPU",
          float(np.abs(out_gpu - out_cpu).max()),
          1e-9 * float(np.abs(out_cpu - shell_p.map).max()))

    log(f"main path: BaryonifyShell(deposit='scatter', regrid='scatter', "
        f"regrid_dtype=float32).process() x2, NSIDE {NSIDE}, {N_HALOS} halos")
    runner = bf.BaryonifyShell(cat, shell, epsilon_max=EPS_MAX, model=model,
                               deposit="scatter", regrid="scatter",
                               regrid_dtype=torch.float32, device=DEVICE)
    _build.reset_launches()
    runner.process()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.process()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    phases = runner.timings
    for k in ("collapse_curves", "disc_deposit", "regrid"):
        if launches.get(k, 0) < 2:
            raise AssertionError(f"main path did not launch {k}: {launches}")
    if out.shape != shell.map.shape or not np.isfinite(out).all():
        raise AssertionError("main path map is not finite / has wrong shape")
    if not np.isclose(out.sum(), shell.map.sum()):
        raise AssertionError("main path lost mass")
    moved = np.abs(out - shell.map)
    if not moved.max() > 0:
        raise AssertionError("main path moved nothing")

    out_plain, plain_s = plain_pipeline(bf, torch, runner)
    # float32 deposit and regrid on both sides: per pixel, the JAX
    # package's edge-jitter bound or the float32 regrid weight noise
    # (~1e-6 * nside of the source value), whichever is larger
    check("main path vs plain pipeline, per pixel",
          float(np.abs(out - out_plain).max()),
          max(0.02 * float(moved.max()),
              1e-6 * NSIDE * float(shell.map.max())))
    log(f"  main path moved mass {moved.sum():.6e}, mean |diff| vs plain "
        f"{np.abs(out - out_plain).mean():.3e}")

    log(f"[{gpu}] main path, second call: {wall * 1e3:.1f} ms = "
        f"{N_HALOS / wall:.1f} halos/s; phases (ms, CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
    log(f"[{gpu}] plain-version path, same call: {plain_s * 1e3:.1f} ms = "
        f"{N_HALOS / plain_s:.1f} halos/s")
    log(f"launches in the main path's two calls: {launches}")

    sources = {
        "collapse_curves": ("baryonforge_torch/csrc/curves.cu",
                            "baryonforge_tpu/ops/interp.py:252"),
        "disc_deposit": ("baryonforge_torch/csrc/deposit.cu",
                         "baryonforge_tpu/Runners/HealpixRunner.py:849"),
        "regrid": ("baryonforge_torch/csrc/regrid.cu",
                   "baryonforge_tpu/Runners/HealpixRunner.py:1346"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        err, ms, plain_ms = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        log(f"[{gpu}] {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("kernel timing failed")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
