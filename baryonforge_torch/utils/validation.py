"""First-principles validation pipelines pinning the framework to the
published Schneider+19 suppression curves (port of
``baryonforge_tpu.utils.validation``).

The same pipelines as the JAX package's, on the port's runners and
tables (every device step a kernel of the port on CUDA):

* halos sampled from the Tinker08 mass function above the reference's
  10^12.8 Msun completeness mask (reference examples/10),
* truncated-NFW (S19 DarkMatter) profiles painted at their positions,
* the un-collapsed mass fraction added as a uniform background,
* baryonified with Baryonification2D/3D and compared against the
  digitized S19 Fig. 2 curves (tests/data/S19_Fig2_Scrapped.csv),
* for shells, mapped through the thin-shell Limber relation
  Cl_b/Cl_dmo(ell) = S(k = (ell + 1/2)/chi_bar).

Every function keeps its JAX signature and adds ``device`` ("cuda" by
default; the CPU runs the plain versions). The runners take no
``halo_batch`` or ``verbose`` here.

Run as a script on the card to write the port's rows in the layout of
``PARITY.json`` (ΔCl at NSIDE 256 and 512, ΔP(k) S19, tiled vs scatter):

    python -m baryonforge_torch.utils.validation --out FILE

Reference workflows: examples/09_Reproduce_Schneider_deltaCls.ipynb and
examples/10_Reproduce_Schneider_deltaPk.ipynb.
"""

import csv
import os

import numpy as np
import torch

__all__ = ["fig2_curves", "limber_shell_run", "s19_box", "box_pk",
           "box_suppression", "deltapk_s19_residuals",
           "tiled_vs_scatter_residual", "TNG_COSMO_DICT", "BPAR_S19_FIG2"]

# cosmology of reference examples/10 and /12 (TNG-like)
H_TNG = 0.6711
TNG_COSMO_DICT = dict(Omega_m=0.3175, Omega_b=0.049, h=H_TNG,
                      sigma8=0.82, n_s=0.9649, w0=-1.0)
# S19 defaults as set in reference examples/10 (tau=-inf zeroes their
# unused satellite term; A = 0.09/2 matches their high-mass behavior)
BPAR_S19_FIG2 = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / H_TNG,
                     mu_beta=0.4, eta=0.3, eta_delta=0.3, tau=-np.inf,
                     tau_delta=0, A=0.09 / 2, M1=2.5e11 / H_TNG,
                     epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3,
                     q=0.707, gamma=2, delta=7,
                     proj_cutoff=205 / H_TNG / 2)


def _default_fig2_csv():
    here = os.path.dirname(os.path.abspath(__file__))
    cands = [os.path.join(here, "..", "..", "tests", "data",
                          "S19_Fig2_Scrapped.csv"),
             os.path.join(os.getcwd(), "tests", "data",
                          "S19_Fig2_Scrapped.csv")]
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError("S19_Fig2_Scrapped.csv not found; pass "
                            "csv_path explicitly")


def fig2_curves(csv_path=None):
    """Digitized S19 Fig. 2 suppression curves: {name: (k_h, ratio)}."""
    path = csv_path or _default_fig2_csv()
    with open(path) as f:
        header = [h.strip() for h in f.readline().split(",")[::2]]
        f.readline()
        rows = list(csv.reader(f))
    cols = {}
    for i, name in enumerate(header):
        x = np.array([float(r[2 * i]) for r in rows if r[2 * i]])
        y = np.array([float(r[2 * i + 1]) for r in rows if r[2 * i + 1]])
        o = np.argsort(x)
        cols[name] = (x[o], y[o])
    return cols


def _tinker_sample(rng, cosmo, a, volume, lgM_lo=12.8, lgM_hi=15.3,
                   device="cuda"):
    """Poisson-sample halo masses from the Tinker08 mass function above
    the reference's completeness cut (reference examples/10 mask); the
    mass function on ``device``, the draws on the host."""
    from . import halomodel as hm
    lgM = np.linspace(lgM_lo, lgM_hi, 60)
    M_grid = 10 ** lgM
    dndlgM = hm.MassFuncTinker08(device=device)(
        cosmo, torch.as_tensor(M_grid, device=device), a).cpu().numpy()
    counts = dndlgM * np.gradient(lgM) * volume
    ns = rng.poisson(counts)
    return np.repeat(M_grid, ns) * 10 ** rng.uniform(-0.02, 0.02,
                                                     int(ns.sum()))


def _shell_table_grid():
    return dict(z_min=0.08, z_max=0.14, N_samples_z=3,
                z_linear_sampling=True, M_min=3e12, M_max=5e15,
                N_samples_Mass=12, R_min=1e-3, R_max=60, N_samples_R=64,
                verbose=False)


def limber_shell_run(nside=256, k_eval_h=(0.7, 1.0, 1.4), seed=31,
                     csv_path=None, verbose=False, device="cuda",
                     timings=None):
    """Paint -> Baryonification2D shell displace -> anafast ratio,
    Limber-mapped to k and compared against the digitized S19 Fig. 2
    Mc1e14 curve.

    Returns a dict with ``rows`` = [{k_h, ell, ratio, fig2, resid}],
    ``lo_band`` (mean Cl ratio at ell 2-20, should be ~1) and ``meta``.
    ``timings``, a dict when given, receives each phase's host-clock
    seconds (the device synchronized at each mark)."""
    import time
    from .. import Profiles, Runners, utils
    from .. import cosmo as bcosmo
    from ..cosmo import core as _core
    from ..Profiles.BaryonCorrection import Baryonification2D
    from . import sht

    marks = [time.perf_counter()]

    def mark(name):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if timings is not None:
            timings[name] = marks[-1] - marks[-2]

    CD = dict(TNG_COSMO_DICT)
    H = CD["h"]
    COSMO = bcosmo.cosmology_from_dict(CD)
    BPAR = dict(BPAR_S19_FIG2)

    rng = np.random.default_rng(seed)
    z1, z2 = 0.10, 0.12
    a_of = lambda z: 1.0 / (1.0 + z)          # noqa: E731
    chi1 = float(np.asarray(
        _core.comoving_radial_distance(COSMO, a_of(z1))).ravel()[0])
    chi2 = float(np.asarray(
        _core.comoving_radial_distance(COSMO, a_of(z2))).ravel()[0])
    chi_bar = 0.5 * (chi1 + chi2)
    vol = 4.0 * np.pi / 3.0 * (chi2 ** 3 - chi1 ** 3)

    masses = _tinker_sample(rng, COSMO, a_of(0.11), vol, device=device)
    n = masses.size
    assert 30000 < n < 200000, n       # ~93k at the 10^12.8 cut
    # volume-weighted z inside the shell
    u = rng.uniform(0, 1, n)
    chis = (chi1 ** 3 + u * (chi2 ** 3 - chi1 ** 3)) ** (1.0 / 3.0)
    zs = np.interp(chis, [chi1, chi_bar, chi2], [z1, 0.11, z2])
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=masses, z=zs, cosmo=CD)
    mark("catalog")

    npix = 12 * nside * nside
    tab = utils.TabulatedProfile(Profiles.DarkMatter(**BPAR), COSMO,
                                 device=device)
    tab.setup_interpolator(**_shell_table_grid())
    mark("paint_table")
    zero_shell = utils.LightconeShell(map=np.zeros(npix), cosmo=CD)
    mass_map = Runners.PaintProfilesShell(
        cat, zero_shell, epsilon_max=5, model=tab,
        include_pixel_size=True, device=device).process()
    # un-collapsed mass as a uniform background (Fig-2 box recipe)
    rho_m = float(_core.rho_x(COSMO, 1.0, species="matter",
                              is_comoving=True))
    M_tot = rho_m * vol
    frac = mass_map.sum() / M_tot
    assert 0.25 < frac < 0.55, frac
    mass_map = mass_map + (M_tot - mass_map.sum()) / npix
    mark("paint")

    DMO = Profiles.DarkMatterOnly(**BPAR)
    DMB = Profiles.DarkMatterBaryon(**BPAR)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=10,
                              device=device)
    model.setup_interpolator(**_shell_table_grid())
    mark("table")
    shell = utils.LightconeShell(map=mass_map, cosmo=CD)
    new_map = Runners.BaryonifyShell(cat, shell, epsilon_max=10,
                                     model=model, device=device).process()
    mark("baryonify")

    k_max = max(k_eval_h)
    lmax = min(int(1.2 * (k_max * H * chi_bar)) + 16, 3 * nside - 1)
    d0 = mass_map / mass_map.mean() - 1.0
    d1 = new_map / new_map.mean() - 1.0
    cl0 = sht.anafast(d0, lmax=lmax, device=device)
    cl1 = sht.anafast(d1, lmax=lmax, device=device)
    mark("anafast")
    ratio = cl1 / cl0
    ell = np.arange(lmax + 1)

    fig2 = fig2_curves(csv_path)["Mc1e14"]
    lo = (ell >= 2) & (ell <= 20)
    rows = []
    for kh in k_eval_h:
        l_c = kh * H * chi_bar - 0.5
        band = (ell >= 0.85 * l_c) & (ell <= 1.15 * l_c)
        got = float(np.mean(ratio[band]))
        want = float(np.interp(kh, *fig2))
        rows.append(dict(k_h=kh, ell=round(l_c, 1), ratio=round(got, 4),
                         fig2=round(want, 4),
                         resid=round(got - want, 4)))
        if verbose:
            print(f"deltaCl k={kh} h/Mpc ell~{l_c:.0f}: ours {got:.4f} "
                  f"Fig2 {want:.4f} diff {got - want:+.4f}")
    return dict(rows=rows, lo_band=round(float(np.mean(ratio[lo])), 4),
                meta=dict(nside=nside, n_halos=int(n),
                          chi_bar=round(chi_bar, 1), lmax=int(lmax)))


def s19_box(N=256, L=128.0, seed=123, device="cuda"):
    """(catalog, painted DMO mass map): Tinker08-sampled halos with
    truncated-NFW profiles plus a uniform un-collapsed background — the
    synthetic stand-in for the reference's TNG300-3-Dark box."""
    from .. import Profiles, utils
    from .. import cosmo as bcosmo
    from ..Runners.Map2DRunner import PaintProfilesGrid

    CD = dict(TNG_COSMO_DICT)
    COSMO = bcosmo.cosmology_from_dict(CD)
    rng = np.random.default_rng(seed)
    masses = _tinker_sample(rng, COSMO, 1.0, L ** 3, device=device)
    n_halos = masses.size
    cat = utils.HaloNDCatalog(x=rng.uniform(0, L, n_halos),
                              y=rng.uniform(0, L, n_halos),
                              z=rng.uniform(0, L, n_halos),
                              M=masses, redshift=0.0, cosmo=CD)

    dmo_tab = utils.TabulatedProfile(
        Profiles.DarkMatter(**BPAR_S19_FIG2), COSMO, device=device)
    dmo_tab.setup_interpolator(z_min=0.0, z_max=0.05, N_samples_z=2,
                               z_linear_sampling=True,
                               M_min=3e12, M_max=5e15, N_samples_Mass=12,
                               R_min=1e-3, R_max=60, N_samples_R=64,
                               verbose=False)
    bins = (np.arange(N) + 0.5) * (L / N)
    gm0 = utils.GriddedMap(map=np.zeros((N, N, N)), bins=bins, cosmo=CD,
                           redshift=0.0)
    mass_map = PaintProfilesGrid(cat, gm0, epsilon_max=5, model=dmo_tab,
                                 include_pixel_size=True,
                                 device=device).process()
    rho_m = float(bcosmo.core.rho_x(COSMO, 1.0, species="matter",
                                    is_comoving=True))
    M_box = rho_m * L ** 3
    # sanity: a realistic collapsed fraction (calibration run: 0.407)
    assert 0.3 < mass_map.sum() / M_box < 0.5, mass_map.sum() / M_box
    return cat, mass_map + (M_box - mass_map.sum()) / N ** 3


def box_pk(field, L, device="cuda"):
    """Isotropically binned P(k) of a cubic box: the FFT and the binning
    in float64 on ``device`` (``field`` numpy or a tensor); returns
    (k centres, P) as numpy."""
    dev = torch.device(device)
    f = torch.as_tensor(field, dtype=torch.float64).to(dev)
    N = f.shape[0]
    delta = f / f.mean() - 1.0
    fk = torch.fft.rfftn(delta) * (L / N) ** 3
    p3 = fk.abs() ** 2 / L ** 3
    kf = 2 * np.pi / L
    kx = torch.as_tensor(np.fft.fftfreq(N, 1.0 / N) * kf, device=dev)
    kz = torch.as_tensor(np.fft.rfftfreq(N, 1.0 / N) * kf, device=dev)
    kk = torch.sqrt(kx[:, None, None] ** 2 + kx[None, :, None] ** 2
                    + kz[None, None, :] ** 2)
    b = np.arange(0.5, N // 2) * kf
    # np.digitize's bins: b[i-1] <= k < b[i] is bin i
    w = torch.bucketize(kk.reshape(-1), torch.as_tensor(b, device=dev),
                        right=True)
    c = torch.bincount(w, minlength=b.size + 1).cpu().numpy()
    s = torch.bincount(w, weights=p3.reshape(-1),
                       minlength=b.size + 1).cpu().numpy()
    cen = np.concatenate([[0], b]) + kf / 2
    g = c > 0
    return cen[g], (s / np.maximum(c, 1))[g]


def box_suppression(cat, mass_map, DMO, DMB, eps_max, k_eval_h,
                    L=128.0, rdelta=False, device="cuda", timings=None):
    """Baryonify the box with (DMO, DMB) and return the P(k) ratio at
    the requested k [h/Mpc]. ``timings``, a dict when given, receives the
    table build's, the baryonification's and the two spectra's host-clock
    seconds (the device synchronized at each mark)."""
    import time
    from .. import cosmo as bcosmo
    from .. import utils
    from ..Runners.Map2DRunner import BaryonifyGrid
    from ..Profiles.BaryonCorrection import Baryonification3D

    def now():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    CD = dict(TNG_COSMO_DICT)
    H = CD["h"]
    COSMO = bcosmo.cosmology_from_dict(CD)
    N = mass_map.shape[0]
    t0 = now()
    model = Baryonification3D(DMO, DMB, COSMO, epsilon_max=eps_max,
                              device=device)
    model.setup_interpolator(z_min=0.0, z_max=0.05, N_samples_z=2,
                             z_linear_sampling=True,
                             M_min=3e12, M_max=5e15, N_samples_Mass=12,
                             R_min=1e-4, R_max=300,
                             N_samples_R=2000 if rdelta else 500,
                             Rdelta_sampling=rdelta, verbose=False)
    t1 = now()
    bins = (np.arange(N) + 0.5) * (L / N)
    gm = utils.GriddedMap(map=mass_map, bins=bins, cosmo=CD, redshift=0.0)
    new_map = BaryonifyGrid(cat, gm, epsilon_max=eps_max, model=model,
                            device=device).process()
    t2 = now()
    k0, p0 = box_pk(mass_map, L, device=device)
    k1, p1 = box_pk(new_map, L, device=device)
    t3 = now()
    if timings is not None:
        for k, v in (("table", t1 - t0), ("baryonify", t2 - t1),
                     ("box_pk", t3 - t2)):
            timings.setdefault(k, []).append(v)
    r = p1 / p0
    return [float(np.interp(kh * H, k0, r)) for kh in k_eval_h]


def deltapk_s19_residuals(csv_path=None, k_eval_h=(1.0, 3.0),
                          mc_keys=(("Mc1e14", 1e14 / H_TNG),
                                   ("Mc4e14", 4e14 / H_TNG)),
                          box=None, verbose=False, device="cuda",
                          timings=None):
    """S19 ΔP(k) vs the digitized Fig. 2 M_c curves. Returns rows
    [{curve, k_h, ratio, fig2, resid}]."""
    from .. import Profiles

    cat, mass_map = box if box is not None else s19_box(device=device)
    curves = fig2_curves(csv_path)
    rows = []
    for key, M_c in mc_keys:
        par = dict(BPAR_S19_FIG2, M_c=M_c)
        r = box_suppression(cat, mass_map,
                            Profiles.DarkMatterOnly(**par),
                            Profiles.DarkMatterBaryon(**par),
                            eps_max=10, k_eval_h=list(k_eval_h),
                            device=device, timings=timings)
        x, y = curves[key]
        for kh, ours in zip(k_eval_h, r):
            want = float(np.interp(kh, x, y))
            rows.append(dict(curve=key, k_h=kh, ratio=round(ours, 4),
                             fig2=round(want, 4),
                             resid=round(ours - want, 4)))
            if verbose:
                print(f"deltaPk {key} k={kh}: ours {ours:.4f} "
                      f"Fig2 {want:.4f} diff {ours - want:+.4f}")
    return rows


def tiled_vs_scatter_residual(nside=64, n_halos=300, seed=7,
                              device="cuda"):
    """Max per-pixel relative residual between the tiled (scatter-free)
    and the scatter baryonify paths on a random shell — the map-parity
    pin between the two independent phase-A engines (both regrid by
    scatter, float32)."""
    from .. import Profiles, Runners, utils
    from .. import cosmo as bcosmo
    from ..Profiles.BaryonCorrection import Baryonification2D

    CD = dict(TNG_COSMO_DICT)
    COSMO = bcosmo.cosmology_from_dict(CD)
    rng = np.random.default_rng(seed)
    cat = utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n_halos),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos))),
        M=10 ** rng.uniform(13.5, 15.0, n_halos),
        z=rng.uniform(0.1, 0.4, n_halos), cosmo=CD)
    DMO = Profiles.DarkMatterOnly(**BPAR_S19_FIG2)
    DMB = Profiles.DarkMatterBaryon(**BPAR_S19_FIG2)
    model = Baryonification2D(DMO, DMB, COSMO, epsilon_max=20,
                              device=device)
    model.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                             M_min=1e13, M_max=3e15, N_samples_Mass=8,
                             R_min=1e-3, R_max=50, N_samples_R=64,
                             verbose=False)
    npix = 12 * nside * nside
    raw = rng.exponential(1.0, npix)
    outs = {}
    for dep in ("auto", "scatter"):
        shell = utils.LightconeShell(map=raw.copy(), cosmo=CD)
        outs[dep] = Runners.BaryonifyShell(
            cat, shell, epsilon_max=20, model=model, deposit=dep,
            regrid="scatter", dtype=torch.float32,
            device=device).process()
    scale = np.abs(outs["scatter"]).max()
    resid = np.abs(outs["auto"] - outs["scatter"]).max() / scale
    return dict(max_rel_residual=float(resid), nside=nside,
                n_halos=n_halos)


def main(argv=None):
    """Write the port's validation rows as one JSON object in the layout
    of PARITY.json: deltacl_limber (NSIDE 256), deltacl_limber_nside512,
    deltapk_s19 and tiled_vs_scatter, each with its host-clock seconds."""
    import argparse
    import json
    import subprocess
    import time

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-deltacl", action="store_true")
    ap.add_argument("--skip-nside512", action="store_true")
    ap.add_argument("--skip-deltapk", action="store_true")
    ap.add_argument("--skip-engines", action="store_true")
    args = ap.parse_args(argv)
    dev = args.device
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=here, capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        rev = ""
    out = {"date": time.strftime("%Y-%m-%d"), "git": rev, "band": 0.07,
           "device": (torch.cuda.get_device_name(0)
                      if torch.device(dev).type == "cuda" else "cpu"),
           "note": ("parity pins vs the digitized S19 Fig. 2 curves "
                    "(tests/data/S19_Fig2_Scrapped.csv); pipelines in "
                    "baryonforge_torch/utils/validation.py, the rows of "
                    "PARITY.json from the port")}

    def emit():
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, round(time.perf_counter() - t0, 1)

    if not args.skip_deltacl:
        for key, nside in (("deltacl_limber", 256),
                           ("deltacl_limber_nside512", 512)):
            if nside == 512 and args.skip_nside512:
                continue
            res, sec = timed(lambda: limber_shell_run(
                nside=nside, verbose=True, device=dev))
            out[key] = dict(res, seconds=sec)
            emit()
    if not args.skip_deltapk:
        rows, sec = timed(lambda: deltapk_s19_residuals(verbose=True,
                                                        device=dev))
        out["deltapk_s19"] = {"rows": rows, "seconds": sec}
        emit()
    if not args.skip_engines:
        res, sec = timed(lambda: tiled_vs_scatter_residual(device=dev))
        out["tiled_vs_scatter"] = dict(res, seconds=sec)
        emit()
    emit()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
