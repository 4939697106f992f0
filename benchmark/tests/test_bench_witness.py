"""Witnesses for the plain reference from outside the port, of which it is
a frozen copy: its S19 profiles against the curves digitized from the
published paper (Schneider et al. 2019, Fig. 1, as upstream examples/08
reproduces them), and its tSZ table against the one the JAX package built
and saved. Both data files are the repository's own test data
(``tests/data``); nothing of either package is imported."""

import numpy as np
import pytest
import torch

from benchmark.reference import cosmo_core, schneider19 as s19
from benchmark.reference import thermodynamic as thermo

from conftest import ROOT

DATA = ROOT / "tests" / "data"

# upstream examples/08: the S19 cosmology, M = 1e14 / h Msun at a = 1,
# a fixed concentration, and beta set by M_c in {inf, 1e14 / h, 1e-10}
H = 0.67
FIG1_COSMO = dict(Omega_m=0.32, Omega_b=0.048, h=H, sigma8=0.83, n_s=0.96,
                  w0=-1.0)
FIG1_BPAR = dict(theta_ej=4, theta_co=0.1, mu_beta=1, eta=0.3,
                 eta_delta=0.3, tau=0, tau_delta=0, A=0.09 / 2,
                 M1=2.5e11 / H, epsilon_h=0.015, a=0.3, n=2, epsilon=4,
                 p=0.3, q=0.707, cdelta=6.71, gamma=2, delta=7)
R = np.geomspace(1e-3, 50, 400)


def _fig1():
    names = []
    for key in ["STAR", "GAS1", "GAS2", "GAS3", "2HALO", "TOTAL", "R200",
                "DMO", "DMB1", "DMB2", "DMB3"]:
        names += [key + "_X", key + "_Y"]
    raw = np.genfromtxt(DATA / "S19_Fig1_Scrapped.csv", delimiter=",",
                        skip_header=2, names=names)
    return {n: raw[n][np.isfinite(raw[n])] for n in names}


# (profile, its keywords, the digitized column, the plot's quantity, the
# r / h range compared, the median |log10| gap allowed). The CSV's GAS1 /
# GAS3 and DMB1 / DMB3 columns are in the opposite order to the figure's
# legend. Tolerances: the digitization's noise (~5-10%), and the 2-halo
# term's linear P(k) (EH98 here, CCL's in the paper).
FIG1 = [
    ("Gas", dict(M_c=np.inf), "GAS3", "rho", (0.02, 5), 0.05),
    ("Gas", dict(M_c=1e14 / H), "GAS2", "rho", (0.02, 5), 0.08),
    ("Gas", dict(M_c=1e-10), "GAS1", "rho", (0.02, 5), 0.07),
    ("Stars", {}, "STAR", "rho", (0.01, 0.1), 0.10),
    ("TwoHalo", {}, "2HALO", "rho", (1.0, 30), 0.15),
    ("DarkMatterOnly", {}, "DMO", "r2rho", (0.01, 10), 0.05),
    ("DarkMatterBaryon", dict(M_c=np.inf), "DMB3", "r2rho", (0.01, 10),
     0.03),
    ("DarkMatterBaryon", dict(M_c=1e14 / H), "DMB2", "r2rho", (0.01, 10),
     0.03),
    ("DarkMatterBaryon", dict(M_c=1e-10), "DMB1", "r2rho", (0.01, 10),
     0.03),
]


@pytest.mark.parametrize("cls, kw, key, quantity, span, tol", FIG1,
                         ids=[c[2] for c in FIG1])
def test_s19_profiles_match_the_published_figure(cls, kw, key, quantity,
                                                 span, tol):
    cosmo = cosmo_core.cosmology_from_dict(FIG1_COSMO)
    prof = getattr(s19, cls)(**{**FIG1_BPAR, **kw})
    rho = prof.real(cosmo, torch.as_tensor(R), torch.as_tensor([1e14 / H]),
                    1.0).numpy().reshape(-1)
    y_model = rho / H ** 2 if quantity == "rho" else rho * R ** 2
    fig = _fig1()
    x, y = fig[key + "_X"], fig[key + "_Y"]
    sel = (x >= span[0]) & (x <= span[1])
    assert sel.sum() >= 5
    ly = np.interp(np.log(x[sel]), np.log(R * H),
                   np.log(np.maximum(y_model, 1e-300)))
    gap = np.median(np.abs(ly - np.log(y[sel]))) / np.log(10.0)
    assert gap < tol, f"{key}: {gap:.4f} dex"


def test_tsz_table_matches_the_jax_package_table():
    """``tests/data/tsz_bench_table.npz``: the JAX package's log table of
    ThermalSZ(Pressure(S19, proj_cutoff=100), proj_cutoff=100), real and
    projected times a, 8 z x 20 M x 64 r. The reference reads 1.8e-12 in
    the log over all of it; compared at its first and last redshift."""
    tab = np.load(DATA / "tsz_bench_table.npz")
    h = 0.7
    cosmo = cosmo_core.cosmology_from_dict(dict(
        Omega_m=0.30, Omega_b=0.045, h=h, sigma8=0.8, n_s=0.96, w0=-1.0))
    bpar = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / h, mu_beta=0.4,
                eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0, A=0.09 / 2,
                M1=2.5e11 / h, epsilon_h=0.015, a=0.3, n=2, epsilon=4,
                p=0.3, q=0.707, gamma=2, delta=7)
    prof = thermo.ThermalSZ(thermo.Pressure(**bpar, proj_cutoff=100),
                            proj_cutoff=100)
    M = torch.as_tensor(np.exp(tab["M_range"]))
    r = torch.as_tensor(np.exp(tab["r_range"]))
    for j in (0, tab["z_range"].size - 1):
        a = float(np.exp(-tab["z_range"][j]))
        real = np.log(prof.real(cosmo, r, M, a).numpy())
        proj = np.log((prof.projected(cosmo, r, M, a) * a).numpy())
        assert np.abs(real - tab["tab3D"][j]).max() < 1e-9
        assert np.abs(proj - tab["tab2D"][j]).max() < 1e-9
