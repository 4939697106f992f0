"""The plain reference against hand-checked tiny cases."""

import math

import numpy as np
import torch

from benchmark.reference import cosmo_core, fftlog
from benchmark.reference import healpix as hpx
from benchmark.reference.paint import disc_paint_plain
from benchmark.reference.regrid import regrid_plain
from benchmark.shells import map_gaps, mass_gap

NSIDE = 16


def test_regrid_without_offsets_is_the_identity():
    npix = hpx.npix(NSIDE)
    orig = torch.rand(npix, dtype=torch.float64)
    out = regrid_plain(NSIDE, torch.zeros(npix, 2, dtype=torch.float64),
                       orig)
    assert torch.equal(out, orig)


def test_regrid_moves_a_pixel_onto_its_neighbour():
    # pixel p on an equatorial ring moved by one phi step lands on the
    # centre of pixel p + 1 of the same ring: all its mass goes there
    npix = hpx.npix(NSIDE)
    p = 2 * NSIDE * (NSIDE + 1) + 5 * NSIDE
    th, ph = hpx.pix2ang(NSIDE, torch.tensor([p, p + 1], dtype=torch.int32))
    assert math.isclose(float(th[0]), float(th[1]))
    po = torch.zeros(npix, 2, dtype=torch.float64)
    po[p, 1] = float(torch.sin(th[0]) * (ph[1] - ph[0]))
    orig = torch.zeros(npix, dtype=torch.float64)
    orig[p] = 3.0
    out = regrid_plain(NSIDE, po, orig)
    assert math.isclose(float(out[p + 1]), 3.0, rel_tol=1e-9)
    assert math.isclose(float(out.sum()), 3.0, rel_tol=1e-12)


def test_disc_paint_of_a_flat_curve():
    # a log curve flat at ln 2: every member pixel gets 2 / a, and the
    # members are the pixel centres within the disc's radius
    halos = dict(theta=torch.tensor([1.0], dtype=torch.float64),
                 phi=torch.tensor([2.0], dtype=torch.float64),
                 radius=torch.tensor([0.3], dtype=torch.float64),
                 D=torch.tensor([400.0], dtype=torch.float64),
                 a=torch.tensor([0.5], dtype=torch.float64))
    curves = torch.full((1, 16), math.log(2.0), dtype=torch.float64)
    out = disc_paint_plain(NSIDE, halos, curves, math.log(1e-3), 1.0, True,
                           False, torch.float64)
    th, ph = hpx.pix2ang(NSIDE, torch.arange(hpx.npix(NSIDE),
                                             dtype=torch.int32))
    cosd = (torch.cos(th) * math.cos(1.0)
            + torch.sin(th) * math.sin(1.0) * torch.cos(ph - 2.0))
    inside = cosd >= math.cos(0.3)
    assert torch.equal(out > 0, inside)
    assert torch.allclose(out[inside], torch.tensor(4.0, dtype=torch.float64))


def test_hankel_transform_of_a_gaussian():
    # fht gives int a(x) J0(kx) k dx; with a = x exp(-x^2/2) that is
    # k exp(-k^2/2)
    x = torch.logspace(-4, 3, 1024, dtype=torch.float64)
    k, a = fftlog.fht(x, torch.exp(-x ** 2 / 2) * x, mu=0.0, q=0.0)
    sel = (k > 5e-2) & (k < 2)           # away from the grid's ends
    want = k[sel] * torch.exp(-k[sel] ** 2 / 2)
    assert torch.allclose(a[sel], want, rtol=1e-3, atol=0)


def test_distances_at_low_redshift():
    # D_A = a chi and chi ~ c z / H0 (1 - (1 + q0) z / 2) at small z
    c = cosmo_core.cosmology_from_dict(dict(Omega_m=0.3, Omega_b=0.05,
                                            h=0.7, sigma8=0.8, n_s=0.96))
    z = 0.01
    chi = float(cosmo_core.comoving_radial_distance(c, 1 / (1 + z))[0])
    q0 = 0.5 * 0.3 - 0.7
    want = 299792.458 / 70.0 * z * (1 - (1 + q0) * z / 2)
    assert abs(chi - want) < 2e-3 * want
    da = float(cosmo_core.angular_diameter_distance(c, 1 / (1 + z))[0])
    assert math.isclose(da, chi / (1 + z), rel_tol=1e-12)


def test_gaps_by_hand():
    orig = np.array([1.0, 1.0, 1.0, 1.0])
    ref = np.array([0.5, 1.5, 1.0, 1.0])       # moved 1 in all
    out = np.array([0.5, 1.25, 1.25, 1.0])     # 0.25 of it misplaced twice
    s, m = map_gaps(out, ref, orig)
    assert math.isclose(s, 0.5) and math.isclose(m, 0.5)
    assert mass_gap(out, orig) == 0.0
    assert math.isclose(mass_gap(out * 1.01, orig), 0.01)
