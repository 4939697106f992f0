"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``benchmark/traffic/``, read here by its name.

A mix gives the shells of a cell: ``shells`` distinct (catalog, map) pairs,
used in turn by a closed loop of one shell a call (one caller, as a
campaign's loop over shells). Everything is made in
numpy from the run's ``--seed``; the same seed gives the same shells.

Every seed gets the same set of halo sizes (masses and redshifts), in
another order and at other positions, so that seeds change where the work
lies and not how much of it there is: the counts and sizes are a Poisson
draw's expected values at fixed quantiles, not draws. Catalog kind:

``mass_function``
    Counts a bin from a frozen dn/dlog10M table (``mass_function_file``)
    times the shell's comoving volume between ``chi_lo_Mpc`` and
    ``chi_hi_Mpc``, rounded (the expected counts of a Poisson draw);
    within a bin the masses are spread evenly over +-``mass_jitter_dex``;
    z volume-weighted between ``z_lo`` and ``z_hi`` through ``z_mid``, by
    evenly spaced quantiles; positions uniform on the sky.
Maps (``map``): ``exponential``, unit-mean exponential pixel values (a
positive mass map standing in for a painted density shell: the values set
none of the runners' work, which follows the halos), float64, at the
configuration's NSIDE.
"""

import csv
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
TRAFFIC_DIR = HERE / "traffic"

__all__ = ["load", "make_shells", "halo_count", "TRAFFIC_DIR"]


def load(name, directory=TRAFFIC_DIR):
    """The traffic mix ``name`` (a dict), from ``<directory>/<name>.json``."""
    path = Path(directory) / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    mix["_dir"] = str(Path(directory))
    return mix


def _read_table(path):
    """(lgM, dn/dlog10M) of a frozen mass-function CSV ('#' lines are
    notes)."""
    with open(path) as f:
        rows = [r for r in csv.reader(line for line in f
                                      if not line.startswith("#"))]
    body = [tuple(map(float, r)) for r in rows[1:] if r]
    lgM, dn = (np.array(c) for c in zip(*body))
    return lgM, dn


def _even(n):
    """n evenly spaced quantiles in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def _sky(rng, n):
    ra = rng.uniform(0.0, 360.0, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, n)))
    return ra, dec


def _mass_function_catalog(mix, rng):
    lgM, dn = _read_table(Path(mix["_dir"]) / mix["mass_function_file"])
    chi1, chi2 = float(mix["chi_lo_Mpc"]), float(mix["chi_hi_Mpc"])
    vol = 4.0 * np.pi / 3.0 * (chi2 ** 3 - chi1 ** 3)
    counts = np.rint(dn * np.gradient(lgM) * vol).astype(np.int64)
    jit = float(mix["mass_jitter_dex"])
    lg = np.concatenate([lgM[i] + jit * (2.0 * _even(c) - 1.0)
                         for i, c in enumerate(counts) if c > 0])
    n = lg.size
    M = 10.0 ** lg[rng.permutation(n)]
    u = _even(n)[rng.permutation(n)]
    chis = (chi1 ** 3 + u * (chi2 ** 3 - chi1 ** 3)) ** (1.0 / 3.0)
    chi_bar = 0.5 * (chi1 + chi2)
    z = np.interp(chis, [chi1, chi_bar, chi2],
                  [mix["z_lo"], mix["z_mid"], mix["z_hi"]])
    ra, dec = _sky(rng, n)
    return dict(ra=ra, dec=dec, M=M, z=z)


_CATALOGS = {"mass_function": _mass_function_catalog}


def _map(mix, rng, nside):
    if mix["map"] != "exponential":
        raise ValueError(f"unknown map kind {mix['map']!r}")
    return rng.exponential(1.0, 12 * nside * nside)


def make_shells(mix, nside, seed):
    """The mix's ``shells`` (catalog, map) pairs for ``seed``: a list of
    dicts with float64 numpy arrays ra, dec [deg], M [Msun], z and map
    (12 nside^2 pixels). Shell j draws from the generator seeded with
    (seed, j)."""
    make = _CATALOGS[mix["catalog"]]
    out = []
    for j in range(int(mix["shells"])):
        rng = np.random.default_rng([int(seed) % (1 << 63), j])
        shell = make(mix, rng)
        shell["map"] = _map(mix, rng, nside)
        out.append(shell)
    return out


def halo_count(shell):
    return int(shell["M"].size)
