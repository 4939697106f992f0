"""Displacement model: Baryonification2D, the table build.

A frozen copy of the plain (CPU) version in
``baryonforge_torch/Profiles/BaryonCorrection.py`` at the commit that added
the benchmark, with the kernel wrappers and the table's readout left out:
the benchmark's reference, which imports nothing of the program and is not
edited with it. The table rows (enclosed masses and their inversion) are
computed in ``rows_dtype``, float64 unless a control asks for less.
"""

import warnings
from itertools import product

import numpy as np
import torch

from . import massdef as _massdef
from . import table_rows
from .tabulate import _set_parameter

__all__ = ["BaryonificationClass", "Baryonification2D"]


class BaryonificationClass:
    """Base displacement-function model (reference BaryonCorrection.py:15):
    ``DMO`` and ``DMB`` are the dark-matter-only and baryonified profiles
    (their cutoffs are set to 1 Gpc). The table is built on ``device`` and
    kept on the CPU in float64 (``raw_input_d`` and its axes)."""

    rows_dtype = torch.float64

    def __init__(self, DMO, DMB, cosmo, epsilon_max=20,
                 mass_def=_massdef.MassDef200c,
                 r_min_int=1e-6, r_max_int=1000, N_int=500, device="cuda"):
        self.DMO = DMO
        self.DMB = DMB
        for prof in (DMO, DMB):
            if prof is not None:
                prof.set_parameter('cutoff', 1000)
        self.cosmo = cosmo
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def
        self.r_min_int = r_min_int
        self.r_max_int = r_max_int
        self.N_int = N_int
        self.device = torch.device(device)

    def _profile_rows(self, model, r, M, a, projected):
        """The table rows' inputs for ``model`` at radii ``r`` (host values): the
        profile on a padded log grid of N_int points (numpy float64, as the
        JAX package builds it), and (intgd, dens, lnr_int, lnr): the
        clipped integrand and density (len M, N_int), the grid's and the
        radii's logs, on the model's device."""
        r = np.asarray(r, dtype=float)
        r_min = min(float(r.min()), self.r_min_int)
        r_max = max(float(r.max()), self.r_max_int)
        r_int_np = np.geomspace(r_min / 1.2, r_max * 1.2, self.N_int)
        dev = self.device
        r_int = torch.as_tensor(r_int_np, device=dev)
        dlnr = float(np.log(r_int_np[1] / r_int_np[0]))

        M_use = torch.atleast_1d(torch.as_tensor(
            np.asarray(M, dtype=np.float64), device=dev))
        if projected:
            dens = model.projected(self.cosmo, r_int_np, M_use, a) * a
            dens = torch.atleast_2d(dens)
            intgd = 2 * np.pi * r_int ** 2 * dens * dlnr
        else:
            dens = model.real(self.cosmo, r_int_np, M_use, a)
            dens = torch.atleast_2d(dens)
            intgd = 4 * np.pi * r_int ** 3 * dens * dlnr
        zero = torch.zeros_like(dens)
        dens = torch.where(dens < 0, zero, dens)
        intgd = torch.where(intgd < 0, zero, intgd)
        return (intgd.contiguous(), dens.contiguous(), torch.log(r_int),
                torch.log(torch.as_tensor(r, device=dev)))

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           z_linear_sampling=False,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           Rdelta_min=1e-3, Rdelta_max=10,
                           Rdelta_sampling=False,
                           other_params=None, verbose=True):
        """Build the (z, M, r[, p...]) displacement table.

        Grids: M and r geometric, z geometric (or linear with
        ``z_linear_sampling``); ``other_params`` maps parameter names to
        value lists, each an extra table axis (p_keys) set on DMO and DMB
        before their rows are built. With ``Rdelta_sampling`` the radial
        axis is r / R_Delta on [Rdelta_min, Rdelta_max]. Rows whose
        inversion fails (too few usable points) give d = 0 with a
        UserWarning when ``verbose``. Runs on ``self.device``: per
        redshift, the rows (both enclosed masses and their inversion) in
        ``rows_dtype``, and the TwoHalo terms' FFTLog.
        """
        if self.DMO is None or self.DMB is None:
            raise ValueError("setup_interpolator needs the DMO and DMB "
                             "profiles")
        other_params = other_params or {}
        if z_min <= 0 and not z_linear_sampling:
            raise ValueError("need z_linear_sampling for z_min <= 0")

        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z)
                   if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))
        a_range = 1.0 / (1.0 + z_range)
        p_keys = list(other_params.keys())
        p_vals = [np.asarray(other_params[k]) for k in p_keys]
        if Rdelta_sampling:
            rdelta_range = np.geomspace(Rdelta_min, Rdelta_max, N_samples_R)

        d_interp = np.zeros([z_range.size, M_range.size, r.size]
                            + [v.size for v in p_vals])
        combos = list(product(*[range(v.size) for v in p_vals])) or [()]
        for c in combos:
            for ki, key in enumerate(p_keys):
                _set_parameter(self.DMO, key, p_vals[ki][c[ki]])
                _set_parameter(self.DMB, key, p_vals[ki][c[ki]])
            for j in range(z_range.size):
                a_j = float(a_range[j])
                i_o, d_o, lnr_int, lnr = self._profile_rows(
                    self.DMO, r, M_range, a_j, projected=self._projected)
                i_b, d_b = self._profile_rows(
                    self.DMB, r, M_range, a_j, projected=self._projected)[:2]
                dt = self.rows_dtype
                offset = table_rows.displacement_table_plain(
                    i_o.to(dt), d_o.to(dt), i_b.to(dt), d_b.to(dt),
                    lnr_int.to(dt), lnr.to(dt)).double().cpu().numpy()

                bad = ~np.isfinite(offset).any(axis=-1)
                offset = np.where(np.isfinite(offset), offset, 0.0)
                if bad.any() and verbose:
                    for i in np.where(bad)[0]:
                        warnings.warn(
                            f"Displacement for log10(M) = "
                            f"{np.log10(M_range[i]):.2f} partially failed; "
                            "affected radii default to d = 0.", UserWarning)

                if Rdelta_sampling:
                    for i in range(M_range.size):
                        Rdelta = float(self.mass_def.get_radius(
                            self.cosmo, M_range[i], a_range[j])) / a_range[j]
                        offset[i] = np.interp(rdelta_range, r / Rdelta,
                                              offset[i])

                d_interp[tuple([j, slice(None), slice(None)] + list(c))] = \
                    offset

        self.raw_input_d = d_interp
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = (np.log(rdelta_range) if Rdelta_sampling
                                  else np.log(r))
        return self

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """1-D log-uniform lookup of per-halo curves at radii ``r`` (comoving
        Mpc, or r/R_Delta if the table is Rdelta-sampled). ``curve`` is
        (..., n_r) and ``r`` is (..., K) with the same leading shape; the
        result is (..., K). Zero outside the tabulated range."""
        n_r = curve.shape[-1]
        x = (torch.log(torch.clamp(r, min=1e-30)) - ln_r0) / dlnr
        i = torch.clamp(torch.floor(x).to(torch.int64), 0, n_r - 2)
        t = x - i
        out = (torch.gather(curve, -1, i) * (1 - t)
               + torch.gather(curve, -1, i + 1) * t)
        return torch.where((x < 0) | (x > n_r - 1), torch.zeros_like(out),
                           out)


class Baryonification2D(BaryonificationClass):
    """2D displacement: invert projected enclosed-mass curves
    M(<R) = ∫ 2 pi R Sigma(R) a dlnR (reference BaryonCorrection.py:
    581-694)."""

    _projected = True
