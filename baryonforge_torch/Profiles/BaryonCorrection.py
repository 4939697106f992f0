"""Displacement model: Baryonification2D / Baryonification3D.

Port of ``baryonforge_tpu.Profiles.BaryonCorrection``. The table build
(``setup_interpolator``) evaluates the DMO and DMB profiles in plain torch
on the model's device, one redshift after the other, and turns them into
table rows with kernel K9 (``ops/table_rows.py``: the enclosed-mass curves
and their inversion) on CUDA, or its plain versions on the CPU. The table
half reads the table back: ``displacement``, the per-halo curves the
runners use (``halo_curves``, kernel K1 on CUDA) and the checkpoint
(``save_table`` / ``load_table``).
"""

import copy
import warnings
from itertools import product

import numpy as np
import torch

from ..cosmo import massdef as _massdef
from ..ops.interp import multilinear_interp, collapse_curves
from ..ops import table_rows
from ..utils.Tabulate import _set_parameter

__all__ = ["BaryonificationClass", "Baryonification3D", "Baryonification2D"]


class BaryonificationClass:
    """Base displacement-function model (reference BaryonCorrection.py:15).

    ``DMO`` and ``DMB`` are the dark-matter-only and baryonified profiles
    (their cutoffs are set to 1 Gpc); they are needed to build a table, and
    may be ``None`` for a model whose table comes from :meth:`load_table`
    or ``utils.convert.baryonification_from_jax``. ``device`` is where
    :meth:`setup_interpolator` runs: "cuda" (the default; it raises there
    without a card) or "cpu". The table itself lives on the CPU in float64;
    :meth:`with_dtype` makes the copy a runner reads on its device.
    """

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
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

    # ------------------------------------------------------------------
    def get_masses(self, model, r, M, a):
        raise NotImplementedError("Implement a get_masses() method first")

    def _enclosed_mass_curve(self, model, r, M, a, projected):
        """Enclosed mass (len M, len r) of ``model`` at radii ``r`` (host
        values): the profile on a padded log grid of N_int points (numpy
        float64, as the JAX package builds it), the clipped integrand, and
        K9's first entry (cumulative Simpson, rho > 0 mask, log-log PCHIP);
        NaN outside a row's valid range."""
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
        return table_rows.enclosed_mass(
            intgd.contiguous(), dens.contiguous(), torch.log(r_int),
            torch.log(torch.as_tensor(r, device=dev)))

    def _check_device(self):
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: device='cuda' but CUDA is not "
                "available; pass device='cpu' for the plain versions")

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
        redshift, K9 twice for the enclosed masses (DMO, DMB), once for the
        displacement rows, and the TwoHalo terms' FFTLog (K8).
        """
        self._check_device()
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
        lnr = torch.log(torch.as_tensor(r, device=self.device))

        combos = list(product(*[range(v.size) for v in p_vals])) or [()]
        for c in combos:
            for ki, key in enumerate(p_keys):
                _set_parameter(self.DMO, key, p_vals[ki][c[ki]])
                _set_parameter(self.DMB, key, p_vals[ki][c[ki]])
            for j in range(z_range.size):
                a_j = float(a_range[j])
                M_DMO = self._enclosed_mass_curve(
                    self.DMO, r, M_range, a_j, projected=self._projected)
                M_DMB = self._enclosed_mass_curve(
                    self.DMB, r, M_range, a_j, projected=self._projected)
                offset = table_rows.displacement_rows(lnr, M_DMO, M_DMB) \
                    .cpu().numpy()

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

        input_rad = np.log(rdelta_range) if Rdelta_sampling else np.log(r)
        return self._set_table(d_interp, np.log(1 + z_range),
                               np.log(M_range), input_rad, p_keys, p_vals,
                               Rdelta_sampling)

    # ------------------------------------------------------------------
    def _set_table(self, d, z_range, M_range, r_range, p_keys, p_vals,
                   Rdelta_sampling):
        self.raw_input_d = np.asarray(d)
        self.raw_input_z_range = np.asarray(z_range)
        self.raw_input_M_range = np.asarray(M_range)
        self.raw_input_r_range = np.asarray(r_range)
        self.p_keys = list(p_keys)
        for k, v in zip(self.p_keys, p_vals):
            setattr(self, f"raw_input_{k}_range", np.asarray(v))
        axes = [self.raw_input_z_range, self.raw_input_M_range,
                self.raw_input_r_range] + [np.asarray(v) for v in p_vals]
        self._axes = tuple(torch.as_tensor(x, dtype=torch.float64)
                           for x in axes)
        self._table = torch.as_tensor(self.raw_input_d, dtype=torch.float64)
        self.Rdelta_sampling = bool(Rdelta_sampling)
        return self

    def save_table(self, path):
        """Checkpoint the displacement table to ``path`` (.npz), in the
        format of the JAX package's ``save_table``."""
        extras = {f"p_{k}": getattr(self, f"raw_input_{k}_range")
                  for k in self.p_keys}
        np.savez(path, d=self.raw_input_d,
                 z_range=self.raw_input_z_range,
                 M_range=self.raw_input_M_range,
                 r_range=self.raw_input_r_range,
                 p_keys=np.array(self.p_keys, dtype=object),
                 Rdelta_sampling=np.array(self.Rdelta_sampling),
                 allow_pickle=True, **extras)

    def load_table(self, path):
        """Restore a table saved with :meth:`save_table` (either package's).
        The file holds a pickled object array (``p_keys``): load only
        files this program or the JAX package wrote."""
        with np.load(path, allow_pickle=True) as f:
            p_keys = [str(k) for k in f["p_keys"]]
            return self._set_table(f["d"], f["z_range"], f["M_range"],
                                   f["r_range"], p_keys,
                                   [f[f"p_{k}"] for k in p_keys],
                                   f["Rdelta_sampling"])

    def with_dtype(self, dtype, device=None):
        """Shallow copy with the lookup table cast to ``dtype`` (and moved to
        ``device`` when given): the runners read the table in their
        deposit dtype, float32 by default."""
        new = copy.copy(self)
        dev = self._table.device if device is None else torch.device(device)
        new._axes = tuple(x.to(device=dev, dtype=dtype) for x in self._axes)
        new._table = self._table.to(device=dev, dtype=dtype)
        return new

    def _readout(self, r, M, a, **kwargs):
        dt, dev = self._table.dtype, self._table.device
        r_use = torch.atleast_1d(torch.as_tensor(r, dtype=dt, device=dev))
        M_use = torch.atleast_1d(torch.as_tensor(M, dtype=dt, device=dev))
        nM, nr = M_use.numel(), r_use.numel()

        R = (self.mass_def.get_radius(self.cosmo, M_use, a) / a).to(
            device=dev, dtype=dt)
        lnr_in = torch.log(r_use)[None, :]
        if self.Rdelta_sampling:
            lnr_in = lnr_in - torch.log(R)[:, None]
        a_t = torch.as_tensor(a, dtype=torch.float64)
        cols = [torch.log(1.0 / a_t).to(device=dev, dtype=dt)
                .expand(nM, nr).reshape(-1),
                torch.log(M_use)[:, None].expand(nM, nr).reshape(-1),
                lnr_in.expand(nM, nr).reshape(-1)]
        for k in self.p_keys:
            cols.append(torch.as_tensor(kwargs[k], dtype=dt, device=dev)
                        .expand(nM, nr).reshape(-1))
        pts = torch.stack(cols, dim=1)
        displ = multilinear_interp(self._axes, self._table, pts)
        displ = displ.reshape(nM, nr)
        displ = torch.where(torch.isfinite(displ), displ,
                            torch.zeros_like(displ))
        inside = r_use[None, :] < self.epsilon_max * R[:, None]
        displ = torch.where(inside, displ, torch.zeros_like(displ))
        if np.ndim(r) == 0:
            displ = displ.squeeze(-1)
        if np.ndim(M) == 0:
            displ = displ.squeeze(0)
        return displ

    def displacement(self, r, M, a, **kwargs):
        """Displacement d(r, M, a) in comoving Mpc (table readout only)."""
        if not hasattr(self, "_table"):
            raise NameError("No table. Run setup_interpolator() or load_table() "
                            "first")
        for k in self.p_keys:
            if k not in kwargs:
                raise ValueError(f"need {k} as input (table built with it)")
        return self._readout(r, M, a, **kwargs)

    # per-halo curves are RAW displacement values (not log); runners pick
    # the matching lookup via this flag
    curves_are_log = False

    def halo_curves(self, M, a, **kwargs):
        """Per-halo displacement curves d_h(ln r) on the table's radial grid:
        (z, M[, p...]) are constant per halo, so they are interpolated once
        here and the per-pixel readout becomes a log-uniform 1-D lerp
        (:meth:`curve_lookup`). Runs kernel K1 when the table is on CUDA.

        Returns (curves (n_halos, n_r), ln_r0, dlnr); out-of-table rows are
        zero. With ``Rdelta_sampling`` the radial coordinate is
        ln(r/R_Delta).
        """
        return collapse_curves(self._table, self._axes, 2, M, a,
                               self.p_keys, kwargs, fill=0.0)

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


class Baryonification3D(BaryonificationClass):
    """3D displacement: invert 3D enclosed-mass curves
    (reference BaryonCorrection.py:464-578)."""

    _projected = False

    def get_masses(self, model, r, M, a):
        self._check_device()
        out = self._enclosed_mass_curve(model, r, M, a, projected=False)
        return out.cpu().numpy()


class Baryonification2D(BaryonificationClass):
    """2D displacement: invert projected enclosed-mass curves
    M(<R) = ∫ 2 pi R Sigma(R) a dlnR (reference BaryonCorrection.py:
    581-694)."""

    _projected = True

    def get_masses(self, model, r, M, a):
        self._check_device()
        out = self._enclosed_mass_curve(model, r, M, a, projected=True)
        return out.cpu().numpy()
