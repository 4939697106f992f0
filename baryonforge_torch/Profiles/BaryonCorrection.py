"""Displacement model: Baryonification2D / Baryonification3D (table half).

Port of ``baryonforge_tpu.Profiles.BaryonCorrection``: the table readout
(``displacement``), the per-halo curves the runners use (``halo_curves``,
kernel K1 on CUDA) and the table checkpoint (``save_table`` /
``load_table``). Building a table from profiles (``setup_interpolator``)
needs the profile physics, which is not ported yet.
"""

import copy

import numpy as np
import torch

from ..cosmo import massdef as _massdef
from ..ops.interp import multilinear_interp, collapse_curves

__all__ = ["BaryonificationClass", "Baryonification3D", "Baryonification2D"]


class BaryonificationClass:
    """Base displacement-function model (reference BaryonCorrection.py:15).

    ``DMO`` and ``DMB`` are the dark-matter-only and baryonified profiles;
    they are only needed to build a table, so until the profiles are
    ported they may be ``None`` (a table then comes from
    :meth:`load_table` or ``utils.convert.baryonification_from_jax``).
    The table lives on the CPU in float64; :meth:`with_dtype` makes the
    copy a runner reads on its device.
    """

    def __init__(self, DMO, DMB, cosmo, epsilon_max=20,
                 mass_def=_massdef.MassDef200c,
                 r_min_int=1e-6, r_max_int=1000, N_int=500):
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

    def setup_interpolator(self, *args, **kwargs):
        raise NotImplementedError(
            "building the displacement table needs the profile physics: "
            "ROADMAP Queue 1 item 9 (S19 table build). Load a table with "
            "load_table() instead")

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
            raise NameError("No table. Load one with load_table() first")
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


class Baryonification2D(BaryonificationClass):
    """2D displacement: invert projected enclosed-mass curves
    (reference BaryonCorrection.py:581-694)."""

    _projected = True
