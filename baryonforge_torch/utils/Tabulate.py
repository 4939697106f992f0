"""Recursive parameter plumbing over nested profiles, and the tabulated
profile adapters (port of ``baryonforge_tpu.utils.Tabulate``).

``TabulatedProfile`` and ``ParamTabulatedProfile`` evaluate a profile on a
(log(1+z), log M, log r[, p...]) grid once and read it back by multilinear
interpolation, or as per-halo radial curves for the runners
(``halo_curves``: kernel K1 on CUDA). The table is built on the device
given to the constructor ("cuda" by default; it raises there without a
card), and kept on the CPU in float64; :meth:`with_dtype` makes the copy a
runner reads on its device. ``TabulatedCorrelation3D`` tabulates the
linear matter correlation on a (z, ln r) grid for the two-halo ``xi_mm``
hook, one ``correlation_3d`` call (kernel K8 on CUDA) a redshift.
"""

from itertools import product

import numpy as np
import torch

__all__ = ["_set_parameter", "_get_parameter", "TabulatedProfile",
           "ParamTabulatedProfile", "TabulatedCorrelation3D"]


def _walk_profiles(obj, seen=None):
    """Yield obj and every nested Profile attribute, recursively."""
    from ..Profiles.Base import Profile
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    for v in vars(obj).values():
        if isinstance(v, Profile):
            yield from _walk_profiles(v, seen)


def _set_parameter(obj, key, value):
    """Set ``key`` on obj and every nested profile that defines it
    (reference Tabulate.py:11-64); True when any did."""
    found = False
    for o in _walk_profiles(obj):
        if key in vars(o):
            setattr(o, key, value)
            found = True
    return found


def _get_parameter(obj, key):
    """Read ``key`` from obj or the first nested profile that has it."""
    for o in _walk_profiles(obj):
        if key in vars(o):
            return getattr(o, key)
    raise AttributeError(f"parameter {key} not found on {obj}")


def _grids(z_min, z_max, N_samples_z, M_min, M_max, N_samples_Mass, R_min,
           R_max, N_samples_R, z_linear_sampling):
    """The table's z, M and r grids, in numpy as the JAX package makes
    them."""
    M_range = np.geomspace(M_min, M_max, N_samples_Mass)
    r = np.geomspace(R_min, R_max, N_samples_R)
    z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
               else np.geomspace(z_min, z_max, N_samples_z))
    return z_range, M_range, r


class _Tabulated:
    """What the two tabulated profiles share: the build loop, the copy in a
    runner's dtype and device, and the readout."""

    def __init__(self, model, cosmo, mass_def=None, device="cuda"):
        self.model = model
        self.cosmo = cosmo
        self.mass_def = mass_def if mass_def is not None else model.mass_def
        self.p_keys = []
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

    def _build(self, z_range, M_range, r, p_vals=()):
        """(tab3D, tab2D) numpy float64 of shape (z, M, r, p...): the
        model's real profile and its projection times a, evaluated on the
        table's device, each parameter combination set on the model
        first."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: device='cuda' but CUDA is not "
                "available; pass device='cpu'")
        dev = self.device
        r_t = torch.as_tensor(r, device=dev)
        M_t = torch.as_tensor(M_range, device=dev)
        shape = [z_range.size, M_range.size, r.size] + [v.size
                                                         for v in p_vals]
        tab3D = np.zeros(shape)
        tab2D = np.zeros(shape)
        combos = list(product(*[range(v.size) for v in p_vals])) or [()]
        for j, z in enumerate(z_range):
            a_j = 1.0 / (1.0 + z)
            for c in combos:
                for ki, k in enumerate(self.p_keys):
                    _set_parameter(self.model, k, p_vals[ki][c[ki]])
                idx = tuple([j, slice(None), slice(None)] + list(c))
                tab3D[idx] = self.model.real(self.cosmo, r_t, M_t,
                                             a_j).cpu().numpy()
                tab2D[idx] = (self.model.projected(self.cosmo, r_t, M_t, a_j)
                              * a_j).cpu().numpy()
        return tab3D, tab2D

    def _set_axes(self, axes, tab3D, tab2D):
        self._axes = tuple(torch.as_tensor(np.asarray(x), dtype=torch.float64)
                           for x in axes)
        self._tab3D = torch.as_tensor(tab3D, dtype=torch.float64)
        self._tab2D = torch.as_tensor(tab2D, dtype=torch.float64)

    def with_dtype(self, dtype, device=None):
        """Shallow copy with the tables and axes cast to ``dtype`` (and
        moved to ``device`` when given): the runners read them in their
        deposit dtype, float32 by default. The casts are kept per (dtype,
        device) until the tables are rebuilt (``ops.interp.cast_copy``), so
        they and their K1 set-ups serve every call."""
        from ..ops.interp import cast_copy
        dev = self._tab2D.device if device is None else torch.device(device)
        return cast_copy(self, ("_axes", "_tab3D", "_tab2D"), dtype, dev)

    def _readout(self, table, r, M, a, log, **kwargs):
        from ..ops.interp import multilinear_interp
        for k in self.p_keys:
            if k not in kwargs:
                raise ValueError(f"must provide {k} (table was built "
                                 "with it)")
        dt, dev = table.dtype, table.device
        r_use = torch.atleast_1d(torch.as_tensor(r, dtype=dt, device=dev))
        M_use = torch.atleast_1d(torch.as_tensor(M, dtype=dt, device=dev))
        nM, nr = M_use.numel(), r_use.numel()
        a_t = torch.as_tensor(a, dtype=dt, device=dev)
        cols = [torch.log(1.0 / a_t).expand(nM, nr).reshape(-1),
                torch.log(M_use)[:, None].expand(nM, nr).reshape(-1),
                torch.log(r_use)[None, :].expand(nM, nr).reshape(-1)]
        for k in self.p_keys:
            cols.append(torch.as_tensor(kwargs[k], dtype=dt, device=dev)
                        .expand(nM * nr))
        out = multilinear_interp(self._axes, table, torch.stack(cols, dim=1))
        if log:
            out = torch.exp(out)
        out = out.reshape(nM, nr)
        if np.ndim(r) == 0:
            out = out.squeeze(-1)
        if np.ndim(M) == 0:
            out = out.squeeze(0)
        return out

    def real(self, cosmo, r, M, a, **kwargs):
        return self._readout(self._tab3D, r, M, a, self.curves_are_log,
                             **kwargs)

    def projected(self, cosmo, r, M, a, **kwargs):
        # the table stores Sigma * a; divide the factor back out
        return self._readout(self._tab2D, r, M, a, self.curves_are_log,
                             **kwargs) / a

    def halo_curves(self, M, a, kind="projected", **kwargs):
        """Per-halo profile curves on the table's radial grid: the
        (z, M[, p...]) axes interpolated once per halo, so a runner's
        per-pixel readout is a log-uniform 1-D lookup (``curve_lookup``).
        Kernel K1 when the table is on CUDA.

        Returns (curves (n, n_r), ln_r0, dlnr), the last two as floats.
        ``projected`` curves hold
        Sigma * a (the runner divides the factor out), as logs for
        TabulatedProfile, whose out-of-table rows are -inf, and raw for
        ParamTabulatedProfile, whose out-of-table rows are 0."""
        from ..ops.interp import curve_table
        name = "_tab2D" if kind == "projected" else "_tab3D"
        return curve_table(self, name).collapse(
            M, a, kwargs, fill=-np.inf if self.curves_are_log else 0.0)


class TabulatedProfile(_Tabulated):
    """A profile precomputed on a (log(1+z), log M, log r) grid
    (reference Tabulate.py:99-392): log tables of ``real`` and of
    ``projected * a``, read back by multilinear interpolation."""

    # the curves are logs; the runners exp them in the lookup
    curves_are_log = True

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           z_linear_sampling=False, verbose=True,
                           other_params=None):
        """Evaluate the model at every (z, M, r) of the grids, on the
        table's device, and keep the logs."""
        if other_params:
            raise ValueError("use ParamTabulatedProfile for extra "
                             "parameter axes")
        z_range, M_range, r = _grids(z_min, z_max, N_samples_z, M_min, M_max,
                                     N_samples_Mass, R_min, R_max,
                                     N_samples_R, z_linear_sampling)
        tab3D, tab2D = self._build(z_range, M_range, r)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.raw_input_3D = np.log(tab3D)
            self.raw_input_2D = np.log(tab2D)
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = np.log(r)
        return self._set_tables()

    def _set_tables(self):
        self._set_axes((self.raw_input_z_range, self.raw_input_M_range,
                        self.raw_input_r_range), self.raw_input_3D,
                       self.raw_input_2D)
        return self

    def save_table(self, path):
        """Checkpoint the log tables to ``path`` (.npz), in the format of
        the JAX package's ``save_table``."""
        np.savez(path, tab3D=self.raw_input_3D, tab2D=self.raw_input_2D,
                 z_range=self.raw_input_z_range,
                 M_range=self.raw_input_M_range,
                 r_range=self.raw_input_r_range)

    def load_table(self, path):
        """Restore tables saved with :meth:`save_table` (either
        package's)."""
        with np.load(path) as f:
            self.raw_input_3D = f["tab3D"]
            self.raw_input_2D = f["tab2D"]
            self.raw_input_z_range = f["z_range"]
            self.raw_input_M_range = f["M_range"]
            self.raw_input_r_range = f["r_range"]
        return self._set_tables()

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """exp of the log curves' 1-D log-uniform lerp at radii ``r``;
        zero outside the tabulated range. ``curve`` (..., n_r) and ``r``
        (..., K) share their leading shape."""
        n_r = curve.shape[-1]
        x = (torch.log(torch.clamp(r, min=1e-30)) - ln_r0) / dlnr
        i = torch.clamp(torch.floor(x).to(torch.int64), 0, n_r - 2)
        t = x - i
        out = torch.exp(torch.gather(curve, -1, i) * (1 - t)
                        + torch.gather(curve, -1, i + 1) * t)
        return torch.where((x < 0) | (x > n_r - 1), torch.zeros_like(out),
                           out)


class ParamTabulatedProfile(_Tabulated):
    """A tabulated profile with extra parameter axes (reference
    Tabulate.py:395-730): raw (possibly signed) values, and ``p_keys``
    naming the per-halo properties the runners pass in."""

    # the curves are raw values
    curves_are_log = False

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           z_linear_sampling=False, other_params=None,
                           verbose=True):
        """Evaluate the model at every (z, M, r, p...) of the grids, each
        parameter combination set on the model first."""
        other_params = other_params or {}
        self.p_keys = list(other_params.keys())
        p_vals = [np.asarray(other_params[k]) for k in self.p_keys]
        z_range, M_range, r = _grids(z_min, z_max, N_samples_z, M_min, M_max,
                                     N_samples_Mass, R_min, R_max,
                                     N_samples_R, z_linear_sampling)
        tab3D, tab2D = self._build(z_range, M_range, r, p_vals)
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_M_range = np.log(M_range)
        self.raw_input_r_range = np.log(r)
        for k, v in zip(self.p_keys, p_vals):
            setattr(self, f"raw_input_{k}_range", v)
        self._set_axes([self.raw_input_z_range, self.raw_input_M_range,
                        self.raw_input_r_range] + p_vals, tab3D, tab2D)
        return self

    @staticmethod
    def curve_lookup(curve, ln_r0, dlnr, r):
        """The raw curves' 1-D log-uniform lookup (zero outside the
        range)."""
        from ..Profiles.BaryonCorrection import BaryonificationClass
        return BaryonificationClass.curve_lookup(curve, ln_r0, dlnr, r)


class TabulatedCorrelation3D:
    """(z, ln r) table of the linear matter correlation, for the TwoHalo
    ``xi_mm`` hook (reference Tabulate.py:733-785; JAX
    ``utils/Tabulate.py:324-346``).

    The table is built on ``device`` ("cuda" by default; it raises there
    without a card): one ``cosmo.correlation_3d`` call a redshift, each an
    FFTLog transform (kernel K8 on CUDA), kept in float64 on that device.
    A call ``xi(r, a)`` reads it by multilinear interpolation in (z, ln r),
    0 outside the table, and returns a float64 tensor on the device of
    ``r`` (a tensor's, else the table's): the port's ``TwoHalo`` calls it
    on its radii's device. The table is copied to another device once, at
    its first call there."""

    def __init__(self, cosmo, R_range=(1e-3, 3e2), N_samples_R=500,
                 z_range=(0.0, 6.0), N_samples_z=40, device="cuda"):
        from ..cosmo import correlation_3d
        dev = self._device(device)
        r = np.geomspace(R_range[0], R_range[1], N_samples_R)
        z = np.linspace(z_range[0], z_range[1], N_samples_z)
        r_t = torch.as_tensor(r, device=dev)
        tab = torch.stack([correlation_3d(cosmo, r_t, a=1.0 / (1 + zj))
                           for zj in z])
        self._set(torch.as_tensor(z, device=dev),
                  torch.as_tensor(np.log(r), device=dev), tab)

    @staticmethod
    def _device(device):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TabulatedCorrelation3D: device='cuda' but "
                               "CUDA is not available; pass device='cpu'")
        return dev

    @classmethod
    def from_arrays(cls, z, lnr, tab, device="cuda"):
        """The table from its arrays (z (Nz,), ln r (Nr,), xi (Nz, Nr)),
        as float64 on ``device``: ``utils.convert`` carries a JAX table
        across this way (to the CPU)."""
        dev = cls._device(device)
        new = object.__new__(cls)
        new._set(*(torch.as_tensor(np.array(x, dtype=np.float64),
                                   device=dev) for x in (z, lnr, tab)))
        return new

    def _set(self, z, lnr, tab):
        self._z, self._lnr, self._tab = z, lnr, tab
        self._copies = {z.device: (z, lnr, tab)}

    def _on(self, device):
        """(z, ln r, table) on ``device``, copied there at first use."""
        if device not in self._copies:
            # another thread may copy it too: the first copy stored is kept
            self._copies.setdefault(device, tuple(
                x.to(device) for x in (self._z, self._lnr, self._tab)))
        return self._copies[device]

    def __call__(self, r, a):
        from ..ops.interp import multilinear_interp
        if isinstance(r, torch.Tensor):
            r = r.to(torch.float64)
        else:
            r = torch.as_tensor(np.asarray(r, dtype=np.float64),
                                device=self._tab.device)
        z_ax, lnr_ax, tab = self._on(r.device)
        a = torch.as_tensor(a, dtype=torch.float64).to(r.device)
        z = 1.0 / a - 1.0
        pts = torch.stack([torch.broadcast_to(z, r.shape).reshape(-1),
                           torch.log(r).reshape(-1)], dim=1)
        out = multilinear_interp((z_ax, lnr_ax), tab, pts, fill_value=0.0)
        return out.reshape(r.shape)
