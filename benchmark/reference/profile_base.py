"""Profile framework base class.

A frozen copy of ``baryonforge_torch/Profiles/Base.py`` (and of
``utils/misc.py``'s ``combine_fftpars``) at the commit that added the
benchmark: the benchmark's reference, which imports nothing of the program
and is not edited with it.

Profiles are light Python objects holding scalar parameters; ``_real``
evaluates a (M, r) grid of float64 tensors. The entry points ``real``,
``projected`` and ``fourier`` run on the device of ``r`` when it is a
tensor, else on that of ``M`` when it is one, else on CUDA (and raise
without a card): pass CPU tensors to run on the CPU. Integration grids that
depend on r are built from r's values on the host, in numpy float64, as the
JAX package builds them.

Conventions of the reference kept here:
  * inputs r [comoving Mpc], M [Msun], a; outputs mirror the input ranks
  * the sigmoid large-r cutoff 1/(1+exp(2(r - cutoff))), overflow-guarded
  * the concentration chain cdelta -> c_M_relation -> Diemer15, with
    non-finite c set to 1
  * ``projected`` is a real-space line-of-sight integral bounded by
    ``proj_cutoff`` unless ``use_fftlog_projection``
"""

import math
import operator
import warnings

import numpy as np
import torch

from . import massdef as _massdef
from . import concentration as _conc
from .grids import jnp_linspace
from .integrate import trapz

__all__ = ["Profile", "hyper_params", "generate_operator_method",
           "resolve_device"]

hyper_params = ["mass_def", "c_M_relation", "use_fftlog_projection",
                "padding_lo_proj", "padding_hi_proj", "n_per_decade_proj",
                "r_min_int", "r_max_int", "r_steps", "xi_mm"]

# how profile algebra merges two operands' hyper parameters (the
# reference's utils/misc.py:261-336 table): grid and integration knobs take
# the superset of both operands' needs; identity-like knobs have no rule,
# and the first operand's value stays, with a warning when they differ
_hyper_merge_logic = {
    "padding_lo_proj": min,
    "padding_hi_proj": max,
    "n_per_decade_proj": max,
    "r_min_int": min,
    "r_max_int": max,
    "r_steps": max,
    "mass_def": None,
    "c_M_relation": None,
    "use_fftlog_projection": None,
    "xi_mm": None,
}

_DEFAULT_FFT_PRECISION = dict(
    plaw_fourier=-2.0,
    padding_lo_fftlog=1e-2, padding_hi_fftlog=1e2,
    padding_lo_extra=1e-4, padding_hi_extra=1e4,
    n_per_decade=64,
)


_FFT_PRECISION_LOGIC = {
    "plaw_fourier": min,
    "padding_lo_fftlog": min,
    "padding_lo_extra": min,
    "padding_hi_fftlog": max,
    "padding_hi_extra": max,
    "n_per_decade": max,
}


def combine_fftpars(pars_a, pars_b):
    """Merge two FFTLog precision dicts with per-key min/max rules."""
    out = dict(pars_a)
    for k, v in pars_b.items():
        if k in out and out[k] is not None and v is not None:
            rule = _FFT_PRECISION_LOGIC.get(k)
            out[k] = rule(out[k], v) if rule else out[k]
        elif v is not None:
            out[k] = v
        elif k in out:
            warnings.warn(f"FFT parameter {k} is None in one operand; "
                          "keeping the defined value")
    return out


def resolve_device(*xs):
    """The device of the first tensor among ``xs``, else CUDA (which must
    be available: there is no silent move to the CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("profiles run on CUDA unless given CPU tensors, "
                           "and CUDA is not available; pass r (or M) as a "
                           "CPU tensor for the CPU")
    return torch.device("cuda")


def _f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _host(x):
    """Host float64 numpy values of r (a tensor, array or number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def _ndim(x):
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _atleast_1d_pair(r, M, device):
    return (torch.atleast_1d(_f64(r, device)),
            torch.atleast_1d(_f64(M, device)))


def _halo_radius(prof, cosmo, M_use, a):
    """R_Delta in comoving Mpc, on M's device."""
    return (prof.mass_def.get_radius(cosmo, M_use, a) / a).to(M_use.device)


def _per_halo_loggrid(r_min, R, steps):
    """geomspace(r_min, R_i, steps) a halo, shape (M, steps), in the JAX
    package's arithmetic (exp of a jnp.linspace in ln r)."""
    t = torch.as_tensor(jnp_linspace(0.0, 1.0, steps), device=R.device)
    return torch.exp(math.log(r_min)
                     + (torch.log(R)[:, None] - math.log(r_min)) * t[None, :])


def _mirror_dims(prof, r, M):
    """Squeeze the output axes of scalar inputs (reference convention)."""
    if _ndim(r) == 0:
        prof = prof.squeeze(-1)
    if _ndim(M) == 0:
        prof = prof.squeeze(0)
    return prof


def sigmoid_cutoff(r_use, cutoff):
    """kfac = 1 / (1 + exp(2 (r - cutoff))), overflow-guarded."""
    c = 1e3 if cutoff is None else cutoff
    arg = r_use - c
    arg = torch.where(arg > 30.0, torch.full_like(arg, math.inf), arg)
    return 1.0 / (1.0 + torch.exp(2.0 * arg))


class Profile:
    """Base halo profile: real / projected / fourier and its parameters."""

    model_param_names = []
    hyper_param_names = hyper_params
    # whether ``_real`` also takes radii of each halo's own, r (M, L)
    # against M (M,): true of the profiles that are elementwise in r
    per_halo_r = False

    def __init__(self, mass_def=_massdef.MassDef200c, c_M_relation=None,
                 use_fftlog_projection=False, padding_lo_proj=0.1,
                 padding_hi_proj=10.0, n_per_decade_proj=10,
                 r_min_int=1e-6, r_max_int=1e3, r_steps=500,
                 xi_mm=None, **kwargs):
        # parameter auto-init (reference Base.py:70-78): slope parameters
        # (mu_/nu_/zeta_) default to 0, mass pivots (M_*) to 1e14, the rest
        # to None
        for m in self.model_param_names:
            if m in kwargs:
                setattr(self, m, kwargs[m])
            elif ("mu_" in m) or ("nu_" in m) or ("zeta_" in m):
                setattr(self, m, 0)
            elif "M_" in m:
                setattr(self, m, 1e14)
            else:
                setattr(self, m, None)

        self.mass_def = mass_def
        self.c_M_relation = (c_M_relation(mass_def=mass_def)
                             if c_M_relation is not None else None)
        self._c_M_relation = c_M_relation

        self.padding_lo_proj = padding_lo_proj
        self.padding_hi_proj = padding_hi_proj
        self.n_per_decade_proj = n_per_decade_proj
        self.r_min_int = r_min_int
        self.r_max_int = r_max_int
        self.r_steps = r_steps
        self.xi_mm = xi_mm

        self.cutoff = kwargs.get("cutoff", 1e3)
        self.proj_cutoff = kwargs.get("proj_cutoff", self.cutoff)

        self._use_fftlog_projection = use_fftlog_projection
        if use_fftlog_projection and self.cutoff != self.proj_cutoff:
            raise ValueError("fftlog projection requires cutoff == "
                             f"proj_cutoff (got {self.cutoff} vs "
                             f"{self.proj_cutoff})")

        self.precision_fftlog = dict(_DEFAULT_FFT_PRECISION)

    # ------------------------------------------------------------------
    # parameter views / mutation
    # ------------------------------------------------------------------
    @property
    def model_params(self):
        return {k: v for k, v in vars(self).items()
                if k in self.model_param_names}

    @property
    def hyper_params(self):
        params = {k: v for k, v in vars(self).items()
                  if k in self.hyper_param_names}
        params["c_M_relation"] = self._c_M_relation
        params["use_fftlog_projection"] = self._use_fftlog_projection
        return params

    def set_parameter(self, key, value):
        from .tabulate import _set_parameter
        _set_parameter(self, key, value)

    def update_precision_fftlog(self, **pars):
        """Update the FFTLog knobs here and on every nested profile."""
        self.precision_fftlog.update(pars)
        for v in vars(self).values():
            if isinstance(v, Profile):
                v.update_precision_fftlog(**pars)

    def _get_concentration(self, cosmo, M_use, a):
        cdelta = getattr(self, "cdelta", None)
        if (cdelta is None) and (self.c_M_relation is None):
            rel = _conc.ConcentrationDiemer15(mass_def=self.mass_def)
        elif self.c_M_relation is not None:
            rel = self.c_M_relation
        else:
            rel = _conc.ConcentrationConstant(c=cdelta,
                                              mass_def=self.mass_def)
        c = rel(cosmo, M_use, a).to(M_use.device)
        return torch.where(torch.isfinite(c), c, torch.ones_like(c))

    # ------------------------------------------------------------------
    # evaluation entry points
    # ------------------------------------------------------------------
    def _real(self, cosmo, r, M, a):
        raise NotImplementedError

    def real(self, cosmo, r, M, a, **kwargs):
        r_use, M_use = _atleast_1d_pair(r, M, resolve_device(r, M))
        prof = self._real(cosmo, r_use, M_use, a, **kwargs)
        return _mirror_dims(prof, r, M)

    # -- projection ------------------------------------------------------
    def _projection_grids(self, r):
        """Line-of-sight grids (numpy float64) from r's host values."""
        r_np = np.atleast_1d(_host(r))
        int_min = self.padding_lo_proj * float(r_np.min())
        int_max = self.padding_hi_proj * float(r_np.max())
        if self.proj_cutoff is not None:
            int_max = max(self.proj_cutoff, int_max)
        r_max = self.proj_cutoff if self.proj_cutoff is not None else \
            (self.cutoff if self.cutoff is not None else 1e4)
        # sized after the cutoff extension, with the decade count rounded
        # up (as the JAX package; the reference sizes the grid before)
        span = max(int_max, r_max) / int_min
        int_N = max(int(self.n_per_decade_proj * np.ceil(np.log10(span))),
                    4 * self.n_per_decade_proj)
        return (np.geomspace(int_min, int_max, int_N),
                np.geomspace(int_min, r_max, int_N))

    def _projected_realspace(self, cosmo, r, M, a, **kwargs):
        """Sigma(R) = 2 ∫ rho(sqrt(R^2 + l^2)) dl on a fixed log grid: one
        evaluation over (M, R, l) with the density taken exactly at the
        line-of-sight points, integrated in ln l, plus the rectangle
        2 l_0 rho(R) of the [0, l_0] segment the grid leaves out."""
        dev = resolve_device(r, M)
        r_use, M_use = _atleast_1d_pair(r, M, dev)
        _, r_proj_np = self._projection_grids(r)
        r_proj = torch.as_tensor(r_proj_np, device=dev)
        s = torch.sqrt(r_proj[None, :] ** 2 + r_use[:, None] ** 2)
        vals = self._real(cosmo, s.reshape(-1), M_use, a, **kwargs)
        vals = vals.reshape(M_use.numel(), r_use.numel(), r_proj.numel())
        proj = 2.0 * trapz(vals * r_proj[None, None, :],
                           torch.log(r_proj)[None, None, :])
        return proj + 2.0 * r_proj[0] * vals[..., 0]

    def _projected(self, cosmo, r, M, a, **kwargs):
        if self._use_fftlog_projection:
            raise NotImplementedError("the reference keeps the real-space "
                                      "projection only")
        return self._projected_realspace(cosmo, r, M, a, **kwargs)

    def projected(self, cosmo, r, M, a, **kwargs):
        prof = self._projected(cosmo, r, M, a, **kwargs)
        return _mirror_dims(prof, r, M)

    # ------------------------------------------------------------------
    # pretty-printing (reference Base.py:269-298)
    # ------------------------------------------------------------------
    def __str_par__(self):
        return "(" + ", ".join(f"{m} = {getattr(self, m)}"
                               for m in self.model_param_names) + ")"

    def __str_prf__(self):
        return self.__class__.__name__

    def __str__(self):
        return self.__str_prf__() + self.__str_par__()

    __repr__ = __str__


# ---------------------------------------------------------------------------
# Profile algebra (reference utils/misc.py:9-154)
# ---------------------------------------------------------------------------
class _CombinedProfile(Profile):
    """A profile made of an operator over one or two profiles (or a
    profile and a number)."""

    def __init__(self, op, A, B=None, reflect=False):
        self._op = op
        self._A = A
        self._B = B
        self._reflect = reflect

        base = A if isinstance(A, Profile) else B
        names = set()
        for x in (A, B):
            if isinstance(x, Profile):
                names |= set(x.model_param_names)
        self.model_param_names = sorted(names)

        hp = dict(base.hyper_params)
        if isinstance(A, Profile) and isinstance(B, Profile):
            for k, vb in B.hyper_params.items():
                va = hp.get(k)
                if va is None:
                    hp[k] = vb
                    continue
                if vb is None:
                    continue
                rule = _hyper_merge_logic.get(k)
                if rule is not None:
                    try:
                        hp[k] = rule(va, vb)
                    except TypeError:     # values that do not compare
                        pass
                else:
                    differ = va is not vb
                    try:
                        differ = differ and bool(va != vb)
                    except (TypeError, ValueError, RuntimeError):
                        pass              # array-valued or odd __eq__
                    if differ:
                        warnings.warn(
                            f"hyper parameter {k} differs between "
                            f"combined profiles ({va!r}, {vb!r}); using "
                            "the first operand's value")
        mp = {}
        for x in (A, B):
            if isinstance(x, Profile):
                for k, v in x.model_params.items():
                    if k not in mp or mp[k] is None:
                        mp[k] = v
        super().__init__(**{**mp, **hp})

        # the operands' FFTLog precision, merged (reference
        # utils/misc.py:68-126)
        fp = None
        for x in (A, B):
            if isinstance(x, Profile):
                fp = (dict(x.precision_fftlog) if fp is None
                      else combine_fftpars(fp, x.precision_fftlog))
        if fp is not None:
            self.precision_fftlog = fp

    def _real(self, cosmo, r, M, a, **kw):
        A = (self._A._real(cosmo, r, M, a, **kw)
             if isinstance(self._A, Profile) else self._A)
        if self._B is None:
            return self._op(A)
        B = (self._B._real(cosmo, r, M, a, **kw)
             if isinstance(self._B, Profile) else self._B)
        return self._op(B, A) if self._reflect else self._op(A, B)

    @property
    def per_halo_r(self):
        return all(x.per_halo_r for x in (self._A, self._B)
                   if isinstance(x, Profile))

    def set_parameter(self, key, value):
        from .tabulate import _set_parameter
        for x in (self._A, self._B):
            if isinstance(x, Profile):
                _set_parameter(x, key, value)
        if key in vars(self):
            setattr(self, key, value)

    def __str_prf__(self):
        name = getattr(self._op, "__name__", str(self._op))
        if self._B is None:
            return f"{name}[{self._A.__str_prf__()}]"

        def nm(x):
            return x.__str_prf__() if isinstance(x, Profile) else str(x)
        return f"{name}[{nm(self._A)}, {nm(self._B)}]"


def generate_operator_method(op, reflect=False):
    """An operator method that makes a combined profile (reference
    utils/misc.py:49-152)."""
    if op in (operator.abs, operator.pos, operator.neg):
        def _unary(self):
            return _CombinedProfile(op, self)
        return _unary

    def _binary(self, other):
        return _CombinedProfile(op, self, other, reflect=reflect)
    return _binary


Profile.__add__ = generate_operator_method(operator.add)
Profile.__mul__ = generate_operator_method(operator.mul)
Profile.__sub__ = generate_operator_method(operator.sub)
Profile.__truediv__ = generate_operator_method(operator.truediv)
Profile.__pow__ = generate_operator_method(operator.pow)
Profile.__radd__ = generate_operator_method(operator.add, reflect=True)
Profile.__rmul__ = generate_operator_method(operator.mul, reflect=True)
Profile.__rsub__ = generate_operator_method(operator.sub, reflect=True)
Profile.__rtruediv__ = generate_operator_method(operator.truediv,
                                                reflect=True)
Profile.__abs__ = generate_operator_method(operator.abs)
Profile.__pos__ = generate_operator_method(operator.pos)
Profile.__neg__ = generate_operator_method(operator.neg)
