"""Concentration-mass relations and their remapping to other mass
definitions (port of ``baryonforge_tpu.cosmo.concentration``).

Each relation is a small frozen dataclass carrying its native mass
definition; calling it with (cosmo, M, a) gives c(M) as a float64 tensor
on M's device (the CPU for numbers and numpy arrays).

A frozen copy of ``baryonforge_torch/cosmo/concentration.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import math
from dataclasses import dataclass

import torch

from . import cosmo_core as core, power, massdef
from .interp import interp

__all__ = ["ConcentrationConstant", "ConcentrationDiemer15"]

_DELTA_C = 1.68647


@dataclass(frozen=True)
class _ConcentrationBase:
    mass_def: massdef.MassDef = massdef.MassDef200c

    def __call__(self, cosmo, M, a):
        return self._concentration(cosmo, torch.atleast_1d(core._f64(M)), a)


@dataclass(frozen=True)
class ConcentrationConstant(_ConcentrationBase):
    c: float = 5.0

    def _concentration(self, cosmo, M, a):
        return torch.full(M.shape, float(self.c), dtype=torch.float64,
                          device=M.device)


@dataclass(frozen=True)
class ConcentrationDiemer15(_ConcentrationBase):
    """Diemer & Kravtsov 2015 (median) for 200c:
    c = 0.5 c_min [(nu_min/nu)^alpha + (nu/nu_min)^beta], floor and scale
    set by the local slope n = dlnP/dlnk at kappa 2 pi / R_L."""
    kappa: float = 1.0
    phi_0: float = 6.58
    phi_1: float = 1.27
    eta_0: float = 7.28
    eta_1: float = 1.56
    alpha: float = 1.08
    beta: float = 1.77

    def _concentration(self, cosmo, M, a):
        R_L = power.lagrangian_radius(cosmo, M)
        k_R = 2.0 * math.pi / R_L * self.kappa
        n = power.dlnP_dlnk(cosmo, k_R)
        nu = _DELTA_C / power.sigmaM(cosmo, M, a)
        floor = self.phi_0 + n * self.phi_1
        nu0 = self.eta_0 + n * self.eta_1
        return 0.5 * floor * ((nu0 / nu) ** self.alpha
                              + (nu / nu0) ** self.beta)
