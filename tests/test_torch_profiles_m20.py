"""The Mead20 (HMx) profiles of the torch port against baryonforge_tpu:
real and projected of every class, the Fourier transforms the classes
override (and the DM's, as the JAX tests take it), the fractions and the
concentration modification, the ejected gas's escape radius (a root a halo
by safe_Pchip_minimize), Tagn2pars and profile_from_jax of the DMB profiles.

Both packages build the profiles from the T_AGN = 10^7.6 calibration, as
tests/test_profiles_m20.py, with proj_cutoff=100, and evaluate them on the
CPU (CPU tensors in the port). Each JAX output is computed once a module.
Tolerance: 1e-10 relative, with a floor at that fraction of the array's
largest value (tests/test_torch_profiles_s19.py; measured <= 5e-16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.Profiles import Mead20 as JM           # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.Profiles import Mead20 as TM         # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO_DICT                             # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-10
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
PAR = dict(JM.Params_TAGN_7p6_All, proj_cutoff=100)
M = np.array([3e12, 4e13, 8e14])
R = np.geomspace(2e-3, 3.0, 8)
K = np.geomspace(0.05, 20, 9)
A = 0.6
CLASSES = [c for c in TM.__all__ if c[0].isupper() and c != "MeadProfiles"
           and not c.startswith(("Params_", "Tagn"))]
FOURIER = ["DarkMatter", "DeltaStars", "GasAddDiffuse",
           "DarkMatterBaryonAddDiffuse", "PressureAddDiffuse"]


def t_(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for name in CLASSES:
        p = getattr(JM, name)(**PAR)
        out[name, "real"] = np.asarray(p.real(JCOSMO, R, jnp.asarray(M), A))
        out[name, "projected"] = np.asarray(
            p.projected(JCOSMO, R, jnp.asarray(M), A))
        if name in FOURIER:
            out[name, "fourier"] = np.asarray(
                p.fourier(JCOSMO, K, jnp.asarray(M), A))
    return out


@pytest.mark.parametrize("method", ["real", "projected"])
@pytest.mark.parametrize("name", CLASSES)
def test_matches_jax(jax_out, name, method):
    tp = getattr(TM, name)(**PAR)
    close(getattr(tp, method)(TCOSMO, t_(R), t_(M), A),
          jax_out[name, method], RTOL)


@pytest.mark.parametrize("name", FOURIER)
def test_fourier_matches_jax(jax_out, name):
    tp = getattr(TM, name)(**PAR)
    close(tp.fourier(TCOSMO, t_(K), t_(M), A), jax_out[name, "fourier"],
          RTOL)


@pytest.mark.parametrize("a", [0.25, 0.5, 1.0])
def test_fractions_match_jax(a):
    """The stellar fractions, the bound / ejected split and the modified
    concentration against the JAX package's; the budget sums to f_bar."""
    Ms = np.geomspace(1e11, 1e16, 11)
    jp, tp = JM.BoundGas(**PAR), TM.BoundGas(**PAR)
    for fn in ("get_f_star", "get_f_star_cen", "get_f_star_sat",
               "get_f_gas"):
        close(getattr(tp, fn)(t_(Ms), a, TCOSMO),
              getattr(jp, fn)(jnp.asarray(Ms), a, JCOSMO), RTOL)
    tf = tp._get_gas_frac(t_(Ms), a, TCOSMO)
    for t, j in zip(tf, jp._get_gas_frac(jnp.asarray(Ms), a, JCOSMO)):
        close(t, j, RTOL)
    fb = COSMO_DICT["Omega_b"] / COSMO_DICT["Omega_m"]
    np.testing.assert_allclose(
        (tp.get_f_star(t_(Ms), a, TCOSMO) + sum(tf)).numpy(), fb,
        rtol=1e-12)
    c = np.full(11, 5.0)
    close(tp._modify_concentration(TCOSMO, t_(c), t_(Ms), a),
          jp._modify_concentration(JCOSMO, jnp.asarray(c), jnp.asarray(Ms),
                                   a), RTOL)


def test_escape_radius_matches_jax():
    """R_ej of the ejected gas (erf and a root a halo), from 1e11 to 1e16
    Msun, where f_ej changes sign."""
    Ms = np.geomspace(1e11, 1e16, 8)
    jr, jf = JM.EjectedGas(**PAR)._r_ej(JCOSMO, jnp.asarray(Ms), A)
    tr, tf = TM.EjectedGas(**PAR)._r_ej(TCOSMO, t_(Ms), A)
    close(tf, jf, RTOL)
    close(tr, jr, RTOL)


@pytest.mark.parametrize("Tagn", [7.6, 7.7, 7.8, 8.2, 7.5])
@pytest.mark.parametrize("mode", ["All", "MatterPressure"])
def test_tagn2pars_matches_jax(Tagn, mode):
    """Equal to the JAX package's (both numpy): interpolated inside the
    calibrations, a straight-line fit outside."""
    assert TM.Tagn2pars(Tagn, mode) == JM.Tagn2pars(Tagn, mode)


def test_tagn2pars_refusals():
    with pytest.raises(NotImplementedError):
        TM.Tagn2pars(7.8, "Pressure")
    with pytest.raises(TypeError):
        TM.Tagn2pars("7.8")
    for k in ("7p6_All", "7p8_All", "8p0_All", "7p6_MPr", "7p8_MPr",
              "8p0_MPr"):
        assert getattr(TM, f"Params_TAGN_{k}") == \
            getattr(JM, f"Params_TAGN_{k}")


@pytest.mark.parametrize("name", ["DarkMatterBaryon",
                                  "DarkMatterBaryonwithLSS"])
def test_profile_from_jax(jax_out, name):
    jp = getattr(JM, name)(**PAR)
    tp = convert.profile_from_jax(jp)
    assert type(tp) is getattr(TM, name)
    assert type(tp.Gas.myprof._B) is TM.EjectedGas
    assert type(tp.TwoHalo) is (TM.TwoHalo if name.endswith("LSS")
                                else bf.Profiles.misc.Zeros)
    assert tp.model_params == jp.model_params
    close(tp.real(TCOSMO, t_(R), t_(M), A), jax_out[name, "real"], RTOL)
