"""The Schneider25 profiles of the torch port against baryonforge_tpu: real
and projected of every class, the DM's Fourier transform (as the JAX tests
take it), the fractions, the peak height and the two-halo exclusion, and
profile_from_jax of the DMB profile.

Both packages build the profiles from tests/defaults.py's bpar_S25 with
proj_cutoff=100 and r_steps=500 (the collisionless matter's default of
5000 knots costs the JAX side far longer; its relaxation and spline are
the same at 500), and evaluate them on the CPU (CPU tensors in the port).
Each JAX output is computed once a module. Tolerance: 1e-10 relative, with
a floor at that fraction of the array's largest value
(tests/test_torch_profiles_s19.py; measured <= 7e-13).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.Profiles import Schneider25 as JS      # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.Profiles import Schneider25 as TS    # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO_DICT, bpar_S25                   # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-10
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
PAR = dict(bpar_S25, proj_cutoff=100, r_steps=500)
M = np.array([3e12, 4e13, 8e14])
R = np.geomspace(2e-3, 3.0, 8)
K = np.geomspace(0.05, 20, 9)
A = 0.6
CLASSES = [c for c in TS.__all__ if c[0].isupper()
           and c != "Schneider25Profiles"]


def t_(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for name in CLASSES:
        p = getattr(JS, name)(**PAR)
        out[name, "real"] = np.asarray(p.real(JCOSMO, R, jnp.asarray(M), A))
        out[name, "projected"] = np.asarray(
            p.projected(JCOSMO, R, jnp.asarray(M), A))
    out["DarkMatter", "fourier"] = np.asarray(JS.DarkMatter(**PAR).fourier(
        JCOSMO, K, jnp.asarray(M), A))
    return out


@pytest.mark.parametrize("method", ["real", "projected"])
@pytest.mark.parametrize("name", CLASSES)
def test_matches_jax(jax_out, name, method):
    tp = getattr(TS, name)(**PAR)
    close(getattr(tp, method)(TCOSMO, t_(R), t_(M), A),
          jax_out[name, method], RTOL)


def test_fourier_matches_jax(jax_out):
    close(TS.DarkMatter(**PAR).fourier(TCOSMO, t_(K), t_(M), A),
          jax_out["DarkMatter", "fourier"], RTOL)


@pytest.mark.parametrize("a", [0.25, 0.5, 1.0])
def test_fractions_match_jax(a):
    """The stellar fractions, the hot / inner gas split and the peak height
    against the JAX package's; the budget sums to f_bar."""
    Ms = np.geomspace(1e11, 1e16, 11)
    jp, tp = JS.HotGas(**PAR), TS.HotGas(**PAR)
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
    close(TS._nu_peak(TCOSMO, t_(Ms), a), JS._nu_peak(JCOSMO, jnp.asarray(Ms),
                                                     a), RTOL)


def test_twohalo_exclusion(jax_out):
    """The two-halo term is the Schneider19 one times 1 - exp(-alpha_excl
    r/R), r/R clipped to 30 (as tests/test_profiles_s25.py states it)."""
    r = np.geomspace(1e-2, 100, 24)
    th25 = TS.TwoHalo(**PAR).real(TCOSMO, t_(r), t_(1e14), 1.0)
    th19 = bf.Profiles.TwoHalo(q=PAR["q"], p=PAR["p"]).real(
        TCOSMO, t_(r), t_(1e14), 1.0)
    R = float(TS._halo_radius(TS.TwoHalo(), TCOSMO, t_([1e14]), 1.0)[0])
    f_excl = 1 - np.exp(-PAR["alpha_excl"] * np.clip(r / R, 0, 30))
    np.testing.assert_allclose(th25.numpy(), th19.numpy() * f_excl,
                               rtol=1e-12)


def test_profile_from_jax(jax_out):
    jp = JS.DarkMatterBaryon(**PAR)
    tp = convert.profile_from_jax(jp)
    assert type(tp) is TS.DarkMatterBaryon
    assert type(tp.CollisionlessMatter.InnerGas) is TS.InnerGas
    assert type(tp.TwoHalo) is TS.TwoHalo
    assert tp.model_params == jp.model_params
    close(tp.real(TCOSMO, t_(R), t_(M), A), jax_out["DarkMatterBaryon",
                                                    "real"], RTOL)
