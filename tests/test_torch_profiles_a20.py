"""The Arico20 profiles of the torch port against baryonforge_tpu: real and
projected of every class, the Fourier transform the JAX tests take, the
stellar and gas fractions and profile_from_jax of the DMB profile (the
family's displacement table and a grid run on it are in
tests/test_torch_family_tables.py).

Both packages build the profiles from tests/defaults.py's bpar_A20 with
proj_cutoff=100 and r_steps=500 (the collisionless matter's default of
5000 knots costs the JAX side ~30 s a first call; its relaxation, per-halo
grids and per-row spline are the same at 500), and evaluate them on the
CPU (CPU tensors in the port). Each JAX output is computed once a module.

Tolerance: 1e-10 relative, with a floor at that fraction of the array's
largest value, as tests/test_torch_profiles_s19.py (measured: <= 4e-12 of
the largest, the collisionless matter's ten relaxation steps and spline).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.Profiles import Arico20 as JA          # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.Profiles import Arico20 as TA        # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO_DICT, bpar_A20                   # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-10
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
PAR = dict(bpar_A20, proj_cutoff=100, r_steps=500)
M = np.array([3e12, 4e13, 8e14])
R = np.geomspace(2e-3, 3.0, 8)
K = np.geomspace(0.05, 20, 9)
A = 0.6
CLASSES = [c for c in TA.__all__ if c[0].isupper() and c != "AricoProfiles"]
# no class overrides fourier; the JAX tests take the DM's
FOURIER = ["DarkMatter"]


def t_(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def jax_out():
    """Every class's real and projected, and FOURIER's fourier, of the JAX
    package, once."""
    out = {}
    for name in CLASSES:
        p = getattr(JA, name)(**PAR)
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
    tp = getattr(TA, name)(**PAR)
    close(getattr(tp, method)(TCOSMO, t_(R), t_(M), A),
          jax_out[name, method], RTOL)


@pytest.mark.parametrize("name", FOURIER)
def test_fourier_matches_jax(jax_out, name):
    tp = getattr(TA, name)(**PAR)
    close(tp.fourier(TCOSMO, t_(K), t_(M), A), jax_out[name, "fourier"],
          RTOL)


@pytest.mark.parametrize("a", [0.25, 0.5, 1.0])
def test_fractions_match_jax(a):
    """The Behroozi13 stellar fractions and the gas split against the JAX
    package's; they sum to f_bar and none is negative."""
    Ms = np.geomspace(1e11, 1e16, 11)
    jp, tp = JA.Gas(**PAR), TA.Gas(**PAR)
    for fn in ("get_f_star", "get_f_star_cen", "get_f_star_sat",
               "get_f_gas"):
        close(getattr(tp, fn)(t_(Ms), a, TCOSMO),
              getattr(jp, fn)(jnp.asarray(Ms), a, JCOSMO), RTOL)
    tf = tp._get_gas_frac(t_(Ms), a, TCOSMO)
    for t, j in zip(tf, jp._get_gas_frac(jnp.asarray(Ms), a, JCOSMO)):
        close(t, j, RTOL)
        assert (t >= 0).all()
    fb = COSMO_DICT["Omega_b"] / COSMO_DICT["Omega_m"]
    total = tp.get_f_star(t_(Ms), a, TCOSMO) + sum(tf)
    np.testing.assert_allclose(total.numpy(), fb, rtol=1e-12)


def test_scalar_inputs_mirror_their_rank():
    for name in ("ModifiedDarkMatter", "CollisionlessMatter"):
        tp = getattr(TA, name)(**PAR)
        assert tp.real(TCOSMO, t_(0.05), t_(2e14), A).dim() == 0
        assert tp.real(TCOSMO, t_(R), t_(2e14), A).shape == R.shape


def test_profile_from_jax(jax_out):
    """A converted DMB has the port's classes all the way down (the gas
    algebra, the modified DM inside the collisionless matter) and computes
    the JAX values."""
    jp = JA.DarkMatterBaryon(**PAR)
    tp = convert.profile_from_jax(jp)
    assert type(tp) is TA.DarkMatterBaryon
    assert type(tp.CollisionlessMatter.DarkMatter) is TA.ModifiedDarkMatter
    assert type(tp.Gas.myprof._B) is TA.ReaccretedGas
    assert tp.model_params == jp.model_params
    close(tp.real(TCOSMO, t_(R), t_(M), A), jax_out["DarkMatterBaryon",
                                                    "real"], RTOL)
