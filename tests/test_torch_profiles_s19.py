"""Schneider19 profiles of the torch port against baryonforge_tpu: real and
projected of every class, the Fourier transform, profile algebra,
set_parameter on nested profiles, and profile_from_jax.

Profiles are built in both packages from the bench's parameters and
evaluated on the CPU (CPU tensors in the port). Tolerance 1e-10 relative,
with a floor at that fraction of the largest value: the profiles chain
concentrations, normalisation integrals and, for the collisionless matter,
ten PCHIP relaxations and a 5000-knot spline, whose ulp-level differences
(XLA's fused multiply-adds and transcendentals against torch's) stay below
~1e-12 (measured).
"""

import operator
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch import cosmo as tc                   # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-10
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = tc.cosmology_from_dict(COSMO_DICT)
M = np.array([3e12, 4e13, 8e14])
R = np.geomspace(2e-3, 30, 12)
A = 0.6

CLASSES = ["DarkMatter", "TwoHalo", "Stars", "Gas", "ShockedGas",
           "CollisionlessMatter", "SatelliteStars", "DarkMatterOnly",
           "DarkMatterBaryon"]


def make(pkg, name, **extra):
    kw = dict(BPAR, proj_cutoff=100, **extra)
    if name == "ShockedGas":
        kw.update(epsilon_shock=1.5, width_shock=0.3)
    return getattr(pkg, name)(**kw)


def t_(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("name", CLASSES)
def test_real_matches_jax(name):
    jp, tp = make(JP, name), make(TP, name)
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), A), RTOL)
    # scalar inputs mirror their rank
    out = tp.real(TCOSMO, t_(0.1), t_(2e14), A)
    assert out.dim() == 0
    close(out, jp.real(JCOSMO, 0.1, 2e14, A), RTOL)


@pytest.mark.parametrize("name", CLASSES)
def test_projected_matches_jax(name):
    jp, tp = make(JP, name), make(TP, name)
    close(tp.projected(TCOSMO, t_(R), t_(M), A),
          jp.projected(JCOSMO, np.asarray(R), jnp.asarray(M), A), RTOL)


def test_projected_fftlog_and_fourier_match_jax():
    k = np.geomspace(0.05, 20, 15)
    for name in ("DarkMatter", "Gas", "Stars"):
        jp, tp = make(JP, name), make(TP, name)
        close(tp.fourier(TCOSMO, t_(k), t_(M), A),
              jp.fourier(JCOSMO, np.asarray(k), jnp.asarray(M), A), RTOL)
    kw = dict(use_fftlog_projection=True, cutoff=100)
    jp, tp = make(JP, "DarkMatter", **kw), make(TP, "DarkMatter", **kw)
    jp.proj_cutoff = tp.proj_cutoff = 100
    close(tp.projected(TCOSMO, t_(R), t_(M), A),
          jp.projected(JCOSMO, np.asarray(R), jnp.asarray(M), A), RTOL)


@pytest.mark.parametrize("op", ["add", "mul", "sub", "truediv", "radd",
                                "rmul", "neg"])
def test_profile_algebra_matches_jax(op):
    def build(pkg):
        g, s = make(pkg, "Gas"), make(pkg, "Stars")
        return {"add": lambda: g + s, "mul": lambda: g * s,
                "sub": lambda: g - s, "truediv": lambda: g / s,
                "radd": lambda: 2.0 + g, "rmul": lambda: 3.0 * s,
                "neg": lambda: -g}[op]()
    jp, tp = build(JP), build(TP)
    assert type(tp).__name__ == "_CombinedProfile"
    assert tp.precision_fftlog == jp.precision_fftlog
    assert sorted(tp.model_param_names) == sorted(jp.model_param_names)
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), A), RTOL)


def test_hyper_merge_matches_jax():
    """Grid knobs take the superset of both operands' needs; differing
    identity-like knobs keep the first operand's with a warning."""
    kw_a = dict(r_steps=300, padding_hi_proj=5.0)
    kw_b = dict(r_steps=700, padding_hi_proj=20.0, n_per_decade_proj=15)

    def build(pkg, cpkg):
        a = make(pkg, "Gas", **kw_a)
        b = make(pkg, "Gas", mass_def=cpkg.MassDef200m, **kw_b)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            p = a + b
        return p, [str(x.message) for x in w]
    jp, jw = build(JP, jc)
    tp, tw = build(TP, tc)
    for k in ("r_steps", "padding_hi_proj", "n_per_decade_proj"):
        assert getattr(tp, k) == getattr(jp, k)
    assert tp.r_steps == 700 and tp.padding_hi_proj == 20.0
    assert len(tw) == len(jw) == 1 and "mass_def" in tw[0]


def test_set_parameter_reaches_nested_profiles():
    tp = make(TP, "DarkMatterBaryon")
    jp = make(JP, "DarkMatterBaryon")
    for p in (tp, jp):
        p.set_parameter("theta_ej", 6.5)
        p.set_parameter("cutoff", 50.0)
    assert tp.Gas.theta_ej == tp.CollisionlessMatter.Gas.theta_ej == 6.5
    assert tp.CollisionlessMatter.DarkMatter.cutoff == 50.0
    from baryonforge_torch.utils.Tabulate import _get_parameter
    assert _get_parameter(tp, "theta_ej") == 6.5
    with pytest.raises(AttributeError):
        _get_parameter(tp, "no_such_parameter")
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), A), RTOL)


@pytest.mark.parametrize("name", CLASSES)
def test_profile_from_jax(name):
    """A converted profile has the port's class, the JAX profile's
    parameters and sub-profiles, and evaluates as the JAX one does."""
    jp = make(JP, name, c_M_relation=jc.Duffy08)
    tp = convert.profile_from_jax(jp)
    assert type(tp) is getattr(TP, name)
    assert tp.model_params == jp.model_params
    assert tp.precision_fftlog == jp.precision_fftlog
    assert tp._c_M_relation is tc.concentration.Duffy08
    for sub in ("DarkMatter", "Gas", "Stars", "TwoHalo",
                "CollisionlessMatter"):
        if hasattr(jp, sub):
            assert type(getattr(tp, sub)) is getattr(TP, sub)
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), A), RTOL)


def test_profile_from_jax_combined():
    jp = make(JP, "Gas") * 2.0 + make(JP, "Stars")
    tp = convert.profile_from_jax(jp)
    assert tp._op is operator.add and tp._B.__class__ is TP.Stars
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), A), RTOL)


def test_profiles_default_to_cuda():
    """Without tensors the entry points run on CUDA, which this machine
    lacks: they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make(TP, "DarkMatter").real(TCOSMO, R, M, A)
