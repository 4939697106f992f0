"""The thermodynamic profiles and the pixel windows of the torch port (plain
torch float64 on the CPU) against baryonforge_tpu, on the same inputs.

Every class of Profiles/Thermodynamic.py at a few (r, M, a), the README's
ThermalSZ(**bpar, proj_cutoff=100) and a Temperature with a non-thermal
fraction among them; the HealPixel, NoPix and GridPixelApprox windows;
ConvolvedProfile(ThermalSZ, HealPixel(64)).projected; the conversion of
JAX objects (utils.convert). Tolerance: 1e-10 of the largest value (the
packages differ in the last bits of their sums and grids; measured
~3e-13).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.utils import Pixel as JPixel           # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.utils import Pixel as TPixel         # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402

RTOL = 1e-10
R = np.geomspace(1e-2, 10.0, 7)
M = np.geomspace(1e13, 1e15, 3)
A = 0.55
NT = dict(alpha_nt=0.2, nu_nt=0.5, gamma_nt=0.8)

# name -> (constructor on a Profiles module, whether to compare projected)
CASES = {
    "ThermalSZ": (lambda P: P.Thermodynamic.ThermalSZ(**BPAR,
                                                      proj_cutoff=100), True),
    "ThermalSZ_of_Pressure": (lambda P: P.Thermodynamic.ThermalSZ(
        P.Thermodynamic.Pressure(**BPAR, proj_cutoff=100),
        proj_cutoff=100), False),
    "Pressure": (lambda P: P.Thermodynamic.Pressure(**BPAR), False),
    "ElectronPressure": (lambda P: P.Thermodynamic.ElectronPressure(**BPAR),
                         False),
    "GasNumberDensity": (lambda P: P.Thermodynamic.GasNumberDensity(**BPAR),
                         True),
    "Temperature": (lambda P: P.Thermodynamic.Temperature(**BPAR, **NT),
                    True),
    "NonThermalFrac": (lambda P: P.Thermodynamic.NonThermalFrac(**BPAR, **NT),
                       False),
    "NonThermalFracGreen20": (
        lambda P: P.Thermodynamic.NonThermalFracGreen20(**BPAR), False),
}


def _cosmos():
    return (jcore.cosmology_from_dict(COSMO_DICT),
            bf.cosmo.cosmology_from_dict(COSMO_DICT))


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    scale = np.abs(j).max()
    assert scale > 0, what
    np.testing.assert_allclose(t, j, rtol=0, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_thermodynamic_matches_jax(name):
    """real at (7 r, 3 M, a), and projected where the case says so, from
    profiles built in each package, and from the JAX profile converted."""
    make, proj = CASES[name]
    jc, tc = _cosmos()
    jp, tp = make(JProfiles), make(bf.Profiles)
    r_t = torch.as_tensor(R)
    _close(tp.real(tc, r_t, M, A), jp.real(jc, R, M, A), f"{name} real")
    cp = convert.profile_from_jax(jp)
    assert type(cp) is type(tp)
    _close(cp.real(tc, r_t, M, A), jp.real(jc, R, M, A),
           f"{name} real, converted")
    if proj:
        _close(tp.projected(tc, r_t, M, A), jp.projected(jc, R, M, A),
               f"{name} projected")


def test_scalar_inputs_and_params():
    """Scalar r and M squeeze as in the JAX package; the parameter views
    read the gas profile (prof4params); XrayLuminosity raises in both."""
    jc, tc = _cosmos()
    make = CASES["GasNumberDensity"][0]
    jp, tp = make(JProfiles), make(bf.Profiles)
    tv = tp.real(tc, torch.tensor(0.3, dtype=torch.float64), 1e14, A)
    assert tv.dim() == 0
    _close(tv, jp.real(jc, 0.3, 1e14, A), "scalar")
    jt = CASES["Temperature"][0](JProfiles)
    tt = CASES["Temperature"][0](bf.Profiles)
    assert tt.prof4params is tt.GasNumberDensity.Gas
    assert tt.model_params == jt.model_params
    assert tt.hyper_params.keys() == jt.hyper_params.keys()
    with pytest.raises(NotImplementedError):
        bf.Profiles.Thermodynamic.XrayLuminosity()
    with pytest.raises(NotImplementedError):
        JProfiles.Thermodynamic.XrayLuminosity()


@pytest.mark.parametrize("name,args", [("HealPixel", (64,)),
                                       ("NoPix", ()),
                                       ("GridPixelApprox", (0.5,))])
def test_pixel_windows_match_jax(name, args):
    """Each window's real and projected W(k) to 1e-14 of 1."""
    k = np.concatenate([[0.0], np.geomspace(1e-3, 3e3, 40)])
    jw, tw = getattr(JPixel, name)(*args), getattr(TPixel, name)(*args)
    assert tw.isHarmonic == jw.isHarmonic and tw.size == jw.size
    for m in ("real", "projected"):
        np.testing.assert_allclose(
            getattr(tw, m)(torch.as_tensor(k)).numpy(),
            np.asarray(getattr(jw, m)(jnp.asarray(k))), rtol=0, atol=1e-14,
            err_msg=f"{name}.{m}")
    cw = convert.pixel_from_jax(jw)
    assert type(cw) is type(tw) and cw.size == tw.size


def test_convolved_profile_matches_jax():
    """ConvolvedProfile(ThermalSZ, HealPixel(64)).projected (harmonic: the
    FFTLog grid in angle), and with NoPix, whose round trip gives the
    profile back, and the same from the converted JAX object."""
    jc, tc = _cosmos()
    make = CASES["ThermalSZ"][0]
    jprof, tprof = make(JProfiles), make(bf.Profiles)
    r = np.geomspace(0.02, 5.0, 6)
    r_t = torch.as_tensor(r)
    jcp = JPixel.ConvolvedProfile(jprof, JPixel.HealPixel(64))
    tcp = TPixel.ConvolvedProfile(tprof, TPixel.HealPixel(64))
    jv = np.asarray(jcp.projected(jc, r, M[:2], A))
    _close(tcp.projected(tc, r_t, M[:2], A), jv, "HealPixel projected")
    ccp = convert.profile_from_jax(jcp)
    assert isinstance(ccp, TPixel.ConvolvedProfile)
    assert isinstance(ccp.Pixel, TPixel.HealPixel)
    _close(ccp.projected(tc, r_t, M[:2], A), jv, "converted")
    # NoPix: the profile back, to 1e-3 (the line-of-sight grid of the
    # FFTLog points is not that of r: ~6e-5 apart)
    npx = TPixel.ConvolvedProfile(tprof, TPixel.NoPix())
    direct = tprof.projected(tc, r_t, 1e14, A).numpy()
    np.testing.assert_allclose(npx.projected(tc, r_t, 1e14, A).numpy(),
                               direct, rtol=1e-3)
    # delegation of unknown attributes to the wrapped profile
    assert tcp.proj_cutoff == tprof.proj_cutoff
