"""The port's halo model (utils/halomodel.py) against baryonforge_tpu's:
the Sheth-Tormen and Tinker08 mass functions and the Sheth-Tormen bias
within 1e-10 relative, and halomodel_power (an S19 DarkMatter profile,
M_tot != M_delta, nM 32) within 1e-8 relative; plus the limits of
tests/test_halomodel.py:13-42 on the port (with its Mdelta_to_Mtot, nM
64). On the CPU (CPU tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.utils import halomodel as jhm          # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch import cosmo as tc                   # noqa: E402
from baryonforge_torch.utils import halomodel as thm        # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402

JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = tc.cosmology_from_dict(COSMO_DICT)


@pytest.mark.parametrize("name", ["MassFuncShethTormen", "MassFuncTinker08",
                                  "HaloBiasShethTormen"])
@pytest.mark.parametrize("a", [1.0, 0.5, 0.2])
def test_mass_functions_and_bias_match_jax(name, a):
    M = np.geomspace(1e10, 1e16, 16)
    got = getattr(thm, name)(device="cpu")(TCOSMO, M, a)
    want = np.asarray(getattr(jhm, name)()(JCOSMO, jnp.asarray(M), a))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    # a tensor M keeps its device, whatever the object's device is
    got_t = getattr(thm, name)()(TCOSMO, torch.as_tensor(M), a)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def _mtot(xp):
    """A closed-form M_tot(M_delta) (M_tot > M_delta, rising with M) for
    the calculator's counter terms: the JAX Mdelta_to_Mtot evaluates the
    DarkMatter profile eagerly, ~4 s a call, and halomodel_power calls it
    twice (the port's Mdelta_to_Mtot is held to the JAX one in
    tests/test_torch_profiles_misc_b12.py)."""
    return lambda cosmo, M, a: M * (1.2 + 0.01 * xp.log10(M))


@pytest.fixture(scope="module")
def power():
    k = np.geomspace(1e-3, 10, 16)
    jdm = JP.DarkMatter(**BPAR)
    tdm = TP.DarkMatter(**BPAR)
    jhmc = jhm.FlexibleHMCalculator(
        mass_function=jhm.MassFuncShethTormen(),
        halo_bias=jhm.HaloBiasShethTormen(), halo_m_to_mtot=_mtot(jnp),
        log10M_min=10, log10M_max=16, nM=32)
    thmc = thm.FlexibleHMCalculator(
        mass_function=thm.MassFuncShethTormen(device="cpu"),
        halo_bias=thm.HaloBiasShethTormen(device="cpu"),
        halo_m_to_mtot=_mtot(torch), log10M_min=10, log10M_max=16, nM=32,
        device="cpu")
    return (k, np.asarray(jhm.halomodel_power(JCOSMO, k, 1.0, jdm, jhmc)),
            thm.halomodel_power(TCOSMO, k, 1.0, tdm, thmc), jhmc, thmc,
            jdm, tdm)


def test_halomodel_power_matches_jax(power):
    """halomodel_power with M_tot != M_delta (the fixture); I_0_1 and
    integrate_over_massfunc on Tinker08 calculators without it."""
    k, want, got, _, _, jdm, tdm = power
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
    jhmc = jhm.FlexibleHMCalculator(
        mass_function=jhm.MassFuncTinker08(),
        halo_bias=jhm.HaloBiasShethTormen(), log10M_min=10,
        log10M_max=16, nM=32)
    thmc = thm.FlexibleHMCalculator(
        mass_function=thm.MassFuncTinker08(device="cpu"),
        halo_bias=thm.HaloBiasShethTormen(device="cpu"), log10M_min=10,
        log10M_max=16, nM=32, device="cpu")
    np.testing.assert_allclose(thmc.I_0_1(TCOSMO, k, 0.8, tdm).numpy(),
                               np.asarray(jhmc.I_0_1(JCOSMO, k, 0.8, jdm)),
                               rtol=1e-8)
    f = (lambda m: m ** 0.5)
    np.testing.assert_allclose(
        float(thmc.integrate_over_massfunc(f, TCOSMO, 0.8)),
        float(jhmc.integrate_over_massfunc(f, JCOSMO, 0.8)), rtol=1e-10)


def test_halomodel_limits():
    """tests/test_halomodel.py:13-42 on the port: positive, steeply falling
    mass functions; the ST mass fraction; a rising bias; the 2-halo and
    1-halo limits of P(k)."""
    M = torch.as_tensor(np.geomspace(1e10, 1e16, 16))
    for mf in (thm.MassFuncShethTormen(), thm.MassFuncTinker08()):
        n = mf(TCOSMO, M, 1.0).numpy()
        assert np.all(n > 0) and np.all(np.diff(np.log(n)) < 0)
        assert n[-1] / n[0] < 1e-8
    Mw = np.geomspace(1e4, 1e17, 256)
    n = thm.MassFuncShethTormen(device="cpu")(TCOSMO, Mw, 1.0).numpy()
    integ = np.trapezoid(n * Mw, np.log10(Mw))
    rho_m = float(tc.core.rho_x(TCOSMO, 1.0, "matter", is_comoving=True))
    assert 0.5 < integ / rho_m < 1.02
    b = thm.HaloBiasShethTormen(device="cpu")(
        TCOSMO, np.geomspace(1e12, 1e16, 8), 1.0).numpy()
    assert np.all(np.diff(b) > 0) and b[0] < 1.5 and b[-1] > 3
    k = np.geomspace(1e-3, 10, 16)
    dm = TP.DarkMatter(**BPAR)
    pk = thm.halomodel_power(TCOSMO, k, 1.0, dm, thm.FlexibleHMCalculator(
        mass_function=thm.MassFuncShethTormen(device="cpu"),
        halo_bias=thm.HaloBiasShethTormen(device="cpu"),
        halo_m_to_mtot=TP.misc.Mdelta_to_Mtot(dm), log10M_min=10,
        log10M_max=16, nM=64, device="cpu"))
    pk_lin = tc.power.linear_power(TCOSMO, torch.as_tensor(k), 1.0)
    assert torch.isfinite(pk).all() and (pk > 0).all()
    np.testing.assert_allclose(float(pk[0]), float(pk_lin[0]), rtol=0.3)
    assert pk[-1] > pk_lin[-1]
