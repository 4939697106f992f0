"""The port's utils against baryonforge_tpu's: TabulatedCorrelation3D (and
an S19 TwoHalo with it as the xi_mm hook, also carried across by
profile_from_jax), the profile cache, the misc helpers, the FITS reader and
writer (each package reading the other's files) and the exports of
``utils``. All on the CPU (CPU tensors in the port).

Tolerances: the correlation table within 1e-9 of its largest |xi| (the
bar of the port's table builds: FFTLog and power-spectrum ulps); the
TwoHalo profile 1e-10 relative with a floor at that fraction of its
largest value (tests/test_torch_profiles_s19.py's); FITS bitwise at >f8
and to 2e-7 at >f4 (tests/test_runners_extra.py:182-198).
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

import baryonforge_tpu.utils as JU                          # noqa: E402
from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import cosmo as jc                     # noqa: E402
import baryonforge_torch.utils as TU                        # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch import cosmo as tc                   # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import BPAR, COSMO_DICT              # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = tc.cosmology_from_dict(COSMO_DICT)
# a small (z, r) grid: 4 redshifts x 64 radii
GRID = dict(R_range=(1e-2, 1e2), N_samples_R=64, z_range=(0.0, 1.5),
            N_samples_z=4)


@pytest.fixture(scope="module")
def xi_tables():
    return (JU.TabulatedCorrelation3D(JCOSMO, **GRID),
            TU.TabulatedCorrelation3D(TCOSMO, device="cpu", **GRID))


def test_correlation_table_matches_jax(xi_tables):
    jt, tt = xi_tables
    jtab = np.asarray(jt._tab)
    scale = np.abs(jtab).max()
    np.testing.assert_array_equal(tt._z.numpy(), np.asarray(jt._z))
    np.testing.assert_array_equal(tt._lnr.numpy(), np.asarray(jt._lnr))
    assert np.abs(tt._tab.numpy() - jtab).max() <= 1e-9 * scale
    # the readout: on and off the nodes, out of range (0), an array of a
    rng = np.random.default_rng(5)
    r = np.concatenate([np.geomspace(5e-3, 2e2, 40), [1e-2, 1e2]])
    for a in (1.0, 0.7, 1 / 2.5, 0.45):
        got = tt(torch.as_tensor(r), a)
        want = np.asarray(jt(jnp.asarray(r), a))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() <= 1e-9 * scale
    a = rng.uniform(0.45, 1.0, r.size)
    np.testing.assert_allclose(tt(r, torch.as_tensor(a)).numpy(),
                               np.asarray(jt(jnp.asarray(r),
                                             jnp.asarray(a))),
                               rtol=0, atol=1e-9 * scale)
    assert tt(np.array([1e-4, 1e3]), 0.8).abs().max() == 0


def test_two_halo_with_the_hook_matches_jax(xi_tables):
    jt, tt = xi_tables
    jp = JP.TwoHalo(**BPAR, proj_cutoff=100, xi_mm=jt)
    tp = TP.TwoHalo(**BPAR, proj_cutoff=100, xi_mm=tt)
    M = np.array([3e12, 4e13, 8e14])
    R = np.geomspace(2e-2, 50, 12)
    for a in (1.0, 0.6):
        close(tp.real(TCOSMO, torch.as_tensor(R), torch.as_tensor(M), a),
              jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), a), 1e-10)
    # the hook is read: without it the profile differs
    plain = TP.TwoHalo(**BPAR, proj_cutoff=100).real(
        TCOSMO, torch.as_tensor(R), torch.as_tensor(M), 0.6)
    assert not torch.allclose(plain, tp.real(TCOSMO, torch.as_tensor(R),
                                             torch.as_tensor(M), 0.6),
                              rtol=1e-6)
    # profile_from_jax carries a JAX table across by its arrays
    conv = convert.profile_from_jax(jp)
    assert isinstance(conv.xi_mm, TU.TabulatedCorrelation3D)
    np.testing.assert_array_equal(conv.xi_mm._tab.numpy(),
                                  np.asarray(jt._tab))
    close(conv.real(TCOSMO, torch.as_tensor(R), torch.as_tensor(M), 0.6),
          jp.real(JCOSMO, jnp.asarray(R), jnp.asarray(M), 0.6), 1e-10)
    with pytest.raises(NotImplementedError, match="xi_mm"):
        convert.profile_from_jax(JP.TwoHalo(**BPAR, xi_mm=lambda r, a: r))


def test_cached_profile():
    """tests/test_pixel_cache_misc.py:75-84 on the port: a hit returns what
    the miss did (torch.equal), a new a is a new entry."""
    dm = TP.DarkMatter(**BPAR)
    cached = TU.CachedProfile(dm)
    r = torch.as_tensor(np.geomspace(1e-2, 50, 24))
    M = torch.as_tensor(np.geomspace(1e13, 1e15, 4))
    a1 = cached.real(TCOSMO, r, M, 0.8)
    a2 = cached.real(TCOSMO, r, M, 0.8)              # hit
    assert torch.equal(a1, a2) and a1 is not a2
    assert len(cached.cache) == 1
    cached.real(TCOSMO, r, M, 0.5)
    assert len(cached.cache) == 2
    # a hit is a copy: changing it changes neither the cache nor the miss
    a2.zero_()
    assert torch.equal(cached.real(TCOSMO, r, M, 0.8), a1)
    # the same values from numpy are another key (the tensor's device is
    # part of it)
    cached.real(TCOSMO, r.numpy(), M, 0.8)
    assert len(cached.cache) == 3
    # projected and fourier are memoized apart, and equal the profile's
    p = cached.projected(TCOSMO, r, M, 0.8)
    assert torch.equal(p, cached.projected(TCOSMO, r, M, 0.8))
    assert torch.equal(p, dm.projected(TCOSMO, r, M, 0.8))
    assert cached.mass_def is dm.mass_def              # other attributes


def test_array_cache_is_lru():
    cache = TU.SimpleArrayCache(maxsize=2)
    keys = [TU.SimpleArrayCache._key((torch.arange(3) + i,), {})
            for i in range(3)]
    assert keys[0] == TU.SimpleArrayCache._key((torch.arange(3),), {})
    assert keys[0] != TU.SimpleArrayCache._key(
        (torch.arange(3, dtype=torch.float64),), {})
    cache.put(keys[0], torch.zeros(1))
    cache.put(keys[1], torch.ones(1))
    assert cache.get(keys[0]) is not None            # 0 is now the newest
    cache.put(keys[2], torch.full((1,), 2.0))        # evicts 1
    assert cache.get(keys[1]) is None
    assert cache.get(keys[0]) is not None and cache.get(keys[2]) is not None
    assert len(cache) == 2
    cache.clear()
    assert len(cache) == 0


def test_cached_displacement():
    """A displacement model's ``displacement`` is memoized too."""
    tab = TP.Baryonification2D(None, None, TCOSMO, device="cpu")
    calls = []

    class Counted:
        mass_def = tab.mass_def

        def real(self, *a, **k):
            return torch.zeros(1)
        projected = fourier = real

        def displacement(self, r, M, a, **kw):
            calls.append(1)
            return torch.as_tensor(r) * M * a

    c = TU.CachedProfile(Counted())
    r = torch.linspace(0.1, 1.0, 5, dtype=torch.float64)
    d1 = c.displacement(r, 2.0, 0.5)
    d2 = c.displacement(r, 2.0, 0.5)
    assert torch.equal(d1, d2) and len(calls) == 1


def test_misc_helpers(capsys):
    """tests/test_runners_extra.py:124-137 on the port, destroy_Pk and a
    cosmology's dict round trip."""
    @TU.log_time
    def work(x, log_line_time=None):
        log_line_time("start")
        y = x * 2
        log_line_time("end")
        return y

    assert work(21) == 42
    out = capsys.readouterr().out
    assert "start" in out and "end" in out
    assert TU.debug.log_time is TU.log_time

    @TU.log_time
    def plain(x):
        return x + 1
    assert plain(1) == 2

    assert TU.destroy_Pk(TCOSMO) is TCOSMO
    assert TU.destory_Pk is TU.destroy_Pk
    cosmo = tc.cosmology_from_dict(dict(COSMO_DICT, wa=0.1))
    d = TU.misc.build_cosmodict(cosmo)
    assert d == JU.misc.build_cosmodict(jc.cosmology_from_dict(
        dict(COSMO_DICT, wa=0.1)))
    assert tc.cosmology_from_dict(d) == cosmo
    assert pickle.loads(pickle.dumps(TU.destroy_Pk(cosmo))) == cosmo


@pytest.mark.parametrize("dtype", [">f8", ">f4"])
def test_fits_both_ways(tmp_path, dtype):
    """Files written by either package read by the other: bitwise at >f8,
    to 2e-7 at >f4; and LightconeShell(path=...)."""
    from baryonforge_tpu.utils import fitsio as jf
    from baryonforge_torch.utils import fitsio as tf
    m = np.random.default_rng(2).exponential(1.0, 12 * 16 * 16)
    pt, pj = str(tmp_path / "t.fits"), str(tmp_path / "j.fits")
    TU.write_healpix_fits(pt, m, dtype=dtype)
    jf.write_healpix_fits(pj, m, dtype=dtype)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for back in (jf.read_healpix_fits(pt), tf.read_healpix_fits(pj),
                 tf.read_healpix_fits(pt)):
        if dtype == ">f8":
            np.testing.assert_array_equal(back, m)
        else:
            np.testing.assert_allclose(back, m, rtol=2e-7)
    shell = TU.LightconeShell(path=pj, cosmo=COSMO_DICT)
    assert shell.NSIDE == 16
    np.testing.assert_array_equal(shell.map, tf.read_healpix_fits(pj))
    np.testing.assert_array_equal(
        shell.map, JU.LightconeShell(path=pt, cosmo=COSMO_DICT).map)
    # a single-column map of another row width, and NESTED refused
    small = m[:12]
    tf.write_healpix_fits(pt, small, dtype=dtype)
    np.testing.assert_array_equal(jf.read_healpix_fits(pt),
                                  tf.read_healpix_fits(pt))
    raw = open(pt, "rb").read().replace(b"'RING    '", b"'NESTED  '")
    open(pt, "wb").write(raw)
    with pytest.raises(NotImplementedError):
        tf.read_healpix_fits(pt)


def test_utils_exports_match_jax():
    import baryonforge_torch.parallel as TPar
    jnames = {n for n in dir(JU) if not n.startswith("__")}
    jnames -= {"Cache", "Parallelize", "Pixel", "Tabulate", "fitsio", "io",
               "misc"}                 # submodules imported by the names
    missing = sorted(n for n in jnames if not hasattr(TU, n))
    assert not missing, missing
    for n in ("halo_mesh", "SimpleParallel", "SplitJoinParallel"):
        assert hasattr(TPar, n)
    assert TU.SimpleParallel is TPar.SimpleParallel
    assert TU.FlexibleHMCalculator is TU.halomodel.FlexibleHMCalculator
