"""The port's S19 validation pipelines (utils/validation.py) against
baryonforge_tpu's, on the CPU at small sizes: the digitized Fig. 2 curves
equal; the Tinker08 Poisson draws equal (the shell's ~93k-halo catalog of
limber_shell_run and a box's); box_pk within 1e-12 relative (and of its
largest value, for the k = 0 bin that is zero to rounding); s19_box at
N = 32 (the full 128 Mpc box, whose collapsed fraction the pipeline
asserts) with its catalog equal and its map within 1e-9 of its largest
value (against the JAX runner run a size bucket at a time, see
_jax_box_by_bucket); tiled_vs_scatter_residual at NSIDE 64 with 300
halos under the JAX edge-jitter bound of 0.02
(tests/test_tiled_deposit.py:53-63), printed beside PARITY.json's JAX
value. The full-width pipelines (limber_shell_run,
deltapk_s19_residuals) run on the card (chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.utils import validation as JV          # noqa: E402
from baryonforge_torch import cosmo as tc                   # noqa: E402
from baryonforge_torch.utils import validation as TV        # noqa: E402

JCOSMO = jc.cosmology_from_dict(JV.TNG_COSMO_DICT)
TCOSMO = tc.cosmology_from_dict(TV.TNG_COSMO_DICT)


def test_constants_and_fig2_curves():
    assert TV.TNG_COSMO_DICT == JV.TNG_COSMO_DICT
    assert TV.BPAR_S19_FIG2 == JV.BPAR_S19_FIG2
    got, want = TV.fig2_curves(), JV.fig2_curves()
    assert got.keys() == want.keys() and "Mc1e14" in got
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)


def test_tinker_sample_draws_equal():
    """The Poisson counts from the float64 mass function: a last-bit
    difference could flip a draw; on the shell of limber_shell_run (the
    ~93k halos of PARITY.json) and on the 128 Mpc box."""
    chi = [float(jcore.comoving_radial_distance(JCOSMO, 1 / (1 + z))[0])
           for z in (0.10, 0.12)]
    vol = 4.0 * np.pi / 3.0 * (chi[1] ** 3 - chi[0] ** 3)
    for a, volume, seed in ((1 / 1.11, vol, 31), (1.0, 128.0 ** 3, 123)):
        j = JV._tinker_sample(np.random.default_rng(seed), JCOSMO, a,
                              volume)
        t = TV._tinker_sample(np.random.default_rng(seed), TCOSMO, a,
                              volume, device="cpu")
        np.testing.assert_array_equal(t, j)
    assert j.size > 0 and 30000 < TV._tinker_sample(
        np.random.default_rng(31), TCOSMO, 1 / 1.11, vol,
        device="cpu").size < 200000


def test_box_pk_matches_jax():
    rng = np.random.default_rng(4)
    for N, L in ((16, 64.0), (24, 100.0)):
        f = rng.exponential(1.0, (N, N, N))
        kj, pj = JV.box_pk(f, L)
        kt, pt = TV.box_pk(f, L, device="cpu")
        np.testing.assert_array_equal(kt, kj)
        # the k = 0 bin is the mean of delta squared, zero to rounding
        # (~1e-28 against ~50): held to 1e-12 of the largest P
        np.testing.assert_allclose(pt, pj, rtol=1e-12,
                                   atol=1e-12 * pj.max())


def _jax_box_by_bucket(jcat, N=32, L=128.0):
    """JV.s19_box's map, each size bucket painted by a JAX runner of its
    own (n_size_buckets=1, as tests/test_torch_grid.py runs the JAX grid
    runners): with s19_box's four buckets of equal batch shape the JAX
    runner reuses the first bucket's compiled cutout for the later ones
    (ROADMAP Queue 3), so JV.s19_box's own map paints the largest halos on
    a smaller cutout. The buckets are the JAX split (np.argsort,
    np.array_split) of the cutout sizes, which the port's runner makes
    (held to it by test_size_buckets_are_their_own_cutouts)."""
    import baryonforge_torch as bf
    from baryonforge_tpu import Profiles as JP
    from baryonforge_tpu import utils as JU
    from baryonforge_tpu.Runners.Map2DRunner import PaintProfilesGrid
    tab = JU.TabulatedProfile(JP.DarkMatter(**JV.BPAR_S19_FIG2), JCOSMO)
    tab.setup_interpolator(z_min=0.0, z_max=0.05, N_samples_z=2,
                           z_linear_sampling=True, M_min=3e12, M_max=5e15,
                           N_samples_Mass=12, R_min=1e-3, R_max=60,
                           N_samples_R=64, verbose=False)
    bins = (np.arange(N) + 0.5) * (L / N)
    gm0 = JU.GriddedMap(map=np.zeros((N, N, N)), bins=bins,
                        cosmo=JV.TNG_COSMO_DICT, redshift=0.0)
    tr = bf.PaintProfilesGrid(jcat, gm0, epsilon_max=5, model=None,
                              device="cpu")
    _, a, M, R = tr._halo_data(TCOSMO)
    buckets = tr._buckets(tr._cutout_sizes(tr.epsilon_max * R / a))
    assert len({Ns for _, Ns in buckets}) > 1
    painted = sum(np.asarray(PaintProfilesGrid(
        jcat[np.sort(idx)], gm0, epsilon_max=5, model=tab,
        include_pixel_size=True, n_size_buckets=1, verbose=False).process())
        for idx, _ in buckets)
    M_box = float(jcore.rho_x(JCOSMO, 1.0, species="matter",
                              is_comoving=True)) * L ** 3
    return painted + (M_box - painted.sum()) / N ** 3


@pytest.fixture(scope="module")
def boxes():
    jcat, jmap = JV.s19_box(N=32)
    return (jcat, jmap, _jax_box_by_bucket(jcat)), TV.s19_box(N=32,
                                                              device="cpu")


def test_s19_box_matches_jax(boxes):
    (jcat, jmap, ref), (tcat, tmap) = boxes
    np.testing.assert_array_equal(tcat.cat, jcat.cat)
    assert tmap.shape == jmap.shape == ref.shape == (32, 32, 32)
    np.testing.assert_allclose(tmap, ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())
    print(f"s19_box N 32: port vs the JAX runner by bucket "
          f"{np.abs(tmap - ref).max() / np.abs(ref).max():.2e} of the "
          f"largest cell; JV.s19_box's own map (one compiled cutout) "
          f"{np.abs(jmap - ref).max() / np.abs(ref).max():.2e}")
    # the P(k) machinery on the two maps
    kj, pj = JV.box_pk(ref, 128.0)
    kt, pt = TV.box_pk(tmap, 128.0, device="cpu")
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-12 * pj.max())


def test_tiled_vs_scatter_residual():
    """tiled_vs_scatter_residual at PARITY.json's configuration (NSIDE 64,
    300 halos, seed 7) on the CPU, under the JAX edge-jitter bound of 0.02,
    printed beside the JAX package's value from PARITY.json (written by
    tools/parity.py; running the JAX pipeline here would compile its S19
    profiles and two runners for minutes under a loaded test run)."""
    import json
    import os
    got = TV.tiled_vs_scatter_residual(device="cpu")
    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "PARITY.json")) as f:
        want = json.load(f)["tiled_vs_scatter"]
    print(f"tiled vs scatter, NSIDE 64, 300 halos: port "
          f"{got['max_rel_residual']:.3e}, JAX (PARITY.json) "
          f"{want['max_rel_residual']:.3e}")
    assert (got["nside"], got["n_halos"]) == (want["nside"],
                                              want["n_halos"]) == (64, 300)
    assert 0 <= got["max_rel_residual"] < 0.02
