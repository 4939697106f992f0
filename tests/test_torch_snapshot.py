"""The snapshot runner of the torch port (the plain version of kernel K17
and the host cell list on the CPU; BaryonifySnapshot with device="cpu")
against baryonforge_tpu.

Models: the Baryonification3D(DarkMatter, DarkMatter(epsilon 2)) table of
tests/test_snapshot.py:33-38 (2 z x 5 M x 32 r) and, in 2D, the Schneider19
Baryonification2D table of tools/_northstar_table.npz, each carried across
with utils.convert. Tolerances:
  * float32: tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3 of the
    displacement);
  * float64: 1e-10 of the largest displacement.
Each JAX runner is built for its one configuration: its compiled step is
keyed on the batch shapes and the model token, not on the redshift (ROADMAP
Queue 3). The JAX comparisons use boxes whose largest query radius R_q is
at most L / 3: above that the JAX cell list (baryonforge_tpu/native/
kernels.cpp:99-164) visits cells twice and counts their particles twice,
so there the port is held against the brute-force sum of
tests/test_snapshot.py:40-67 and its cell list against cKDTree.
"""

import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Profiles as JProfiles           # noqa: E402
from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.Profiles.BaryonCorrection import (     # noqa: E402
    Baryonification2D as JB2D, Baryonification3D as JB3D,
    BaryonificationClass as JBC)
from baryonforge_tpu.Runners.SnapshotRunner import \
    BaryonifySnapshot as JSnapshot                          # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import native                        # noqa: E402
from baryonforge_torch.ops import snapshot as tsnap         # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from defaults import COSMO, COSMO_DICT, bpar_S19            # noqa: E402

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
JDT = {"f32": jnp.float32, "f64": jnp.float64}
TDT = {"f32": torch.float32, "f64": torch.float64}
# the redshift of each model's snapshots (inside its table's z range)
Z = {3: 0.2, 2: 0.9}


@pytest.fixture(scope="module")
def models():
    """{ndim: (JAX model, port model)}."""
    j3 = JB3D(JProfiles.DarkMatter(**bpar_S19),
              JProfiles.DarkMatter(**{**bpar_S19, "epsilon": 2.0}), COSMO,
              epsilon_max=20)
    j3.setup_interpolator(z_min=0.1, z_max=0.3, N_samples_z=2, M_min=1e13,
                          M_max=3e15, N_samples_Mass=5, R_min=1e-3, R_max=50,
                          N_samples_R=32, verbose=False)
    j2 = JB2D(JProfiles.DarkMatterOnly(**bpar_S19),
              JProfiles.DarkMatterBaryon(**bpar_S19), COSMO, epsilon_max=20)
    j2.load_table(TABLE)
    return {n: (j, convert.baryonification_from_jax(j, device="cpu"))
            for n, j in ((3, j3), (2, j2))}


def _box(ndim, L, n_part, n_halos, logM, seed):
    """Particle and halo columns (numpy) of a periodic box."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, (n_part, ndim))
    hpos = rng.uniform(0, L, (n_halos, ndim))
    M = 10 ** rng.uniform(*logM, n_halos)
    return pos, hpos, M


def _objects(U, ndim, L, pos, hpos, M):
    """(catalog, snapshot) of one package's utils ``U``."""
    z = Z[ndim]
    axes = dict(x=pos[:, 0], y=pos[:, 1])
    haxes = dict(x=hpos[:, 0], y=hpos[:, 1])
    if ndim == 3:
        axes["z"], haxes["z"] = pos[:, 2], hpos[:, 2]
    snap = U.ParticleSnapshot(**axes, M=np.ones(len(pos)), L=L,
                              cosmo=COSMO_DICT, redshift=z)
    cat = U.HaloNDCatalog(**haxes, M=M, redshift=z, cosmo=COSMO_DICT)
    return cat, snap


def _moves(out, pos, L):
    """Minimum-image displacements (n, ndim) of a runner's output."""
    cols = "xyz"[:pos.shape[1]]
    got = np.stack([np.asarray(out[c], float) for c in cols], 1) - pos
    got = np.where(got > L / 2, got - L, got)
    return np.where(got < -L / 2, got + L, got)


def _query_radii(model, M, ndim, L, eps=20):
    a = 1.0 / (1.0 + Z[ndim])
    cosmo = bf.cosmo.cosmology_from_dict(COSMO_DICT)
    R = model.mass_def.get_radius(cosmo, M, a).numpy()
    return R, np.clip(eps * R / a, 0, L / 2)


def _close(got, want, dt):
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


# (ndim, L, particles, halos, log10 M range, seed); the 3D box's largest
# R_q is at most L / 3 (asserted); the 2D search is cKDTree's in both
BOXES = {3: (3, 128.0, 3000, 24, (13.5, 14.6), 1),
         2: (2, 128.0, 3000, 16, (13.0, 14.0), 2)}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_snapshot_matches_jax(models, ndim, dt):
    jm, tm = models[ndim]
    _, L, n, nh, logM, seed = BOXES[ndim]
    pos, hpos, M = _box(ndim, L, n, nh, logM, seed)
    assert ndim == 2 or _query_radii(tm, M, ndim, L)[1].max() <= L / 3
    jcat, jsnap = _objects(JUtils, ndim, L, pos, hpos, M)
    tcat, tsnap_ = _objects(bf.utils, ndim, L, pos, hpos, M)
    want = _moves(JSnapshot(jcat, jsnap, epsilon_max=20, model=jm,
                            verbose=False, dtype=JDT[dt]).process(), pos, L)
    runner = bf.BaryonifySnapshot(tcat, tsnap_, epsilon_max=20, model=tm,
                                  dtype=TDT[dt], device="cpu")
    out = runner.process()
    assert np.abs(want).max() > 0.05
    _close(_moves(out, pos, L), want, dt)
    assert {k for k in runner.timings if "." not in k} == {
        "host_prep", "neighbours", "curves", "displace", "download"}
    for c in "xyz"[:ndim]:
        assert out[c].min() >= 0 and out[c].max() <= L


def _brute_force(jm, pos, hpos, M, L, ndim):
    """tests/test_snapshot.py:50-64: every halo's min-image displacements
    over all particles, from the JAX model's table readout."""
    a = 1.0 / (1.0 + Z[ndim])
    R = np.asarray(jm.mass_def.get_radius(COSMO, jnp.asarray(M), a))
    want = np.zeros_like(pos)
    for j in range(len(M)):
        dx = pos - hpos[j]
        dx = np.where(dx > L / 2, dx - L, dx)
        dx = np.where(dx < -L / 2, dx + L, dx)
        d = np.sqrt((dx ** 2).sum(1))
        sel = d < min(20 * R[j] / a, L / 2)
        off = np.asarray(jm.displacement(jnp.asarray(d[sel]), M[j],
                                         a)).reshape(-1)
        want[sel] += off[:, None] * dx[sel] / d[sel][:, None]
    return want


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_snapshot_brute_force_where_cells_wrap(models, dt):
    """3D halos up to 10^15: R_q above L / 3, where the JAX cell list
    counts particles twice. The port matches the brute-force sum."""
    jm, tm = models[3]
    L = 128.0
    pos, hpos, M = _box(3, L, 2500, 12, (14.3, 15.0), 77)
    assert _query_radii(tm, M, 3, L)[1].max() > L / 3
    tcat, tsnap_ = _objects(bf.utils, 3, L, pos, hpos, M)
    got = _moves(bf.BaryonifySnapshot(tcat, tsnap_, epsilon_max=20,
                                      model=tm, dtype=TDT[dt],
                                      device="cpu").process(), pos, L)
    want = _brute_force(jm, pos, hpos, M, L, 3)
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    else:
        # the table readout and the per-halo curve lerp round differently
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("radius", [10.0, 20.0, 30.0, 35.0, 46.0])
def test_cell_list_equals_ckdtree(radius):
    """4,000 uniform particles in L 128, radii 10 to 46 (where the JAX cell
    list counts some particles twice): every query's neighbours, also where
    the window wraps."""
    rng = np.random.default_rng(int(radius))
    L = 128.0
    pos = rng.uniform(0, L, (4000, 3))
    centers = rng.uniform(0, L, (40, 3))
    radii = rng.uniform(0.2, 1.0, 40) * radius
    radii[0] = radius
    counts, idx = native.cell_query(pos, L, centers, radii)
    lists = cKDTree(pos, boxsize=L).query_ball_point(centers, radii)
    assert counts.tolist() == [len(x) for x in lists]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s, c, want in zip(starts, counts, lists):
        assert sorted(idx[s:s + c].tolist()) == sorted(want)


def test_runner_counts_equal_ckdtree_where_cells_wrap(models):
    """The 3D runner's pairs, per halo, are cKDTree's within R_q."""
    _, tm = models[3]
    L = 128.0
    pos, hpos, M = _box(3, L, 2500, 12, (14.3, 15.0), 77)
    R_q = _query_radii(tm, M, 3, L)[1]
    tcat, tsnap_ = _objects(bf.utils, 3, L, pos, hpos, M)
    runner = bf.BaryonifySnapshot(tcat, tsnap_, epsilon_max=20, model=tm,
                                  device="cpu")
    (halos, offsets, _), _ = runner._neighbour_pairs(hpos, R_q)
    counts = np.zeros(len(M), dtype=np.int64)
    counts[halos.numpy()] = np.diff(offsets.numpy())
    lists = cKDTree(pos, boxsize=L).query_ball_point(hpos, R_q)
    assert counts.tolist() == [len(x) for x in lists]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_snapshot_displace_plain_matches_jax_one_halo(ndim, dt):
    """The plain version of K17 against the JAX one_halo arithmetic
    (SnapshotRunner.py:179-199, with BaryonificationClass.curve_lookup),
    summed per particle, on random pairs, curves and radius scales."""
    rng = np.random.default_rng(ndim)
    L, n, nh, n_r = 50.0, 400, 9, 20
    pos = rng.uniform(-0.5, L + 0.5, (n, ndim))
    hpos = rng.uniform(0, L, (nh, ndim))
    counts = rng.integers(0, 60, nh)
    counts[3] = 0
    parts = np.concatenate([rng.choice(n, c, replace=False) for c in counts])
    owner = np.repeat(np.arange(nh), counts)
    pos[parts[0]] = hpos[owner[0]]        # a particle at its halo's centre
    curves = rng.normal(size=(nh, n_r))
    curves[1, 4] = np.nan
    rscale = rng.uniform(0.5, 2.0, nh)
    eps_edge = rng.uniform(5, 30, nh)
    ln_r0, dlnr = float(np.log(0.05)), float(np.log(80 / 0.05) / (n_r - 1))
    npdt = np.float32 if dt == "f32" else np.float64
    jd = JDT[dt]

    @jax.jit
    def one_halo_pairs(p, hp, curve, rs, edge):
        dx = p - hp
        dx = jnp.where(dx > L / 2, dx - L, dx)
        dx = jnp.where(dx < -L / 2, dx + L, dx)
        d = jnp.sqrt(jnp.sum(dx ** 2, axis=-1))
        d_safe = jnp.where(d > 0, d, 1.0)
        d_l = jnp.where(d > 0, d, 1e-30).astype(jd)
        # each pair reads its own halo's curve, as one_halo does
        off = jax.vmap(lambda c, r: JBC.curve_lookup(c, ln_r0, dlnr, r))(
            curve, d_l * rs)
        off = jnp.where(d.astype(jd) < edge, off, 0.0)
        off = jnp.where(jnp.isfinite(off), off, 0.0)
        return off[:, None] * (dx / d_safe[:, None]).astype(jd)

    vec = np.asarray(one_halo_pairs(
        jnp.asarray(pos[parts]), jnp.asarray(hpos[owner]),
        jnp.asarray(curves.astype(npdt))[owner],
        jnp.asarray(rscale.astype(npdt))[owner],
        jnp.asarray(eps_edge.astype(npdt))[owner]), dtype=np.float64)
    want = np.zeros((ndim, n))
    for c in range(ndim):
        np.add.at(want[c], parts, vec[:, c])

    tdt = TDT[dt]
    from baryonforge_torch.ops.tiles import pairs_csr
    halos, offsets, tparts = (torch.as_tensor(x) for x in
                              pairs_csr(owner.astype(np.int32), parts))
    got = tsnap.snapshot_displace(
        torch.as_tensor(pos), torch.as_tensor(hpos), halos, offsets, tparts,
        torch.as_tensor(curves).to(tdt), ln_r0, dlnr,
        torch.as_tensor(rscale).to(tdt), torch.as_tensor(eps_edge).to(tdt),
        L)
    assert halos.numel() == nh - 1
    assert got.dtype == tdt
    if dt == "f32":
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-13 * np.abs(want).max())


def test_snapshot_catalog_in_place_mutation_rekeys(models):
    """tests/test_cache_invalidation.py:127-158 for the port: an in-place
    move of the catalog gives what a fresh runner gives."""
    _, tm = models[3]
    rng = np.random.default_rng(5)
    L, n_part, n_halo = 128.0, 3000, 25
    pos = rng.uniform(0, L, (n_part, 3))
    hpos = rng.uniform(0, L, (n_halo, 3))
    M = 10 ** rng.uniform(13.5, 14.6, n_halo)
    cat, snap = _objects(bf.utils, 3, L, pos, hpos, M)
    runner = bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=tm,
                                  dtype=torch.float64, device="cpu")
    out1 = runner.process()
    cat.cat["x"] = np.mod(cat.cat["x"] + 13.0, L)     # in-place move
    out2 = runner.process()
    moved = hpos.copy()
    moved[:, 0] = np.mod(hpos[:, 0] + 13.0, L)
    ref = bf.BaryonifySnapshot(*_objects(bf.utils, 3, L, pos, moved, M),
                               epsilon_max=20, model=tm,
                               dtype=torch.float64, device="cpu").process()
    assert not np.allclose(np.stack([out2[c] for c in "xyz"]),
                           np.stack([out1[c] for c in "xyz"]))
    for c in "xyz":
        np.testing.assert_allclose(out2[c], ref[c], rtol=1e-10, atol=1e-10)
    runner.invalidate()
    again = runner.process()
    for c in "xyz":
        np.testing.assert_array_equal(again[c], out2[c])


class _HideCurves:
    """A model without halo_curves: the direct per-pair readout."""

    def __init__(self, model):
        self._m = model

    def displacement(self, *args, **kw):
        return self._m.displacement(*args, **kw)


def test_snapshot_refusals(models):
    _, tm = models[3]
    pos, hpos, M = _box(3, 64.0, 100, 3, (13.5, 14.0), 9)
    cat, snap = _objects(bf.utils, 3, 64.0, pos, hpos, M)
    with pytest.raises(TypeError, match="mesh"):
        bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=tm,
                             mesh=object(), device="cpu")
    # no halo_curves: the direct readout, the curve path's moves in float64
    kw = dict(epsilon_max=20, dtype=torch.float64, device="cpu")
    curve = bf.BaryonifySnapshot(cat, snap, model=tm, **kw).process()
    direct = bf.BaryonifySnapshot(cat, snap, model=_HideCurves(tm),
                                  verbose=False, **kw).process()
    for c in "xyz":
        np.testing.assert_allclose(direct[c], curve[c], rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(TypeError, match="displacement"):
        bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=object(),
                             device="cpu").process()
    with pytest.raises(TypeError):
        bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=tm,
                             dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bf.BaryonifySnapshot(cat, snap, epsilon_max=20, model=tm)
