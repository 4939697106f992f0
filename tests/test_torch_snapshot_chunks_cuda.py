"""The snapshot's cell list on the card (K24) against its plain version and
the host searches, and BaryonifySnapshot in chunks against its one-chunk
run, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
no jax; run it on the card as

    python -m pytest --noconftest -m cuda tests/test_torch_snapshot_chunks_cuda.py

Tolerances: the wrapped positions bitwise np.mod's; the neighbour sets
equal halo for halo (the order within a halo's row is free); a run in
chunks bitwise the one-chunk run, curve and direct paths, float32 and
float64.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import native                        # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import snapshot                  # noqa: E402
from baryonforge_torch.Runners import SnapshotRunner        # noqa: E402

pytestmark = pytest.mark.cuda

COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
# the bench's Schneider19 parameters (bench.py:42-55, h 0.7)
BPAR = dict(theta_ej=4, theta_co=0.1, M_c=1e14 / 0.7, mu_beta=0.4,
            eta=0.3, eta_delta=0.3, tau=-1.5, tau_delta=0, A=0.09 / 2,
            M1=2.5e11 / 0.7, epsilon_h=0.015, a=0.3, n=2, epsilon=4, p=0.3,
            q=0.707, gamma=2, delta=7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sets(counts, parts):
    off = np.concatenate([[0], np.cumsum(counts)])
    return [sorted(parts[a:b].tolist()) for a, b in zip(off, off[1:])]


def _k24(pos, L, centers, radii, dev, chunks=3):
    """K24's pairs: (counts, parts) on the host, the write pass run on
    ``chunks`` runs of the halos in turn."""
    ncell = snapshot.cell_grid(len(pos), pos.shape[1], L, radii)[0]
    cells = snapshot.cell_build(torch.as_tensor(pos, device=dev), L, ncell)
    q = snapshot.cell_count(cells, centers, radii)
    cuts = np.linspace(0, len(radii), chunks + 1).astype(int)
    parts = np.concatenate([snapshot.cell_write(cells, q, a, b).cpu().numpy()
                            for a, b in zip(cuts, cuts[1:])])
    return cells, np.diff(q.offsets), parts


def test_k24_wraps_as_np_mod(dev):
    L = 64.0
    rng = np.random.default_rng(1)
    pos = rng.uniform(-2 * L, 3 * L, (20000, 3))
    pos[:4, 0] = [-1e-17, -L, L, 2 * L - 1e-13]
    cells = snapshot.cell_build(torch.as_tensor(pos, device=dev), L, 7)
    got = np.empty_like(pos)
    got[cells.orig.cpu().numpy()] = cells.pos.cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int64),
                                  np.mod(pos, L).view(np.int64))
    start = cells.start.cpu().numpy()
    assert start[0] == 0 and start[-1] == len(pos)
    assert np.all(np.diff(start) >= 0)


@pytest.mark.parametrize("radius", [10.0, 20.0, 30.0, 35.0, 46.0])
def test_k24_equals_host_cell_list_3d(dev, radius):
    rng = np.random.default_rng(int(radius))
    L = 128.0
    pos = rng.uniform(-0.2 * L, 1.2 * L, (40000, 3))
    centers = rng.uniform(0, L, (64, 3))
    radii = rng.uniform(0.2, 1.0, 64) * radius
    radii[0] = radius
    _build.reset_launches()
    _, counts, parts = _k24(pos, L, centers, radii, dev)
    assert dict(_build.launches) == {"cell_build": 2, "cell_count": 1,
                                     "cell_write": 3}
    want_c, want_p = native.cell_query(pos, L, centers, radii)
    assert counts.tolist() == want_c.tolist()
    assert _sets(counts, parts) == _sets(want_c, want_p)
    pc, _, pp = snapshot.cell_query_plain(
        torch.as_tensor(pos, device=dev), L,
        torch.as_tensor(centers, device=dev),
        torch.as_tensor(radii, device=dev))
    assert pc.tolist() == want_c.tolist()
    assert _sets(counts, pp.cpu().numpy()) == _sets(counts, parts)


@pytest.mark.parametrize("radius", [8.0, 40.0])
def test_k24_equals_ckdtree_2d(dev, radius):
    rng = np.random.default_rng(int(radius) + 7)
    L = 96.0
    pos = rng.uniform(-10, L + 10, (30000, 2))
    centers = rng.uniform(0, L, (48, 2))
    radii = rng.uniform(0.2, 1.0, 48) * radius
    _, counts, parts = _k24(pos, L, centers, radii, dev)
    lists = cKDTree(np.mod(pos, L), boxsize=L).query_ball_point(
        np.mod(centers, L), radii)
    assert counts.tolist() == [len(x) for x in lists]
    assert _sets(counts, parts) == [sorted(x) for x in lists]


def _model(dev):
    P = bf.Profiles
    return bf.Baryonification3D(
        P.DarkMatter(**BPAR), P.DarkMatter(**{**BPAR, "epsilon": 2.0}),
        bf.cosmo.cosmology_from_dict(COSMO), epsilon_max=20,
        device=dev).setup_interpolator(
            z_min=0.1, z_max=0.3, N_samples_z=2, M_min=5e12, M_max=2e15,
            N_samples_Mass=6, R_min=1e-3, R_max=50, N_samples_R=32,
            verbose=False)


class _Hide:
    def __init__(self, m):
        self._m = m

    def displacement(self, *a, **k):
        return self._m.displacement(*a, **k)


@pytest.mark.parametrize("direct", [False, True], ids=["curve", "direct"])
def test_chunked_runner_equals_one_chunk_on_card(dev, monkeypatch, direct):
    rng = np.random.default_rng(4)
    L = 96.0
    n, nh = 30000, 80
    cols = {c: rng.uniform(0, L, n) for c in "xyz"}
    snap = bf.utils.ParticleSnapshot(**cols, M=np.ones(n), L=L, cosmo=COSMO,
                                     redshift=0.2)
    cat = bf.utils.HaloNDCatalog(
        **{c: rng.uniform(0, L, nh) for c in "xyz"},
        M=10 ** rng.uniform(13.0, 15.2, nh), redshift=0.2, cosmo=COSMO)
    model = _model(dev)
    for dt in (torch.float32, torch.float64):
        kw = dict(epsilon_max=20, model=_Hide(model) if direct else model,
                  dtype=dt, verbose=False, device=dev)
        one = bf.BaryonifySnapshot(cat, snap, **kw)
        want = one.process()
        n_pairs = int(one._pairs[1][-1])
        with monkeypatch.context() as m:
            m.setattr(SnapshotRunner, "PAIR_BUDGET", n_pairs // 5)
            _build.reset_launches()
            runner = bf.BaryonifySnapshot(cat, snap, **kw)
            got = runner.process()
            assert len(runner._shard_chunks(1)[0]) >= 4
        assert _build.launches["cell_write"] >= 4
        for c in "xyz":
            np.testing.assert_array_equal(got[c], want[c])
