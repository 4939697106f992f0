"""Tiled phase A of the torch port (plain version of kernel K4) against
baryonforge_tpu.ops.tiles.make_tile_deposit(mode="displace").

The JAX side runs its own pieces unchanged: bin_halos_to_tiles,
refine_pairs, bucket_tiles and the deposit kernel with the direct lerp
(``lookup="gather"``, the JAX package's choice off the TPU). The port's
``tile_deposit`` gets the same halo pack and the CSR grouping of the same
pairs. Halos are multi-tile discs made from a seed, with curves from the
bench's displacement table, two of them at the poles.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import tiles as jt                 # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import tiles as tt               # noqa: E402
from baryonforge_torch.ops.tile_deposit import (            # noqa: E402
    tile_deposit, PACK_KEYS)

from test_torch_curves import jax_model                     # noqa: E402


def deposit_inputs(nside, n=60, seed=31):
    """Host pack (float64 numpy), the pairs and the curve grid: discs of
    2-12 pixels radius at distances where most of each disc lies on the
    table's radial range."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    theta[:2] = [0.01, np.pi - 0.02]
    phi = rng.uniform(0, 2 * np.pi, n)
    radius = rng.uniform(2.0, 12.0, n) * np.pi / (2 * nside)
    a = rng.uniform(0.5, 0.56, n)
    M = 10 ** rng.uniform(13.2, 14.8, n)
    curves, ln_r0, dlnr = jax_model().halo_curves(M, a)
    # D so that the disc edge sits near the table's largest radius
    D = (a * np.exp(float(ln_r0) + 60 * float(dlnr))
         / (2 * np.sin(radius / 2)))
    st = np.sin(theta)
    vh = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], 1)
    chord = 2.0 * np.sin(np.minimum(radius, np.pi) / 2.0)
    pack = dict(vh=vh, crit2=chord ** 2, lnDa=np.log(D / a),
                invD=1.0 / D, afac=a, curves=np.array(curves))
    tiling_j = jt.SkyTiling(nside)
    t_ids, h_ids = jt.bin_halos_to_tiles(tiling_j, theta, phi, radius)
    _, near = jt.refine_pairs(tiling_j, t_ids, h_ids, vh, chord)
    return tiling_j, pack, near, float(ln_r0), 1.0 / float(dlnr)


def jax_tile_deposit(tiling, pack, near, ln_r0, inv_dlnr, jdt):
    run = jt.make_tile_deposit(tiling, pack["curves"].shape[1],
                               mode="displace", dtype=jdt, lookup="gather")
    jpack = {k: jnp.asarray(v if k == "vh" else v.astype(np.dtype(jdt)))
             for k, v in pack.items()}
    acc = np.zeros((tiling.n_tiles, tiling.RB * tiling.K, 2),
                   np.dtype(jdt))
    for bucket in jt.bucket_tiles(*near):
        tids, out = run(bucket, jpack, ln_r0, inv_dlnr)
        acc[tids] += np.asarray(out)
    return acc


def torch_tile_deposit(nside, pack, near, ln_r0, inv_dlnr, tdt):
    tiling = tt.SkyTiling(nside)
    csr = tuple(torch.as_tensor(x) for x in tt.pairs_csr(*near))
    tpack = {k: torch.as_tensor(v, dtype=torch.float64 if k == "vh"
                                else tdt) for k, v in pack.items()}
    return tile_deposit(tiling, csr, tpack, ln_r0, inv_dlnr)


@pytest.fixture(scope="module", params=[64, 256], ids=["nside64",
                                                       "nside256"])
def case(request):
    nside = request.param
    tiling, pack, near, ln_r0, inv = deposit_inputs(nside)
    ref = {dt: jax_tile_deposit(tiling, pack, near, ln_r0, inv, jdt)
           for dt, jdt in (("f64", jnp.float64), ("f32", jnp.float32))}
    return nside, pack, near, ln_r0, inv, ref


def test_tile_deposit_f64_matches_jax(case):
    """float64: atol 1e-9 of the largest offset
    (tests/test_tiled_deposit.py:80's bound)."""
    nside, pack, near, ln_r0, inv, ref = case
    _build.reset_launches()
    acc = torch_tile_deposit(nside, pack, near, ln_r0, inv, torch.float64)
    assert not _build.launches          # CPU tensors: the plain version
    j = ref["f64"]
    assert acc.shape == j.shape and acc.dtype == torch.float64
    scale = np.abs(j).max()
    assert scale > 0 and (j != 0).any(axis=2).sum() > 1000
    np.testing.assert_allclose(acc.numpy(), j, rtol=0, atol=1e-9 * scale)
    # dead slots and untouched tiles hold exact zeros, as in the JAX result
    np.testing.assert_array_equal(acc.numpy() == 0, j == 0)


def test_tile_deposit_f32_matches_jax(case):
    """float32: the JAX package's edge-jitter bounds against the JAX
    float32 result (tests/test_tiled_deposit.py:61-63), and the port's
    error against the JAX float64 result no larger than 1.25 times the JAX
    float32 error, per slot and summed."""
    nside, pack, near, ln_r0, inv, ref = case
    acc = torch_tile_deposit(nside, pack, near, ln_r0, inv,
                             torch.float32).numpy()
    j32, j64 = ref["f32"], ref["f64"]
    assert acc.dtype == np.float32
    scale = np.abs(j64).max()
    np.testing.assert_allclose(acc, j32, rtol=0, atol=0.02 * scale)
    assert np.abs(acc - j32).sum() < 3e-3 * np.abs(j32).sum()
    err_t, err_j = np.abs(acc - j64), np.abs(j32 - j64)
    assert err_t.max() <= max(1.25 * err_j.max(), 1e-6 * scale)
    assert err_t.sum() <= 1.25 * err_j.sum()


def test_tile_deposit_rejects_bad_inputs():
    nside = 32
    tiling = tt.SkyTiling(nside)
    pack = {k: torch.zeros((3, 3) if k == "vh" else
                           (3, 8) if k == "curves" else (3,),
                           dtype=torch.float64) for k in PACK_KEYS}
    csr = (torch.zeros(0, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32),
           torch.zeros(0, dtype=torch.int32))
    assert not tile_deposit(tiling, csr, pack, 0.0, 1.0).any()
    with pytest.raises(ValueError, match="crit2"):
        tile_deposit(tiling, csr, dict(pack, crit2=torch.zeros(3)), 0.0, 1.0)
    with pytest.raises(ValueError, match="offsets"):
        tile_deposit(tiling, (csr[0], csr[1][:0], csr[2]), pack, 0.0, 1.0)
