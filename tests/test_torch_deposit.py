"""Scatter phase A of the torch port (plain version of kernel K2) against
the JAX runner's scatter body.

The JAX side runs the runner's own private pieces, unchanged:
``_host_halo_data``, ``_halo_curve_arrays``, ``_make_body_factory``, and
the two halves of ``_bucketed_accumulate`` (``_prepare_groups``,
``_scan_accumulate``). The port's ``disc_deposit`` gets the same halo
columns and curves and must give the same (npix, 2) offsets.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import Runners, utils                  # noqa: E402
from baryonforge_tpu.cosmo.core import cosmology_from_dict  # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops.deposit import (disc_deposit,    # noqa: E402
                                           disc_deposit_plain)

from test_torch_curves import COSMO_DICT, jax_model        # noqa: E402


def make_inputs(nside, n_halos, seed=7, low_mass=False, n_cap=0):
    """Catalog and mass map as the bench makes them (bench.py:94-102), at a
    small size, with two halos at dec +-89.5 for the polar caps. With
    ``low_mass`` a third of the halos sit at the table's lowest masses,
    whose discs hold fewer than 4 pixels (the interpolation-neighbour
    fallback); ``n_cap`` of them move to |dec| in [77, 84] deg."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halos)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n_halos)))
    dec[2:2 + n_cap] = rng.uniform(77, 84, n_cap) * rng.choice([-1, 1], n_cap)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n_halos)
    if low_mass:
        M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.8, 1.0, n_halos)
    cat = utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                     cosmo=COSMO_DICT)
    shell = utils.LightconeShell(map=rng.exponential(1.0, 12 * nside ** 2),
                                 cosmo=COSMO_DICT)
    return cat, shell


def jax_phase_a(cat, shell, model, jdt):
    """Offsets (npix, 2) from the JAX runner's scatter phase A, plus the
    halo columns and curves it used.

    This is ``_bucketed_accumulate`` spelled out, with each window size
    passed as ``extra_key``: that method caches the compiled scan by the
    batch arrays' shapes alone, so a second size bucket whose batches have
    the shapes of an earlier one reuses the earlier bucket's (smaller)
    disc window and drops the outer pixels of its discs (ROADMAP Queue 3).
    """
    r = Runners.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                               deposit="scatter", regrid="scatter",
                               dtype=jdt, halo_batch=64, verbose=False)
    nside = shell.NSIDE
    npix = 12 * nside ** 2
    r._refresh_tokens()
    hd = r._host_halo_data(cosmology_from_dict(r.cosmo))
    curves, Rcom, rscale, ln_r0, dlnr = r._halo_curve_arrays(hd)
    make_body = r._make_body_factory(nside, npix, [], (ln_r0, dlnr))
    acc = 0.0
    for K_ring, K_phi, batches in r._prepare_groups(
            hd, [curves, Rcom, rscale], nside):
        acc = acc + np.asarray(r._scan_accumulate(
            make_body(K_ring, K_phi), batches, (2 * (npix + 1),), jdt,
            extra_key=(K_ring, K_phi)))
    po = np.stack([acc[:npix], acc[npix + 1:2 * npix + 1]], axis=1)
    halos = {"theta": hd["theta"], "phi": hd["phi"], "radius": hd["radius"],
             "D": hd["D"], "a": hd["a"], "Rcom": Rcom, "rscale": rscale}
    return po, halos, np.asarray(curves), ln_r0, dlnr


def torch_halos(halos):
    return {k: torch.tensor(np.asarray(v, dtype=np.float64))
            for k, v in halos.items()}


def _counts(nside, halos):
    """Disc member counts per halo (the plain version's padded query)."""
    from baryonforge_torch.ops import healpix as hpx
    t = torch_halos(halos)
    K_ring, K_phi = hpx.disc_pad_sizes(nside, float(t["radius"].max()))
    mask = hpx.disc_candidates(nside, t["theta"], t["phi"], t["radius"],
                               K_ring, K_phi, torch.float64)[5]
    return mask.sum(1).numpy()


CASES = [(64, 120, False), (64, 90, True), (256, 200, True)]
CASE_IDS = ["nside64", "nside64-fallback", "nside256-fallback"]


@pytest.mark.parametrize("nside,n_halos,low_mass", CASES, ids=CASE_IDS)
def test_deposit_f64_matches_jax(nside, n_halos, low_mass):
    """float64: rtol 1e-10, with an absolute floor of 1e-12 of the largest
    offset for pixels where offsets of opposite sign cancel (the two
    scatters sum in different orders)."""
    cat, shell = make_inputs(nside, n_halos, low_mass=low_mass)
    po_j, halos, curves, ln_r0, dlnr = jax_phase_a(cat, shell, jax_model(),
                                                   jnp.float64)
    if low_mass:
        assert (_counts(nside, halos) < 4).any(), "fallback not exercised"
    _build.reset_launches()
    po_t = disc_deposit(nside, torch_halos(halos), torch.tensor(curves),
                        ln_r0, dlnr, 20)
    assert not _build.launches        # CPU tensors: the plain version
    assert po_t.dtype == torch.float64 and po_t.shape == po_j.shape
    assert np.abs(po_j).max() > 0
    np.testing.assert_allclose(po_t.numpy(), po_j, rtol=1e-10,
                               atol=1e-12 * np.abs(po_j).max())


@pytest.mark.parametrize("nside,n_halos,low_mass", CASES, ids=CASE_IDS)
def test_deposit_f32_matches_jax(nside, n_halos, low_mass):
    """float32 against the JAX runner's float32, and both against its
    float64 result.

    The float32 offsets carry ~1e-3 of the largest offset of rounding
    error in either package (the tangent projection ct0 sin_t - st0 cos_t
    cos dphi cancels for pixels near the centre, and XLA contracts a*b+c
    under jit where torch rounds twice), so the two float32 results differ
    by up to ~4e-4 of it, not 1e-5. They are held to the JAX package's own
    bounds instead: its edge-jitter bounds against each other
    (tests/test_tiled_deposit.py:61-63: 0.02 of the largest offset per
    pixel, 3e-3 of the total offset summed), and the port's error against
    the float64 result no larger than 1.25 times the JAX float32 error, per
    pixel and summed over pixels, or than the float32 noise level of 1e-3
    of the largest (summed) offset where that is larger: with few moved
    pixels, one pixel where the JAX error happens to be small says
    nothing."""
    cat, shell = make_inputs(nside, n_halos, low_mass=low_mass)
    po_j, halos, curves, ln_r0, dlnr = jax_phase_a(cat, shell, jax_model(),
                                                   jnp.float32)
    po_64 = jax_phase_a(cat, shell, jax_model(), jnp.float64)[0]
    po_t = disc_deposit(nside, torch_halos(halos), torch.tensor(curves),
                        ln_r0, dlnr, 20).numpy()
    assert po_t.dtype == np.float32
    scale = np.abs(po_j).max()
    assert scale > 0
    np.testing.assert_allclose(po_t, po_j, atol=0.02 * scale)
    assert np.abs(po_t - po_j).sum() < 3e-3 * np.abs(po_j).sum()
    err_t, err_j = np.abs(po_t - po_64), np.abs(po_j - po_64)
    assert err_t.max() <= max(1.25 * err_j.max(), 1e-3 * scale)
    assert err_t.sum() <= max(1.25 * err_j.sum(),
                              1e-3 * np.abs(po_64).sum())
    # the moved pixels are the same, up to a disc-edge flip or two
    flips = ((po_t != 0) != (po_j != 0)).any(axis=1).sum()
    assert flips <= 1e-3 * (po_j != 0).any(axis=1).sum() + 1


def test_plain_chunks_do_not_change_the_sum():
    """Cutting the halos into more, smaller windowed chunks only changes
    the summation order."""
    nside = 64
    cat, shell = make_inputs(nside, 60, low_mass=True)
    _, halos, curves, ln_r0, dlnr = jax_phase_a(cat, shell, jax_model(),
                                                jnp.float64)
    th, c = torch_halos(halos), torch.tensor(curves)
    one = disc_deposit_plain(nside, th, c, ln_r0, dlnr, 20)
    many = disc_deposit_plain(nside, th, c, ln_r0, dlnr, 20,
                              pixel_budget=2000)
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-12,
                               atol=1e-14 * one.abs().max().item())


def test_deposit_rejects_bad_inputs():
    halos = {k: torch.zeros(3, dtype=torch.float64)
             for k in ("theta", "phi", "radius", "D", "a", "Rcom", "rscale")}
    curves = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="NSIDE"):
        disc_deposit(16384, halos, curves, 0.0, 0.1, 20)
    with pytest.raises(ValueError, match="float64"):
        disc_deposit(16, dict(halos, D=torch.zeros(3)), curves, 0.0, 0.1, 20)
    with pytest.raises(TypeError):
        disc_deposit(16, halos, curves.half(), 0.0, 0.1, 20)
