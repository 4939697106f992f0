"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
no jax, so it also runs where only torch is installed; the repository's
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float64 to 1e-10 of the largest value (atomic sums in another
order); float32 deposits to the JAX package's edge-jitter bounds
(tests/test_tiled_deposit.py:61-63); float32 regrids to the float32
weight noise, 1e-6 * nside of the largest source value.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402
from baryonforge_torch.ops import deposit, interp, regrid   # noqa: E402

pytestmark = pytest.mark.cuda

TABLE = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "_northstar_table.npz")
COSMO = dict(Omega_m=0.30, Omega_b=0.045, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model():
    return bf.Baryonification2D(
        None, None, bf.cosmo.cosmology_from_dict(COSMO),
        epsilon_max=20).load_table(TABLE)


def _inputs(nside, n, seed=7):
    """Bench-like halos, two at the poles, some near the caps, a third at
    the table's lowest masses (the fewer-than-4-pixels fallback)."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    dec[2:10] = rng.uniform(77, 84, 8) * rng.choice([-1, 1], 8)
    dec[0], dec[1] = 89.5, -89.5
    M = 10 ** rng.uniform(13.0, 14.8, n)
    M[2::3] = 10 ** rng.uniform(12.71, 12.8, M[2::3].size)
    z = rng.uniform(0.8, 1.0, n)
    cat = bf.utils.HaloLightConeCatalog(ra=ra, dec=dec, M=M, z=z,
                                        cosmo=COSMO)
    shell = bf.utils.LightconeShell(
        map=rng.exponential(1.0, 12 * nside * nside), cosmo=COSMO)
    return cat, shell


def _prep(nside, n, dt, dev):
    cat, shell = _inputs(nside, n)
    r = bf.BaryonifyShell(cat, shell, epsilon_max=20, model=_model(),
                          device=dev)
    hd = r._host_halo_data(bf.cosmo.cosmology_from_dict(r.cosmo))
    halos = r._halo_tensors(hd)
    m = _model().with_dtype(dt, device=dev)
    curves, r0, dl = interp.collapse_curves_plain(
        m._table, m._axes, 2, hd["M"], hd["a"], [], {})
    return shell, hd, m, halos, curves, float(r0), float(dl)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_collapse_curves_kernel(dev, dt):
    _, hd, m, _, cp, _, _ = _prep(64, 500, dt, dev)
    _build.reset_launches()
    ck, _, _ = interp.collapse_curves(m._table, m._axes, 2, hd["M"],
                                      hd["a"], [], {})
    assert _build.launches["collapse_curves"] == 1
    rel = 1e-6 if dt == torch.float32 else 1e-12
    torch.testing.assert_close(ck, cp, rtol=rel,
                               atol=rel * cp.abs().max().item())


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside,n", [(64, 300), (256, 400)])
def test_disc_deposit_kernel(dev, dt, nside, n):
    _, _, _, halos, curves, r0, dl = _prep(nside, n, dt, dev)
    _build.reset_launches()
    pk = deposit.disc_deposit(nside, halos, curves, r0, dl, 20)
    assert _build.launches["disc_deposit"] == 1
    pp = deposit.disc_deposit_plain(nside, halos, curves, r0, dl, 20)
    scale = pp.abs().max().item()
    assert scale > 0
    if dt == torch.float64:
        torch.testing.assert_close(pk, pp, rtol=0, atol=1e-10 * scale)
    else:
        torch.testing.assert_close(pk, pp, rtol=0, atol=0.02 * scale)
        assert (pk - pp).abs().sum() < 3e-3 * pp.abs().sum()


@pytest.mark.parametrize("pdt", DTYPES, ids=["po32", "po64"])
@pytest.mark.parametrize("rdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("nside", [64, 256])
def test_regrid_kernel(dev, pdt, rdt, nside):
    shell, _, _, halos, curves, r0, dl = _prep(nside, 300, pdt, dev)
    po = deposit.disc_deposit_plain(nside, halos, curves, r0, dl, 20)
    # and push the polar pixels through the poles
    theta = bf.ops.healpix.pix2ang(
        nside, torch.arange(12 * nside * nside, dtype=torch.int32,
                            device=dev))[0]
    cap = theta < 2.0 / nside
    po[cap, 0] = (-1.7 * theta[cap]).to(pdt)
    orig = torch.as_tensor(shell.map, device=dev).to(rdt)
    _build.reset_launches()
    ok = regrid.regrid(nside, po, orig)
    assert _build.launches["regrid"] == 1
    op = regrid.regrid_plain(nside, po, orig)
    if rdt == torch.float64:
        atol = 1e-9 * (op - orig).abs().max().item()
    else:
        atol = 1e-6 * nside * orig.abs().max().item()
    torch.testing.assert_close(ok, op, rtol=0, atol=atol)
    assert abs(ok.double().sum().item() / orig.double().sum().item()
               - 1) < 1e-5


def test_shell_cuda_matches_cpu(dev):
    """The whole scatter path on the card against the plain versions on
    the CPU, float64 (tests/test_tiled_deposit.py:80's bound)."""
    cat, shell = _inputs(64, 300)
    kw = dict(epsilon_max=20, model=_model(), dtype=torch.float64,
              regrid_dtype=torch.float64)
    _build.reset_launches()
    out_gpu = bf.BaryonifyShell(cat, shell, device=dev, **kw).process()
    assert all(_build.launches[k] == 1
               for k in ("collapse_curves", "disc_deposit", "regrid"))
    out_cpu = bf.BaryonifyShell(cat, shell, device="cpu", **kw).process()
    scale = np.abs(out_cpu - shell.map).max()
    np.testing.assert_allclose(out_gpu, out_cpu, rtol=0, atol=1e-9 * scale)
