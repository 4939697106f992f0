"""The grid runners' direct readout (models without halo_curves, or whose
halo_curves raises) against the JAX runners' direct branch on the CPU:
BaryonifyGrid 2D (with ellipticity) and 3D, PaintProfilesGrid 2D and 3D
and PaintProfilesAnisGrid (the plain versions of K22, then K16 or K14),
each given models wrapped to show only their readout, on the catalogs and
models of tests/test_torch_grid.py.

Tolerances (tests/test_torch_grid.py's): float64 to 1e-10 of the largest
value (of the largest move for BaryonifyGrid), float32 to the JAX
package's bound between two float32 paints (rtol 2e-2, atol 2e-5 of the
largest value). Every JAX runner runs with n_size_buckets=1 (its scan is
keyed on the batch shapes, not the cutout size: ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_tpu.Runners import Map2DRunner as JMap     # noqa: E402
from baryonforge_torch.ops import _build                    # noqa: E402

from test_torch_grid import JDT, TDT, grid_inputs, models  # noqa: F401,E402


class HideCurves:
    """Only a model's readout surface: the runners read it directly."""

    def __init__(self, model):
        self._m = model

    def displacement(self, *args, **kwargs):
        return self._m.displacement(*args, **kwargs)

    def projected(self, *args, **kwargs):
        return self._m.projected(*args, **kwargs)

    def real(self, *args, **kwargs):
        return self._m.real(*args, **kwargs)


class RaisingCurves(HideCurves):
    """A model whose halo_curves raises NotImplementedError: the JAX grid
    runners then read it directly (Map2DRunner.py:348-363, 540-550)."""

    def halo_curves(self, *args, **kwargs):
        raise NotImplementedError("no curves for this model")


def _run(which, pkg, models, cat, gm, dt, wrap=HideCurves, **extra):
    m = {k: wrap(v[0 if pkg == "jax" else 1]) for k, v in models.items()}
    if which == "baryonify":
        kw = dict(epsilon_max=20, model=m["s19"])
    elif which == "paint":
        kw = dict(epsilon_max=5, model=m["dm"])
    else:
        kw = dict(epsilon_max=5, model=m["dm"], Tracer_model=m["dm"],
                  Mtot_model=models["dm"][0 if pkg == "jax" else 1],
                  background_val=1.0, global_tracer_fraction=0.1)
    kw.update(n_size_buckets=1, **extra)
    if pkg == "jax":
        cls = {"baryonify": JMap.BaryonifyGrid,
               "paint": JMap.PaintProfilesGrid,
               "anis": JMap.PaintProfilesAnisGrid}[which]
        return np.asarray(cls(cat, gm, dtype=JDT[dt], verbose=False,
                              **kw).process(), dtype=np.float64)
    cls = {"baryonify": bf.BaryonifyGrid, "paint": bf.PaintProfilesGrid,
           "anis": bf.PaintProfilesAnisGrid}[which]
    r = cls(cat, gm, dtype=TDT[dt], device="cpu", **kw)
    return r.process(), r


RUNS = [("baryonify", 2, True, "f64"), ("baryonify", 3, False, "f64"),
        ("baryonify", 3, False, "f32"), ("paint", 2, False, "f64"),
        ("paint", 3, False, "f64"), ("anis", 2, False, "f64")]


@pytest.mark.parametrize("which,ndim,ell,dt", RUNS,
                         ids=[f"{w}-{d}d{'-ell' if e else ''}-{t}"
                              for w, d, e, t in RUNS])
def test_direct_grid_matches_jax(models, which, ndim, ell, dt):
    """Each grid runner's direct readout on the CPU against the JAX
    runner's direct branch."""
    z = 0.9 if which == "baryonify" else 0.2
    npix, L = (48, 48.0) if ndim == 2 else (16, 32.0)
    (jcat, jgm), (tcat, tgm) = grid_inputs(ndim, npix, L, 8, z,
                                           seed=40 + ndim, ell=ell)
    ref = _run(which, "jax", models, jcat, jgm, dt, use_ellipticity=ell)
    _build.reset_launches()
    out, r = _run(which, "torch", models, tcat, tgm, dt,
                  use_ellipticity=ell)
    assert not _build.launches         # CPU: the plain versions
    assert {"radii", "readout", "apply"} <= set(r.timings)
    if which == "baryonify":
        scale = np.abs(ref - tgm.map).max()
        np.testing.assert_allclose(out.sum(), tgm.map.sum(), rtol=1e-10)
    else:
        scale = np.abs(ref).max()
    assert scale > 0
    if dt == "f64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-5 * scale)


@pytest.mark.parametrize("which", ["baryonify", "paint"])
def test_raising_halo_curves_reads_directly(models, which):
    """A model whose halo_curves raises NotImplementedError takes the
    direct readout, as the JAX grid runners do: the map of a model without
    halo_curves."""
    (_, _), (tcat, tgm) = grid_inputs(2, 32, 32.0, 6, 0.9 if which ==
                                      "baryonify" else 0.2, seed=5)
    a, _ = _run(which, "torch", models, tcat, tgm, "f64")
    b, r = _run(which, "torch", models, tcat, tgm, "f64", wrap=RaisingCurves)
    assert "readout" in r.timings
    assert np.abs(a - (tgm.map if which == "baryonify" else 0)).max() > 0
    np.testing.assert_array_equal(a, b)
