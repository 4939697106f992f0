"""BaryonifySnapshot's direct readout (a model without halo_curves: the
plain versions of K23) against the JAX runner's direct branch
(SnapshotRunner.py:196) on the CPU, in the boxes and with the models of
tests/test_torch_snapshot.py.

Tolerances (tests/test_torch_snapshot.py's): float32 to
tests/test_snapshot.py:67 (atol 5e-4, rtol 1e-3), float64 to 1e-10 of the
largest displacement. A new JAX runner is built for each configuration:
its compiled step bakes the snapshot's a in and is keyed on the model
token, not on the redshift (ROADMAP Queue 3); the 3D box keeps every query
radius under L / 3, where the JAX cell list visits a cell once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.Runners.SnapshotRunner import \
    BaryonifySnapshot as JSnapshot                          # noqa: E402
import baryonforge_torch as bf                              # noqa: E402

from test_torch_snapshot import (BOXES, JDT, TDT, _box, _close,  # noqa: E402
                                 _moves, _objects, _query_radii, models)


class HideCurves:
    """Only a model's displacement: the runners read it per pair."""

    def __init__(self, model):
        self._m = model

    def displacement(self, *args, **kwargs):
        return self._m.displacement(*args, **kwargs)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("ndim", [3, 2])
def test_direct_snapshot_matches_jax(models, ndim, dt):
    jm, tm = models[ndim]
    _, L, n, nh, logM, seed = BOXES[ndim]
    pos, hpos, M = _box(ndim, L, n, nh, logM, seed)
    assert ndim == 2 or _query_radii(tm, M, ndim, L)[1].max() <= L / 3
    jcat, jsnap = _objects(JUtils, ndim, L, pos, hpos, M)
    tcat, tsnap = _objects(bf.utils, ndim, L, pos, hpos, M)
    want = _moves(JSnapshot(jcat, jsnap, epsilon_max=20,
                            model=HideCurves(jm), verbose=False,
                            dtype=JDT[dt]).process(), pos, L)
    runner = bf.BaryonifySnapshot(tcat, tsnap, epsilon_max=20,
                                  model=HideCurves(tm), dtype=TDT[dt],
                                  verbose=False, device="cpu")
    out = runner.process()
    assert np.abs(want).max() > 0.05
    _close(_moves(out, pos, L), want, dt)
    assert {k for k in runner.timings if "." not in k} == {
        "host_prep", "neighbours", "radii", "readout", "apply", "download"}


def test_direct_snapshot_equals_curve_path(models):
    """On the CPU the direct readout of a table moves the particles as its
    curve path does, float64, to 1e-12 of the largest move."""
    _, tm = models[3]
    _, L, n, nh, logM, seed = BOXES[3]
    pos, hpos, M = _box(3, L, n, nh, logM, seed + 10)
    tcat, tsnap = _objects(bf.utils, 3, L, pos, hpos, M)
    kw = dict(epsilon_max=20, dtype=torch.float64, device="cpu")
    curve = _moves(bf.BaryonifySnapshot(tcat, tsnap, model=tm,
                                        **kw).process(), pos, L)
    got = _moves(bf.BaryonifySnapshot(tcat, tsnap, model=HideCurves(tm),
                                      verbose=False, **kw).process(), pos, L)
    assert np.abs(curve).max() > 0
    np.testing.assert_allclose(got, curve, rtol=0,
                               atol=1e-12 * np.abs(curve).max())
