"""What the port's runners recompute on every call and what they keep,
pinned as tests/test_cache_invalidation.py:50-127 and
tests/test_runners_extra.py:264 pin it for the JAX runners, on both the
curve path and the direct readout; and their ``verbose`` reports.

The port recomputes its per-catalog data on every call (host prep, curves
or the direct readout's rows); it keeps only per-NSIDE state, the Anis
shell's Mtot runner (keyed on the Mtot model's identity) and the
snapshot's pairs with their layouts, K23's included (keyed on the
catalog's content and the radii). So an
in-place change of the catalog or the map, a model swapped on a live
runner and a table rebuilt in place must each give what a new runner
gives (float64, to 1e-12 of the largest value).
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402

from test_torch_curves import COSMO_DICT, torch_model       # noqa: E402

NSIDE = 32
TSZ_TABLE = os.path.join(os.path.dirname(__file__), "data",
                         "tsz_bench_table.npz")


class HideCurves:
    """Only a model's readout surface: the runners read it directly."""

    def __init__(self, model):
        self._m = model

    def displacement(self, *args, **kwargs):
        return self._m.displacement(*args, **kwargs)

    def projected(self, *args, **kwargs):
        return self._m.projected(*args, **kwargs)


def _cat(n=30, seed=3):
    rng = np.random.default_rng(seed)
    return bf.utils.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
        M=10 ** rng.uniform(13.5, 14.8, n), z=rng.uniform(0.8, 1.0, n),
        cosmo=COSMO_DICT)


def _map(seed=23):
    return np.random.default_rng(seed).exponential(1.0, 12 * NSIDE ** 2)


def _shell_runner(cat, shell, model, direct):
    return bf.BaryonifyShell(cat, shell, epsilon_max=20,
                             model=HideCurves(model) if direct else model,
                             deposit="scatter", dtype=torch.float64,
                             device="cpu")


def _same(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("direct", [False, True], ids=["curves", "direct"])
def test_catalog_and_map_in_place_mutation(direct):
    """An in-place change of the catalog, then of the map, between calls of
    one runner: each call equals a new runner's."""
    model = torch_model()
    cat = _cat()
    shell = bf.utils.LightconeShell(map=_map(), cosmo=COSMO_DICT)
    runner = _shell_runner(cat, shell, model, direct)
    out1 = runner.process()
    cat.cat["ra"] = np.mod(cat.cat["ra"] + 40.0, 360.0)
    out2 = runner.process()
    fresh = _cat()
    fresh.cat["ra"] = cat.cat["ra"]
    _same(out2, _shell_runner(fresh, bf.utils.LightconeShell(
        map=_map(), cosmo=COSMO_DICT), model, direct).process())
    assert not np.allclose(out2, out1)
    shell.map[:] = _map(7)
    out3 = runner.process()
    _same(out3, _shell_runner(fresh, bf.utils.LightconeShell(
        map=_map(7), cosmo=COSMO_DICT), model, direct).process())
    assert not np.allclose(out3, out2)


@pytest.mark.parametrize("direct", [False, True], ids=["curves", "direct"])
def test_model_swap_and_table_rebuild(direct, tmp_path):
    """A model swapped on a live runner, then the new model's table rebuilt
    in place (load_table): each call equals a new runner's; the model's
    kept casts and K1 set-ups follow the rebuilt table."""
    model = torch_model()
    cat = _cat()
    shell = bf.utils.LightconeShell(map=_map(), cosmo=COSMO_DICT)
    runner = _shell_runner(cat, shell, model, direct)
    out1 = runner.process()
    model2 = copy.copy(model)
    model2._set_table(model.raw_input_d * 0.5, model.raw_input_z_range,
                      model.raw_input_M_range, model.raw_input_r_range, [],
                      [], model.Rdelta_sampling)
    runner.model = HideCurves(model2) if direct else model2
    out2 = runner.process()
    _same(out2, _shell_runner(cat, shell, model2, direct).process())
    assert not np.allclose(out2, out1)
    path = str(tmp_path / "t.npz")
    model.save_table(path)
    model2.load_table(path)          # the same object, the first table
    _same(runner.process(), out1)


def test_anis_shell_keeps_its_mtot_runner_by_identity():
    """The Anis shell keeps its nested Mtot paint runner while the Mtot
    model is the same object, re-pointed at the current catalog and map,
    and builds a new one for another object; its direct readout follows
    an in-place change of the map."""
    tab = bf.utils.TabulatedProfile(
        None, bf.cosmo.cosmology_from_dict(COSMO_DICT),
        mass_def=bf.cosmo.MassDef200c).load_table(TSZ_TABLE)
    tab.proj_cutoff = 100
    cat = _cat(20)
    shell = bf.utils.LightconeShell(map=_map(), cosmo=COSMO_DICT,
                                    redshift=0.9)
    runner = bf.PaintProfilesAnisShell(
        cat, shell, epsilon_max=20, model=HideCurves(tab),
        Tracer_model=HideCurves(tab), Mtot_model=tab, background_val=1.0,
        global_tracer_fraction=0.1, dtype=torch.float64, device="cpu")
    out1 = runner.process()
    first = runner._mtot[1]
    shell.map[:] = 3.0 * shell.map
    out2 = runner.process()
    assert runner._mtot[1] is first
    np.testing.assert_allclose(out2, 3.0 * out1, rtol=1e-10)
    runner.Mtot_model = copy.copy(tab)
    runner.process()
    assert runner._mtot[1] is not first


def test_snapshot_pairs_follow_the_catalog(monkeypatch):
    """BaryonifySnapshot's direct readout keeps its pairs and K23's layout
    (row slots, pieces, entry records) while the catalog's content holds,
    so a second call builds neither, and rebuilds both after an in-place
    change."""
    from baryonforge_torch.Runners import SnapshotRunner
    rng = np.random.default_rng(5)
    L = 128.0
    pos = rng.uniform(0, L, (2000, 3))
    snap = bf.utils.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                                     M=np.ones(len(pos)), L=L,
                                     cosmo=COSMO_DICT, redshift=0.9)
    hp = rng.uniform(0, L, (12, 3))
    cat = bf.utils.HaloNDCatalog(x=hp[:, 0], y=hp[:, 1], z=hp[:, 2],
                                 M=10 ** rng.uniform(13.5, 14.5, 12),
                                 redshift=0.9, cosmo=COSMO_DICT)
    kw = dict(epsilon_max=20, model=HideCurves(torch_model()),
              dtype=torch.float64, verbose=False, device="cpu")
    built = []
    layout_of = SnapshotRunner.direct_layout

    def counted(*args):
        built.append(1)
        return layout_of(*args)
    monkeypatch.setattr(SnapshotRunner, "direct_layout", counted)
    runner = bf.BaryonifySnapshot(cat, snap, **kw)
    out1 = runner.process()
    pairs = runner._pairs
    dlay = pairs[3]["direct"]
    assert len(built) == 1
    again = runner.process()
    assert runner._pairs is pairs and pairs[3]["direct"] is dlay
    assert len(built) == 1
    for c in "xyz":
        np.testing.assert_array_equal(again[c], out1[c])
    cat.cat["x"] = np.mod(cat.cat["x"] + 13.0, L)
    out2 = runner.process()
    assert runner._pairs is not pairs and len(built) == 2
    assert runner._pairs[3]["direct"] is not dlay
    ref = bf.BaryonifySnapshot(bf.utils.HaloNDCatalog(
        x=cat.cat["x"], y=hp[:, 1], z=hp[:, 2], M=cat.cat["M"],
        redshift=0.9, cosmo=COSMO_DICT), snap, **kw).process()
    for c in "xyz":
        np.testing.assert_allclose(out2[c], ref[c], rtol=0, atol=1e-12)
    n_built = len(built)
    runner.invalidate()
    runner.process()
    assert len(built) == n_built + 1


def test_verbose_reports(capsys):
    """``verbose`` prints the direct readout's row groups and the Anis
    shell's share of the matter density; by default nothing is printed."""
    tab = bf.utils.TabulatedProfile(
        None, bf.cosmo.cosmology_from_dict(COSMO_DICT),
        mass_def=bf.cosmo.MassDef200c).load_table(TSZ_TABLE)
    tab.proj_cutoff = 100
    cat = _cat(12)
    shell = bf.utils.LightconeShell(map=_map(), cosmo=COSMO_DICT,
                                    redshift=0.9)
    kw = dict(epsilon_max=20, model=HideCurves(tab),
              Tracer_model=HideCurves(tab), Mtot_model=tab,
              background_val=1.0, global_tracer_fraction=0.1, device="cpu")
    bf.PaintProfilesAnisShell(cat, shell, **kw).process()
    assert capsys.readouterr().out == ""
    bf.PaintProfilesAnisShell(cat, shell, verbose=True, **kw).process()
    out = capsys.readouterr().out
    assert "of the total matter density" in out
    assert "direct readout:" in out and "group 1/" in out
