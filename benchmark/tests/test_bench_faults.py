"""A run, the look for a card skipped, at a tiny size on the CPU: sound, it
comes out correct; with the timed path broken underneath it comes out not
correct, once for each fault a shell cell can have (a call that returns
its input unchanged, half of the halos left out, an answer altered where
it is produced). The cells run on one card, so there is no exchange
between cards to leave out."""

import numpy as np
import pytest

from benchmark import harness

SEED = 2 ** 31 + 23


def _run(tiny, cell, trace=0):
    man, dirs = tiny
    return harness.run_cell(cell, SEED, 0.5, trace, device="cpu",
                            manifest=man, dirs=dirs, log=lambda m: None)


def _runner_class(cell):
    from baryonforge_torch.Runners import BaryonifyShell, PaintProfilesShell
    return PaintProfilesShell if cell.startswith("tsz") else BaryonifyShell


def _unchanged(orig):
    def process(self):
        return np.asarray(self.LightconeShell.map, dtype=np.float64).copy()
    return process


def _half(orig):
    def process(self):
        cat = self.HaloLightConeCatalog
        self.HaloLightConeCatalog = cat[: len(cat) // 2]
        return orig(self)
    return process


def _altered(orig):
    def process(self):
        out = orig(self)
        out[int(np.argmax(out))] += np.abs(out).max()
        return out
    return process


CELLS = ["s19_shell_tiny.tiny", "tsz_paint_tiny.tiny"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"halos_per_s", "setup_s"}
    assert not harness.forbidden()


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    cls = _runner_class(cell)
    monkeypatch.setattr(cls, "process", fault(cls.process))
    r = _run(tiny, cell)
    assert not r["correct"], r["checks"]
