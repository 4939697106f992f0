"""The control kept as a test, at a size a test run holds: on the card, the
plain reference put in the program's place in the next precision below
the configuration's fails at least one of the cell's limits on three
seeds, while the program's own readings pass them. The control's own
readings at the cells' sizes come from ``benchmark/control.py`` on the
card (PERF.md). The same readings on the CPU, where the program runs its
plain versions, check ``control.py`` itself."""

import pytest

from benchmark import control

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _fails(cfg_checks, numbers):
    return any(not (v <= cfg_checks[k]) for k, v in numbers.items())


@pytest.mark.parametrize("where", [
    "cpu", pytest.param("card", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", ["s19_shell_tiny.tiny",
                                  "tsz_paint_tiny.tiny"])
def test_control_fails_and_program_passes(request, tiny, cell, where):
    from benchmark import harness
    device = request.getfixturevalue("card") if where == "card" else "cpu"
    man, dirs = tiny
    cfg, _ = harness.load_config(harness.find_cell(man, cell)["config"],
                                 dirs)
    r = control.readings(cell, SEEDS, SEEDS, device=device, manifest=man,
                         dirs=dirs, log=lambda s: None)
    assert all(_fails(cfg["checks"], n) for n in r["control"])
    assert not any(_fails(cfg["checks"], n) for n in r["program"])
