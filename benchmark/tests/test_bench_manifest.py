"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, and every name it cites resolving to a file under benchmark/."""

import json
import re

import pytest

from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = ROOT / "benchmark"


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(w) for w in MANIFEST["command"])
    assert (ROOT / MANIFEST["command"][1]).exists()


def test_run_seconds_fits_a_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_valid(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_resolve():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = ROOT / c["file"]
        assert path.is_relative_to(BENCH) and path.exists()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert (BENCH / "configs" / f"{cfg.get('module', c['name'])}.py"
                ).exists()
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(cfg["checks"]), "a configuration compares something"


def test_workloads_resolve():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs


def test_metrics_resolve_and_are_sound():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        src = (BENCH / "metrics" / f"{m['name']}.py").read_text()
        assert "def read(ctx)" in src
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        n = w["name"]

        def has(m):
            return n in m.get("workloads", [n])
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in MANIFEST["per_layer"])


def test_layer_names_are_consistent():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "kernels" in layers and "device" in layers
