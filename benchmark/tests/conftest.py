"""Fixtures of the benchmark's CPU tests: the repository's root on the
path, a tiny copy of each configuration and mix (NSIDE 32, 79 halos) in a
temporary directory with a manifest of its cells, and the card for the
tests marked ``cuda``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = {"s19_shell_tiny.tiny": ("s19_shell", "tiny"),
              "tsz_paint_tiny.tiny": ("tsz_paint", "tiny")}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def write_tiny(directory):
    """Tiny configurations and mixes in ``directory``; returns (manifest,
    Dirs)."""
    from benchmark import harness
    d = Path(directory)
    base = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("s19_shell", "tsz_paint"):
        c = json.loads((ROOT / "benchmark" / "configs" /
                        f"{name}.json").read_text())
        c.update(name=f"{name}_tiny", module=name, nside=32)
        c["table"].update(N_samples_Mass=4, N_samples_R=24)
        (d / f"{name}_tiny.json").write_text(json.dumps(c))
    m = json.loads((ROOT / "benchmark" / "traffic" /
                    "limber.json").read_text())
    # a thin slice of the Limber shell's volume: 79 halos
    m.update(chi_hi_Mpc=m["chi_lo_Mpc"] + 0.09,
             mass_function_file=str(ROOT / "benchmark" / "traffic" /
                                    m["mass_function_file"]))
    (d / "tiny.json").write_text(json.dumps(m))
    man = copy.deepcopy(base)
    man["workloads"] = [dict(name=n, config=f"{c}_tiny", traffic=t, chips=1,
                             why="a CPU test's tiny cell")
                        for n, (c, t) in TINY_CELLS.items()]
    for key in ("end_to_end", "per_layer"):
        for e in man[key]:
            if "workloads" in e:
                kinds = {w.split(".")[0] for w in e["workloads"]}
                e["workloads"] = [n for n, (c, _) in TINY_CELLS.items()
                                  if c in kinds]
    return man, harness.Dirs(configs=[d], traffic=[d])


@pytest.fixture
def tiny(tmp_path):
    return write_tiny(tmp_path)
