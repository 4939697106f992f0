"""A cell, a traffic mix and a per-layer metric added as new files only,
from a temporary directory, with no file of the benchmark edited; and the
command's refusal without a card."""

import copy
import json
import subprocess
import sys

from benchmark import harness, traffic

from conftest import ROOT

SEED = 2 ** 31 + 29


def test_new_cell_mix_and_metric_from_files(tiny, tmp_path):
    man, _ = tiny
    d = tmp_path / "added"
    d.mkdir()
    mix = json.loads((tmp_path / "tiny.json").read_text())
    mix.update(chi_hi_Mpc=mix["chi_lo_Mpc"] + 0.03, z_lo=0.105,
               z_hi=0.115)
    n_halos = traffic.halo_count(traffic.make_shells(
        dict(mix, _dir=str(tmp_path)), 8, SEED)[0])
    (d / "tiny24.json").write_text(json.dumps(mix))
    (d / "halos_per_call.py").write_text(
        "def read(ctx):\n"
        "    done = ctx.done()\n"
        "    return sum(u['halos'] for u in done) / len(done)\n")
    man = copy.deepcopy(man)
    man["workloads"].append(dict(name="s19_shell_tiny.tiny24",
                                 config="s19_shell_tiny", traffic="tiny24",
                                 chips=1, why="added from files"))
    man["per_layer"].append(dict(name="halos_per_call", unit="halos",
                                 better="higher", source="host_clock",
                                 layer="runner call", moves="halos_per_s",
                                 workloads=["s19_shell_tiny.tiny24"]))
    for m in man["per_layer"]:
        if "s19_shell_tiny.tiny" in m.get("workloads", []):
            m["workloads"].append("s19_shell_tiny.tiny24")
    dirs = harness.Dirs(configs=[tmp_path], traffic=[d, tmp_path],
                        metrics=[d])
    r = harness.run_cell("s19_shell_tiny.tiny24", SEED, 0.5, 1,
                         device="cpu", manifest=man, dirs=dirs,
                         log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["halos_per_call"]["value"] == n_halos < 79
    assert "host_prep_ms" in r["metrics"] and "phase_a_ms" in r["metrics"]
    # no card traced on the CPU: no roofline is reported, none reads 0
    assert not any(k.startswith("roofline") for k in r["metrics"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "s19_shell.limber", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    # a directory that holds only BENCHMARK.json and benchmark/
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "s19_shell.limber", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
