"""The readings that the limits of a cell's checks are set from, in one
process on the card:

* the program's (the lower readings): for each of ``--program-seeds``, the
  cell's shells through the timed path (a new runner a shell, every shell
  once, at the cell's load), then the comparison a run makes;
* the control's (the upper readings): for each of ``--control-seeds``, the
  plain reference put in the program's place and computed in the next
  precision below the configuration's (its ``control``), compared with
  the float64 reference the same way.

    python3 benchmark/control.py --workload NAME --program-seeds 1,2,3 \\
        --control-seeds 4,5,6

Prints a JSON line a seed, then the largest lower and the smallest upper
reading of each number. The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(workload, program_seeds, control_seeds, device="cuda",
             manifest=None, dirs=None, log=print):
    """{"program": [numbers a seed], "control": [numbers a seed]}."""
    from benchmark import harness, traffic
    from benchmark.shells import program_inputs
    dirs = dirs or harness.Dirs()
    manifest = manifest or harness.load_manifest()
    cell = harness.find_cell(manifest, workload)
    cfg, mod = harness.load_config(cell["config"], dirs)
    mix = harness.load_traffic(cell["traffic"], dirs)
    span = harness._Spans(False)
    out = {"program": [], "control": []}
    ref = mod.reference_model(cfg, mix, device)
    ref_table = mod.reference_table(ref)
    if program_seeds:
        model = mod.program_model(cfg, mix, device)
        prog_table = mod.program_table(model)
        for seed in program_seeds:
            t = time.perf_counter()
            shells = traffic.make_shells(mix, cfg["nside"], seed)
            inputs = [program_inputs(cfg, s) for s in shells]
            kept = {}
            for i in range(len(shells)):
                rec, shell_out = harness._run_unit(mod, cfg, model, inputs,
                                                   i, device, span)
                if shell_out is None:
                    raise RuntimeError(f"seed {seed}: a call failed")
                kept[i] = shell_out
            rng = np.random.default_rng([int(seed) % (1 << 63), 7])
            pick = int(rng.choice(sorted(kept)))
            ref_out = mod.reference_map(cfg, ref, shells[pick], device)
            nums = mod.compare(cfg, prog_table, ref_table, shells[pick],
                               kept[pick], ref_out,
                               [(shells[i], o) for i, o in kept.items()])
            out["program"].append(nums)
            log(json.dumps(dict(side="program", seed=seed, shell=pick,
                                seconds=time.perf_counter() - t, **nums)))
        del model
    if control_seeds:
        ctl = mod.reference_model(cfg, mix, device, control=True)
        ctl_table = mod.reference_table(ctl)
        for seed in control_seeds:
            t = time.perf_counter()
            shells = traffic.make_shells(mix, cfg["nside"], seed)
            rng = np.random.default_rng([int(seed) % (1 << 63), 7])
            pick = int(rng.integers(len(shells)))
            shell = shells[pick]
            ref_out = mod.reference_map(cfg, ref, shell, device)
            ctl_out = mod.reference_map(cfg, ctl, shell, device, control=True)
            nums = mod.compare(cfg, ctl_table, ref_table, shell, ctl_out,
                               ref_out, [(shell, ctl_out)])
            out["control"].append(nums)
            log(json.dumps(dict(side="control", seed=seed, shell=pick,
                                seconds=time.perf_counter() - t, **nums)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    r = readings(args.workload, args.program_seeds, args.control_seeds,
                 log=lambda s: print(s, flush=True))
    summary = {}
    for k in (r["program"] or r["control"] or [{}])[0]:
        lo = [n[k] for n in r["program"]]
        hi = [n[k] for n in r["control"]]
        summary[k] = dict(lower=max(lo) if lo else None,
                          upper=min(hi) if hi else None)
    print(json.dumps(dict(workload=args.workload, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
