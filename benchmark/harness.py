"""One run of one cell: set-up, the measured window, the trace's reduction,
the metrics and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``configs/<name>.json``: the configuration (sizes, parameters, the
  limits of its checks); its ``module`` names ``configs/<module>.py``,
  which builds the program's model and runners and the plain reference,
  and computes the numbers compared;
* ``traffic/<name>.json``: a traffic mix, read by ``traffic.py``;
* ``metrics/<name>.py``: a metric's reader, ``read(ctx)``, which returns
  its value, or None when the run has nothing for it to read.

A unit of work is one call: a new runner built on one shell, then its
``process()``; successive units take the mix's shells in turn, so no unit
starts on the previous unit's shell.
"""

import importlib.util
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

from . import counts, traffic
from .shells import program_inputs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "baryonforge_tpu")

__all__ = ["Dirs", "run_cell", "load_manifest", "find_cell", "forbidden",
           "metric_entries", "load_config", "load_metric", "Context"]


class Dirs:
    """Where configurations, traffic mixes and metric readers are looked
    for: each a list of directories, searched in order."""

    def __init__(self, configs=(), traffic=(), metrics=()):
        self.configs = [Path(d) for d in configs] + [HERE / "configs"]
        self.traffic = [Path(d) for d in traffic] + [HERE / "traffic"]
        self.metrics = [Path(d) for d in metrics] + [HERE / "metrics"]


def _find(dirs, filename):
    for d in dirs:
        if (d / filename).exists():
            return d
    raise FileNotFoundError(f"{filename} in none of {[str(d) for d in dirs]}")


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(path=MANIFEST):
    with open(path) as f:
        return json.load(f)


def find_cell(manifest, name):
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in the manifest")


def load_config(name, dirs):
    """(configuration dict, its module) of configuration ``name``."""
    d = _find(dirs.configs, f"{name}.json")
    with open(d / f"{name}.json") as f:
        cfg = json.load(f)
    mod_name = cfg.get("module", name)
    md = _find(dirs.configs, f"{mod_name}.py")
    return cfg, _load_module(md / f"{mod_name}.py",
                             f"benchmark_config_{mod_name}")


def load_traffic(name, dirs):
    return traffic.load(name, _find(dirs.traffic, f"{name}.json"))


def load_metric(name, dirs):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    d = _find(dirs.metrics, f"{name}.py")
    return _load_module(d / f"{name}.py",
                        "benchmark_metric_" + name.replace(".", "_"))


def metric_entries(manifest, cell_name, trace):
    """The manifest's metrics that a run of ``cell_name`` reports: its
    end-to-end metrics with ``trace`` 0, its per-layer ones with 1 (a
    metric with a ``workloads`` list only in those cells)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden():
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class _Spans:
    """Spans the benchmark records around its calls into the program: under
    a trace, each is a ``torch.profiler.record_function`` range named
    ``bench.<name>``, so that the profiler's timeline holds it."""

    def __init__(self, on):
        self.on = on

    @contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(f"bench.{name}"):
            yield


class Context:
    """What a metric's reader reads: the configuration, the mix, the units
    of the window (``units``: dicts of shell, halos, init_ms, timings,
    unit_ms, ok), the window's and the set-up's seconds, the peak device
    memory and, in a traced run, ``trace`` (``trace.py``'s reduction)."""

    def __init__(self, cfg, mix, cell, shells, units, window_s, setup_s,
                 peak_bytes, trace_data):
        self.cfg, self.mix, self.cell = cfg, mix, cell
        self.shells = shells
        self.units = units
        self.window_s = window_s
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace_data
        self._members = {}

    def done(self):
        return [u for u in self.units if u["ok"]]

    def timing_ms(self, *keys):
        """Mean over the window's runners of the sum of their
        ``timings[key]`` (ms), or None where no runner has any of them."""
        vals = [sum(u["timings"][k] for k in keys if k in u["timings"])
                for u in self.done()
                if any(k in u["timings"] for k in keys)]
        return float(np.mean(vals)) if vals else None

    def members(self, i):
        if i not in self._members:
            self._members[i] = counts.member_pixels(self.cfg, self.shells[i])
        return self._members[i]

    def least_seconds(self, layer):
        """The layer's least time (``counts.<layer>``) summed over the
        shells of the window's units."""
        fn = getattr(counts, layer)
        return sum(counts.least_seconds(*fn(self.cfg, self.shells[i],
                                            self.members(i)))
                   for i in (u["shell"] for u in self.done()))

    def device_seconds(self, patterns):
        """Summed device time of the traced window's operations whose name
        holds one of ``patterns``, or None (no trace, or none ran)."""
        if self.trace is None:
            return None
        s = sum(t for name, t in self.trace["op_seconds"].items()
                if any(p in name for p in patterns))
        return s if s > 0 else None


def _run_unit(mod, cfg, model, inputs, i, device, span):
    """One call: a new runner on shell ``i``, then its process(). Returns
    the unit's record and output (None where it failed)."""
    rec = dict(shell=i, ok=False)
    t0 = time.perf_counter()
    with span("unit"):
        with span("runner_init"):
            runner = mod.runner(cfg, model, inputs[i], device)
        rec["init_ms"] = 1e3 * (time.perf_counter() - t0)
        try:
            with span("process"):
                out = runner.process()
            rec["ok"] = True
        except RuntimeError as err:
            print(f"unit on shell {i} failed: {err}", file=sys.stderr)
            out = None
    rec["unit_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["timings"] = dict(runner.timings)
    return rec, out


def _sync(device):
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(workload, seed, seconds, trace, t0=None, device="cuda",
             manifest=None, dirs=None, timeline=None, log=None):
    """Run ``workload`` once and return its result (a dict ready to print
    as the run's JSON line). ``t0``: the process's start on
    ``time.perf_counter``'s clock (the start of ``setup_s``); ``timeline``:
    a path to write the traced window's Chrome trace to."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dirs = dirs or Dirs()
    manifest = manifest if manifest is not None else load_manifest()
    cell = find_cell(manifest, workload)
    cfg, mod = load_config(cell["config"], dirs)
    mix = load_traffic(cell["traffic"], dirs)

    import torch
    from . import trace as trace_mod
    span = _Spans(bool(trace))

    # set-up: the model (its table built on the card), the shells, a warm
    # unit
    model = mod.program_model(cfg, mix, device)
    shells = traffic.make_shells(mix, cfg["nside"], seed)
    inputs = [program_inputs(cfg, s) for s in shells]
    rec, _ = _run_unit(mod, cfg, model, inputs, 0, device, span)
    if not rec["ok"]:
        raise RuntimeError("the warm unit failed")
    _sync(device)
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s; window of {seconds} s on {workload}")

    # the window
    units, kept = [], {}
    prof = trace_mod.profiler(device) if trace else None
    with prof if prof is not None else nullcontext():
        with span("window"):
            w0 = time.perf_counter()
            k = 1
            while time.perf_counter() - w0 < seconds:
                i = k % len(shells)
                rec, out = _run_unit(mod, cfg, model, inputs, i, device,
                                     span)
                rec["halos"] = traffic.halo_count(shells[i])
                units.append(rec)
                if out is not None:
                    kept[i] = out
                k += 1
            _sync(device)
            w1 = time.perf_counter()
    window_s = w1 - w0
    log("calls (ms): " + " ".join(f"{u['unit_ms']:.1f}" for u in units))
    phases = {}
    for u in units:
        for k, v in u["timings"].items():
            phases.setdefault(k, []).append(v)
    log("phases, median ms: " + ", ".join(
        f"{k} {np.median(v):.2f}" for k, v in phases.items()))
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    trace_data = (trace_mod.reduce(prof, timeline) if prof is not None
                  else None)

    # correctness: the table, a sampled shell against the plain reference,
    # and every kept output's mass; the program's state freed first
    prog_table = mod.program_table(model)
    del model, inputs
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pick = int(rng.choice(sorted(kept))) if kept else None
    numbers = {}
    if pick is not None:
        tr = time.perf_counter()
        ref = mod.reference_model(cfg, mix, device)
        ref_out = mod.reference_map(cfg, ref, shells[pick], device)
        numbers = mod.compare(cfg, prog_table, mod.reference_table(ref),
                              shells[pick], kept[pick], ref_out,
                              [(shells[i], o) for i, o in kept.items()])
        log(f"reference on shell {pick}: {time.perf_counter() - tr:.3f} s")
    limits = cfg["checks"]
    failed = sum(not u["ok"] for u in units)
    correct = (pick is not None and failed == 0
               and all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
                       for k in limits))

    ctx = Context(cfg, mix, cell, shells, units, window_s, setup_s, peak,
                  trace_data)
    metrics = {}
    for m in metric_entries(manifest, workload, trace):
        value = load_metric(m["name"], dirs).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = _device_info(device, cell["chips"], peak)
    result = dict(correct=bool(correct),
                  attempted=len(units),
                  failed=failed, metrics=metrics, device=dev)
    if trace_data is not None:
        dev["busy_s"] = trace_data["busy_s"]
        dev["window_s"] = trace_data["window_s"]
        result["breakdown"] = trace_data["breakdown"]
    result["checks"] = {k: {"value": _finite(numbers.get(k)),
                            "limit": limits[k]} for k in limits}
    bad = forbidden()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result


def _finite(v):
    """A number as JSON can hold it: None for a missing or non-finite
    one."""
    return float(v) if v is not None and np.isfinite(v) else None


def _device_info(device, chips, peak):
    if device.startswith("cuda"):
        import torch
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=int(chips), memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
