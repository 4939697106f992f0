"""The port's tracer (baryonforge_torch.utils.trace): spans and their self
times, counters, the thread-local tracer, the profiler's bf.* ranges, and
the keys that BaryonifyShell's tiled engine and PaintProfilesShell's tiled
paint record on a small shell on the CPU; and the benchmark's readers of
them (benchmark/metrics/) on a hand-made Context."""

import gc
import importlib.util
import os
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.utils import trace                   # noqa: E402
from baryonforge_torch.utils.trace import PhaseClock        # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import COSMO_DICT, torch_model      # noqa: E402
from test_torch_deposit import make_inputs                  # noqa: E402
from test_torch_paint import jax_tables, catalog            # noqa: E402
from test_torch_direct_shell import HideCurves              # noqa: E402

CPU = torch.device("cpu")
METRICS = os.path.join(os.path.dirname(__file__), os.pardir, "benchmark",
                       "metrics")

# the keys each benchmarked path records (the shell's also the map's
# upload and empty test, the stencil's caches and hot tiles, and the check)
COMMON = {"host_prep.cosmology", "host_prep.columns", "binning.pack",
          "binning.tiling", "binning.bin", "binning.refine", "binning.csr",
          "cache.tiling", "cache.crad", "cache.tiling_device",
          "download.wait", "download.convert", "copy.h2d", "copy.d2h",
          "count.h2d_bytes", "count.d2h_bytes", "count.pairs",
          "count.pairs_kept", "count.cache_fills", "count.cache_hits"}
SHELL = COMMON | {"host_prep.map_upload", "host_prep.empty_check",
                  "cache.stencil_tables", "cache.stencil_geo",
                  "regrid.hot_tiles", "process.check"}


@pytest.fixture(autouse=True)
def _fresh_geometry_cache():
    """Each test starts and ends with the port's process-wide geometry
    cache empty (ops.geometry), so that a fresh runner's fills do not
    depend on which tests ran before it in the same worker."""
    bf.clear_geometry_cache()
    yield
    bf.clear_geometry_cache()


def _phases(timings):
    return [k for k in timings if "." not in k]


# ---- the tracer -------------------------------------------------------------
def test_spans_nest_and_self_times_add_up(monkeypatch):
    """Each span's self time is its duration less its children's; the self
    times of a tree add up to the root's duration, a name run twice (or
    within itself) sums, and nothing counts twice. The host clock is a
    fake one here, moved by hand."""
    now = [0]
    monkeypatch.setattr(trace, "_now", lambda: now[0])

    def busy(ms):
        now[0] += int(ms * 1e6)

    clock = PhaseClock(CPU)
    with clock:
        with trace.span("s.a"):
            busy(2)
            with trace.span("s.b"):
                busy(3)
                with trace.span("s.c"):
                    busy(1)
                with trace.span("s.b"):           # within itself
                    busy(0.5)
            with trace.span("s.d"):
                busy(1)
            trace.upload(np.zeros(4), CPU)        # a copy: no span object
            with trace.span("s.d"):
                busy(1)
        clock.mark("phase")
    t = clock.timings()
    assert _phases(t) == ["phase"]
    assert set(t) == {"phase", "s.a", "s.b", "s.c", "s.d", "copy.h2d",
                      "count.h2d_bytes"}
    assert t["copy.h2d"] == 0.0
    want = {"s.a": 2.0, "s.b": 3.5, "s.c": 1.0, "s.d": 2.0}
    assert {k: t[k] for k in want} == pytest.approx(want, abs=1e-12)
    assert sum(want.values()) == pytest.approx(1e-6 * now[0], abs=1e-12)


def test_counters_accumulate_and_each_call_starts_from_zero():
    def call():
        with PhaseClock(CPU) as clock:
            for n in (3, 4):
                trace.count("items", n)
            trace.count("once")
            clock.mark("work")
        return clock.timings()

    first, second = call(), call()
    assert first == {**first, "count.items": 7, "count.once": 1}
    assert second["count.items"] == 7 and second["count.once"] == 1


def test_no_tracer_records_nothing():
    """Without an installed tracer the module functions only pass their
    work through; a clock taken down stops recording."""
    with trace.span("x"):
        trace.count("n", 5)
    store = {}
    assert trace.cached(store, "k", "thing", lambda: 41) == 41
    assert trace.upload(np.arange(3.0), CPU).tolist() == [0.0, 1.0, 2.0]
    assert trace.download(torch.ones(2)).tolist() == [1.0, 1.0]
    clock = PhaseClock(CPU)
    with clock:
        trace.count("n", 5)
    trace.count("n", 5)
    with trace.span("y.z"):
        pass
    assert clock.timings() == {"count.n": 5}


def test_a_call_leaves_no_reference_cycle():
    """A clock taken down is freed by its reference count (its spans point
    back at it): a call leaves no garbage for the cyclic collector."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        clock = PhaseClock(CPU, first="a")
        with clock:
            with trace.span("s.x"):
                with trace.span("s.y"):
                    pass
            clock.mark("a")
        ref = weakref.ref(clock)
        del clock
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_copies_and_caches_are_recorded():
    with PhaseClock(CPU) as clock:
        trace.upload(np.zeros(10), CPU, torch.float32)
        trace.download(torch.zeros(3, dtype=torch.float64))
        store, built = {}, []
        for _ in range(3):
            trace.cached(store, "k", "thing", lambda: built.append(1) or 7)
    t = clock.timings()
    assert t["count.h2d_bytes"] == 40 and t["count.d2h_bytes"] == 24
    assert built == [1] and t["count.cache_fills"] == 1
    assert t["count.cache_hits"] == 2 and "cache.thing" in t
    assert {"copy.h2d", "copy.d2h"} <= set(t)


def test_scopes_prefix_spans_and_counters():
    """Inside a scope the spans, counters, copies and caches record under
    its prefix, nested scopes join theirs, an unscoped counter keeps its
    name, and the prefix is dropped when the scope closes (an exception
    too); without a tracer a scope does nothing."""
    with trace.scope("none."):
        trace.count("n")
    with PhaseClock(CPU) as clock:
        with trace.scope("canvas."):
            with trace.span("binning.bin"):
                trace.count("pairs", 3)
                trace.count("searches", scoped=False)
            trace.upload(np.zeros(2), CPU)
            trace.cached({}, "k", "tiling", lambda: 1)
            with trace.scope("inner."):
                trace.count("pairs")
        with pytest.raises(KeyError):
            with trace.scope("lost."):
                raise KeyError
        with trace.span("binning.bin"):
            trace.count("pairs", 5)
            trace.count("searches")
    t = clock.timings()
    assert {"canvas.binning.bin", "binning.bin", "canvas.copy.h2d",
            "canvas.cache.tiling"} <= set(t)
    assert {k: v for k, v in t.items() if k.startswith("count.")} == {
        "count.canvas.pairs": 3, "count.searches": 2,
        "count.canvas.h2d_bytes": 16, "count.canvas.cache_fills": 1,
        "count.canvas.inner.pairs": 1, "count.pairs": 5}
    assert clock.prefix == ""


def test_thread_local_tracers_keep_calls_apart():
    """Two threads' calls, run at once, each record only their own."""
    barrier = threading.Barrier(2, timeout=30)
    out = {}

    def call(name, n):
        with PhaseClock(CPU) as clock:
            barrier.wait()
            for _ in range(200):
                with trace.span("work." + name):
                    trace.count(name, n)
            barrier.wait()
            clock.mark("phase")
        out[name] = clock.timings()

    threads = [threading.Thread(target=call, args=(k, n))
               for k, n in (("a", 1), ("b", 2))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert set(out["a"]) == {"phase", "work.a", "count.a"}
    assert set(out["b"]) == {"phase", "work.b", "count.b"}
    assert out["a"]["count.a"] == 200 and out["b"]["count.b"] == 400


def _bf_ranges(prof):
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("bf.")), key=lambda r: r[1])


def _call_with_spans():
    with PhaseClock(CPU, first="one") as clock:
        with trace.span("one.inner"):
            torch.ones(4).sum()
        clock.mark("one", then="two")
        with trace.span("two.inner"):
            pass
        clock.mark("two")
    return clock


def test_profiler_ranges_only_while_active():
    """Spans and phases open bf.* ranges only under an active profiler:
    the spans nested in their phases, on the profiler's clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("outside"):
            pass
    assert _bf_ranges(prof) == []
    _call_with_spans()                       # no profiler: nothing to see
    with torch.profiler.profile(activities=acts) as prof:
        _call_with_spans()
    ranges = _bf_ranges(prof)
    names = [n for n, _, _ in ranges]
    assert names == ["bf.one", "bf.one.inner", "bf.two", "bf.two.inner"]
    (_, s1, e1), (_, s2, e2), (_, s3, e3), (_, s4, e4) = ranges
    assert s1 <= s2 <= e2 <= e1 <= s3 <= s4 <= e4 <= e3
    with torch.profiler.profile(activities=acts) as prof:
        pass
    assert _bf_ranges(prof) == []


def test_tracer_cost_with_the_profiler_off():
    """A span, a counter and a cache lookup cost microseconds: a shell
    call's ~60 of them stay far under 0.1 ms."""
    n = 2000
    with PhaseClock(CPU):
        store = {"k": 1}
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("s"):
                trace.count("c")
            trace.cached(store, "k", "x", None)
        per = (time.perf_counter_ns() - t0) / n
    assert per < 50_000                     # ns; ~2-3 us on a loaded core


# ---- the runners ------------------------------------------------------------
def _shell(nside=128, n=60):
    cat, shell = make_inputs(nside, n, seed=3, low_mass=True)
    c = cat.cat
    return (bf.utils.HaloLightConeCatalog(ra=c["ra"], dec=c["dec"], M=c["M"],
                                          z=c["z"], cosmo=COSMO_DICT),
            bf.utils.LightconeShell(map=shell.map, cosmo=COSMO_DICT))


@pytest.fixture(scope="module")
def shell_case():
    return _shell(), torch_model()


@pytest.fixture(scope="module")
def paint_case():
    model = convert.tabulated_from_jax(jax_tables()["log"], device="cpu")
    cols = catalog()
    cat = bf.utils.HaloLightConeCatalog(**cols, cosmo=COSMO_DICT)
    shell = bf.utils.LightconeShell(map=np.zeros(12 * 128 ** 2),
                                    cosmo=COSMO_DICT)
    return (cat, shell), model


def _shell_runner(shell_case, **kw):
    (cat, shell), model = shell_case
    return bf.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                             device="cpu", **kw)


def _paint_runner(paint_case, **kw):
    (cat, shell), model = paint_case
    return bf.PaintProfilesShell(cat, shell, epsilon_max=40, model=model,
                                 device="cpu", **kw)


@pytest.mark.parametrize("kind", ["shell", "paint"])
def test_tiled_paths_record_their_keys(shell_case, paint_case, kind):
    """The tiled engine and the tiled paint record the spans and counters
    of their host work; a second runner on the same NSIDE finds the
    process-wide geometry its first call filled (no fill, no cache span)
    and gives the same map bit for bit, as does a runner after
    clear_geometry_cache(), which fills again; a second call of a runner
    finds it too."""
    make, case, keys, phases = {
        "shell": (_shell_runner, shell_case, SHELL,
                  ["host_prep", "curves", "binning", "deposit", "regrid",
                   "download"]),
        "paint": (_paint_runner, paint_case, COMMON,
                  ["host_prep", "curves", "binning", "paint",
                   "download"])}[kind]
    r = make(case)
    out = r.process()
    t = r.timings
    assert _phases(t) == phases
    assert keys <= set(t), keys - set(t)
    assert all(v >= 0 for v in t.values())
    assert 0 < t["count.pairs_kept"] <= t["count.pairs"]
    assert t["count.cache_fills"] > 0
    npix = r.LightconeShell.map.size
    assert t["count.d2h_bytes"] == npix * (8 if kind == "shell" else 4)
    again = make(case)
    assert np.array_equal(again.process(), out)
    assert again.timings.get("count.cache_fills", 0) == 0
    assert again.timings["count.cache_hits"] > 0
    assert not any(k.startswith("cache.") for k in again.timings)
    bf.clear_geometry_cache()
    cleared = make(case)
    assert np.array_equal(cleared.process(), out)
    assert cleared.timings["count.cache_fills"] == t["count.cache_fills"]
    r.process()
    assert r.timings.get("count.cache_fills", 0) == 0
    assert r.timings["count.cache_hits"] > 0
    assert not any(k.startswith("cache.") for k in r.timings)
    assert r.timings["count.pairs"] == t["count.pairs"]


def _profiled_phases(runner):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        runner.process()
    tops = [n[3:] for n, _, _ in _bf_ranges(prof) if "." not in n[3:]]
    return tops, _phases(runner.timings)


@pytest.mark.parametrize("path", [
    dict(), dict(deposit="scatter"), dict(deposit="tiles", regrid="scatter"),
    dict(direct=True)], ids=["tiled", "scatter", "tiles_scatter", "direct"])
def test_shell_phase_ranges_match_its_phases(shell_case, path):
    """Under a profiler every phase of the call opens one bf.<phase> range,
    named as its mark names it, in order."""
    path = dict(path)
    case = shell_case
    if path.pop("direct", False):
        case = (shell_case[0], HideCurves(shell_case[1]))
    tops, phases = _profiled_phases(_shell_runner(case, **path))
    assert tops == phases


@pytest.mark.parametrize("deposit", ["auto", "scatter"])
def test_paint_phase_ranges_match_its_phases(paint_case, deposit):
    tops, phases = _profiled_phases(_paint_runner(paint_case,
                                                  deposit=deposit))
    assert tops == phases


# ---- the benchmark's readers ------------------------------------------------
def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "trace_test_metric_" + name.replace(".", "_"),
        os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Context:
    """The part of benchmark.harness.Context that the readers read."""

    def __init__(self, units):
        self.units = units

    def done(self):
        return [u for u in self.units if u["ok"]]

    def timing_ms(self, *keys):
        vals = [sum(u["timings"][k] for k in keys if k in u["timings"])
                for u in self.done()
                if any(k in u["timings"] for k in keys)]
        return float(np.mean(vals)) if vals else None


UNITS = [
    dict(ok=True, halos=1000, timings={
        "host_prep": 100.0, "host_prep.cosmology": 40.0, "copy.h2d": 10.0,
        "count.h2d_bytes": 100e6, "copy.d2h": 4.0, "count.d2h_bytes": 8e6,
        "cache.tiling": 3.0, "cache.crad": 5.0, "count.cache_fills": 2,
        "binning.bin": 1.0, "binning.refine": 2.0, "binning.csr": 3.0,
        "count.pairs": 5000, "count.pairs_kept": 4000,
        "process.check": 9.0}),
    dict(ok=True, halos=2000, timings={
        "host_prep": 100.0, "host_prep.cosmology": 20.0, "copy.h2d": 20.0,
        "count.h2d_bytes": 100e6, "copy.d2h": 2.0, "count.d2h_bytes": 8e6,
        "count.cache_hits": 3, "binning.bin": 2.0, "binning.refine": 2.0,
        "binning.csr": 2.0, "count.pairs": 4000, "count.pairs_kept": 4000,
        "process.check": 11.0}),
    dict(ok=False, halos=10, timings={
        "host_prep.cosmology": 1e6, "count.pairs": 1, "count.pairs_kept": 1,
        "copy.h2d": 1e-9, "count.h2d_bytes": 1e12}),
]


@pytest.mark.parametrize("name,want", [
    ("cosmology_ms", 30.0),
    ("h2d_gbps", (10.0 + 5.0) / 2),
    ("d2h_gbps", (2.0 + 4.0) / 2),
    ("cache_fill_ms", (8.0 + 0.0) / 2),
    ("pairs_ms", 6.0),
    ("pairs_per_halo", (4.0 + 2.0) / 2),
    ("pair_yield_pct", (80.0 + 100.0) / 2),
    ("check_ms", 10.0)])
def test_metric_readers(name, want):
    """Each new reader's value on a hand-made window (the failed call left
    out), and None on a window whose calls recorded none of its keys (a
    program without the spans)."""
    read = _reader(name)
    assert read(_Context(UNITS)) == pytest.approx(want, rel=1e-12)
    bare = [dict(ok=True, halos=5, timings={"host_prep": 1.0})]
    assert read(_Context(bare)) is None
    assert read(_Context([])) is None
