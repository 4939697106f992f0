"""The port's process-wide geometry cache (baryonforge_torch.ops.geometry)
on the CPU at small NSIDE: each key (NSIDE, tile shape, regrid dtype,
device) fills once and then hits, the least recently used group goes past
MAX_GROUPS, clear_geometry_cache() empties it, and threads asking for one
key at once build it once. The runners' use of it (a fresh runner after a
warm one fills nothing and gives the same map) is in test_torch_trace.py."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch.ops import geometry, stencil, tiles  # noqa: E402
from baryonforge_torch.utils.trace import PhaseClock        # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_geometry_cache():
    """Each test starts and ends with the port's process-wide geometry
    cache empty (ops.geometry), so that a fresh runner's fills do not
    depend on which tests ran before it in the same worker."""
    bf.clear_geometry_cache()
    yield
    bf.clear_geometry_cache()


def _lookups(fn):
    """fn()'s result and the counters and cache spans it recorded."""
    with PhaseClock(CPU) as clock:
        out = fn()
    t = clock.timings()
    return out, (t.get("count.cache_fills", 0), t.get("count.cache_hits", 0),
                 sorted(k for k in t if k.startswith("cache.")))


@pytest.mark.parametrize("key", ["nside", "shape", "rdt"])
def test_each_key_fills_anew_then_hits(key):
    """Another NSIDE, another tile shape or another regrid dtype is built
    anew (its own fills and spans); asking again hits, the same objects."""
    f32, f64 = torch.float32, torch.float64
    first, other = {
        "nside": (lambda: geometry.tiling(8), lambda: geometry.tiling(16)),
        "shape": (lambda: geometry.tiling(8),
                  lambda: geometry.tiling(8, (8, 16))),
        "rdt": (lambda: geometry.stencil_geo(8, f64, CPU),
                lambda: geometry.stencil_geo(8, f32, CPU))}[key]
    a, (fills, _, spans) = _lookups(first)
    assert fills > 0 and spans
    b, (fills, hits, spans) = _lookups(other)
    assert b is not a
    assert fills == 1 and (hits > 0) == (key == "rdt")
    assert spans == (["cache.stencil_geo"] if key == "rdt"
                     else ["cache.tiling"])
    for fn, want in ((first, a), (other, b)):
        got, (fills, hits, spans) = _lookups(fn)
        assert got is want and fills == 0 and hits >= 1 and not spans
    if key == "shape":
        assert (b.RB, b.K) == (8, 16) and (a.RB, a.K) == (16, 32)
        assert geometry.tiling(8, (16, 32)) is a


def test_stencil_entries_are_the_default_tilings():
    """The stencil's tables and source list are those of the default
    tiling, built as ops.stencil builds them, kept under one device key
    however the device is named."""
    t = geometry.tiling(8)
    tables = geometry.stencil_tables(8, "cpu")
    assert geometry.stencil_tables(8, CPU) is tables
    want = stencil.stencil_tables(t, tiles.stencil_host_info(t), CPU)
    assert tables.keys() == want.keys()
    for k, v in want.items():
        if k == "ring":
            continue
        assert (torch.equal(tables[k], v) if torch.is_tensor(v)
                else np.array_equal(tables[k], v)), k
    geo = geometry.stencil_geo(8, torch.float64, CPU)
    for a, b in zip(geo, stencil.stencil_geo(t, want, torch.float64)):
        assert torch.equal(a, b)


def test_least_recently_used_group_goes():
    """Past MAX_GROUPS (NSIDE, shape) groups the least recently used one
    is dropped: looked up again, it is built anew; one used since stays."""
    n = geometry.MAX_GROUPS
    kept = [geometry.tiling(2 ** i) for i in range(n)]
    assert geometry.tiling(1) is kept[0]           # now the most recent
    geometry.tiling(2 ** n)                        # drops NSIDE 2
    assert len(geometry._groups) == n
    assert geometry.tiling(1) is kept[0]
    assert geometry.tiling(2 ** (n - 1)) is kept[n - 1]
    again, (fills, _, spans) = _lookups(lambda: geometry.tiling(2))
    assert again is not kept[1] and fills == 1 and spans == ["cache.tiling"]


def test_clear_geometry_cache_empties_it():
    """clear_geometry_cache() drops every group; the next lookup fills."""
    t = geometry.tiling(4)
    geometry.stencil_tables(4, CPU)
    geometry.tiling(4, (8, 16))
    assert len(geometry._groups) == 2
    bf.clear_geometry_cache()
    assert not geometry._groups
    again, (fills, _, _) = _lookups(lambda: geometry.tiling(4))
    assert again is not t and fills == 1


def test_threads_build_one_key_once(monkeypatch):
    """Eight threads asking for one tiling at once (a slow build, a short
    switch interval) build it once and all get that one object; its
    circumradii, asked for by all at once too, are computed once."""
    built, crads = [], []
    real = tiles.SkyTiling

    class Counted(real):
        def __init__(self, *a, **kw):
            built.append(1)
            time.sleep(0.05)
            super().__init__(*a, **kw)

        def _circumradii(self):
            crads.append(1)
            time.sleep(0.05)
            return super()._circumradii()

    monkeypatch.setattr(tiles, "SkyTiling", Counted)
    n = 8
    start = threading.Barrier(n)
    got = [None] * n

    def ask(i):
        start.wait(timeout=10)
        t = geometry.tiling(16)
        t.tile_crad
        got[i] = t

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(built) == 1 and len(crads) == 1
    assert all(t is got[0] for t in got)
