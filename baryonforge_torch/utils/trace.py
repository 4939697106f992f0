"""The port's tracer: a runner call's phases, spans and counters.

A runner's ``process()`` makes a :class:`PhaseClock` for the call and
installs it as the calling thread's tracer while the call runs (``with
PhaseClock(...) as clock``); ``runner.timings`` is then
:meth:`PhaseClock.timings`:

* phases (dotless keys, ms): ``clock.mark(name)`` ends phase ``name``;
  CUDA events on the device's current stream for a CUDA runner (a mark
  after host work measures that work too, since the stream idles
  meanwhile), the host clock for a CPU runner;
* spans (dotted keys, ms): ``with span(name)``, on the host clock
  (``time.perf_counter_ns``), no synchronisation; spans nest, and each
  name's value is its self time (its duration less what its child spans
  cover), summed over the call, so that self times never count an
  interval twice;
* counters (``count.<name>``): ``count(name, n)``, summed over the call.

A nested runner's work records under a prefix of its own while a
:func:`scope` is open (the Anis runner's Mtot canvas: ``canvas.binning.bin``,
``count.canvas.pairs``), so that it reads apart from the caller's; a
counter of the whole call (``count(name, scoped=False)``) keeps its name.

Code below the runner (``ops/``) records through the module functions
:func:`span`, :func:`count`, :func:`upload`, :func:`download`,
:func:`cached` and :func:`scope`, which find the thread's tracer; with
none installed they do nothing but that lookup. ``parallel.SimpleParallel``'s
threads each keep their own.

While a ``torch.profiler`` is active (``torch.autograd._profiler_enabled``,
read when the clock is installed), each span also opens a range
``bf.<name>`` on the profiler's host timeline, the clock of its device
trace, and so does each phase whose name the code gives at its start
(``PhaseClock(device, first=...)``, ``mark(name, then=...)``): a mark
names the phase it ends, which is known only then. The ranges are host
operations (``torch._C._profiler._RecordFunctionFast``): unlike
``torch.profiler.record_function``'s user annotations, they get no copy
on the card's timeline, which a reader of the trace would take for
device work.
"""

import contextlib
import threading
import time

import torch

__all__ = ["PhaseClock", "span", "count", "upload", "download", "cached",
           "scope"]

_local = threading.local()
_NULL = contextlib.nullcontext()
_now = time.perf_counter_ns


def _range(name):
    """An entered profiler range ``bf.<name>`` (exit it when done)."""
    r = torch._C._profiler._RecordFunctionFast("bf." + name)
    r.__enter__()
    return r


class _Span:
    """A span name of one tracer (see :meth:`PhaseClock.span`), made once
    a call: entering it pushes [start, child time] on the tracer's stack
    of open spans, so that spans nest, a name within itself too."""

    __slots__ = ("tracer", "name")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        if tr.profiling:
            tr._ranges.append(_range(self.name))
        tr._open.append([_now(), 0])
        return self

    def __exit__(self, *exc):
        t1 = _now()
        tr = self.tracer
        t0, inner = tr._open.pop()
        tr._self[self.name] = tr._self.get(self.name, 0) + t1 - t0 - inner
        if tr._open:
            tr._open[-1][1] += t1 - t0
        if tr.profiling:
            tr._ranges.pop().__exit__(None, None, None)
        return False


class PhaseClock:
    """A runner call's tracer (see the module docstring). ``first`` names
    the phase that starts at the clock's creation, for its profiler range.
    A clock opens phase ranges only while it is installed, and closes the
    last one when it is taken down."""

    def __init__(self, device, first=None):
        self.cuda = device.type == "cuda"
        self.names = []
        self.stamps = [self._stamp()]
        self._self = {}          # span name -> self time, ns
        self._open = []          # open spans' [start, child time], ns
        self._spans = {}         # name -> _Span
        self._ranges = []        # open spans' profiler ranges
        self._counts = {}
        self._phase = None       # the open phase's profiler range
        self._first = first
        self._prev = None
        self.profiling = False   # ranges too (set at installation)
        self.prefix = ""         # the open scope's (see scope)

    def __enter__(self):
        """Install the clock as this thread's tracer."""
        self._prev = getattr(_local, "tracer", None)
        _local.tracer = self
        self.profiling = torch.autograd._profiler_enabled()
        if self._first is not None:
            self._begin(self._first)
        return self

    def __exit__(self, *exc):
        self._end_phase()
        self.profiling = False
        self._spans.clear()      # they point back at the clock
        _local.tracer = self._prev
        return False

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _begin(self, name):
        if self.profiling:
            self._phase = _range(name)

    def _end_phase(self):
        if self._phase is not None:
            self._phase.__exit__(None, None, None)
            self._phase = None

    def mark(self, name, then=None):
        """End phase ``name``; ``then`` names the phase that starts here
        (its profiler range)."""
        self.names.append(name)
        self.stamps.append(self._stamp())
        self._end_phase()
        if then is not None:
            self._begin(then)

    def milliseconds(self):
        """Milliseconds by phase name; a name marked more than once (a
        chunked phase) sums its intervals."""
        if self.cuda:
            self.stamps[-1].synchronize()
        out = {}
        for n, a, b in zip(self.names, self.stamps, self.stamps[1:]):
            ms = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
            out[n] = out.get(n, 0.0) + ms
        return out

    def span(self, name):
        """A context manager: a span ``name`` (under the open scope's
        prefix) on the host clock."""
        name = self.prefix + name
        sp = self._spans.get(name)
        if sp is None:
            sp = self._spans[name] = _Span(self, name)
        return sp

    def count(self, name, n=1):
        """Add ``n`` to counter ``name``."""
        self._counts[name] = self._counts.get(name, 0) + n

    def _copied(self, name, t0, rng, counter, out):
        """End the copy that started at ``t0`` as a span ``name`` with no
        children (cheaper than a ``span``: a call makes dozens of copies)
        and count the bytes of ``out`` in ``counter``."""
        dt = _now() - t0
        name, counter = self.prefix + name, self.prefix + counter
        self._self[name] = self._self.get(name, 0) + dt
        if self._open:
            self._open[-1][1] += dt
        if rng is not None:
            rng.__exit__(None, None, None)
        self._counts[counter] = self._counts.get(counter, 0) + out.nbytes

    def timings(self):
        """The call's phases (ms), spans' self times (ms) and counters
        (``count.<name>``), in that order."""
        out = self.milliseconds()
        out.update((k, 1e-6 * ns) for k, ns in self._self.items())
        out.update(("count." + k, v) for k, v in self._counts.items())
        return out


def span(name):
    """A span ``name`` of this thread's tracer (a no-op without one)."""
    tr = getattr(_local, "tracer", None)
    return _NULL if tr is None else tr.span(name)


def count(name, n=1, scoped=True):
    """Add ``n`` to counter ``name`` of this thread's tracer, if any: under
    the open scope's prefix, or with ``scoped`` False under ``name`` itself
    (a count of the whole call)."""
    tr = getattr(_local, "tracer", None)
    if tr is not None:
        if scoped:
            name = tr.prefix + name
        c = tr._counts
        c[name] = c.get(name, 0) + n


def _to(x, device, dtype, non_blocking):
    if non_blocking:
        return x.to(device, dtype=dtype, non_blocking=True)
    return torch.as_tensor(x, dtype=dtype, device=device)


def upload(x, device, dtype=None, non_blocking=False):
    """``torch.as_tensor(x, dtype, device)`` of host data ``x`` (with
    ``non_blocking``, of a pinned tensor: an asynchronous copy, whose time
    is its enqueue), timed as the span ``copy.h2d``, its bytes on arrival
    counted in ``h2d_bytes`` (a CPU runner's conversion counts too)."""
    tr = getattr(_local, "tracer", None)
    if tr is None:
        return _to(x, device, dtype, non_blocking)
    rng = _range(tr.prefix + "copy.h2d") if tr.profiling else None
    t0 = _now()
    out = _to(x, device, dtype, non_blocking)
    tr._copied("copy.h2d", t0, rng, "h2d_bytes", out)
    return out


def download(x):
    """``x.cpu()``, timed as the span ``copy.d2h``, its bytes counted in
    ``d2h_bytes``."""
    tr = getattr(_local, "tracer", None)
    if tr is None:
        return x.cpu()
    rng = _range(tr.prefix + "copy.d2h") if tr.profiling else None
    t0 = _now()
    out = x.cpu()
    tr._copied("copy.d2h", t0, rng, "d2h_bytes", out)
    return out


def cached(store, key, name, build):
    """``store[key]``, made by ``build()`` at its first use: a fill is the
    span ``cache.<name>`` and counts in ``cache_fills``, a lookup that
    finds it in ``cache_hits``."""
    if key in store:
        count("cache_hits")
        return store[key]
    with span("cache." + name):
        store[key] = build()
    count("cache_fills")
    return store[key]


@contextlib.contextmanager
def scope(prefix):
    """While open, this thread's tracer records spans and counters (the
    copies', the caches' too) under ``prefix`` + name; scopes nest, their
    prefixes joined. Nothing without a tracer."""
    tr = getattr(_local, "tracer", None)
    if tr is None:
        yield
        return
    outer = tr.prefix
    tr.prefix = outer + prefix
    try:
        yield
    finally:
        tr.prefix = outer
