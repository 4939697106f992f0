"""The traced window: ``torch.profiler`` over it, and its reduction to what
the metrics and the result's ``breakdown`` read.

Device intervals are the profiler's CUDA activities (kernels, copies,
sets). Busy time is the length of their union inside the window; an idle
gap is a stretch of the window with none of them, named by the innermost
of the benchmark's own spans (``bench.unit``, ``bench.runner_init``,
``bench.process``) that holds its midpoint, else ``harness``.
"""

from collections import defaultdict

__all__ = ["profiler", "reduce", "short_name", "union_gaps"]


def profiler(device):
    """A ``torch.profiler.profile`` of the host and, on CUDA, the card;
    no shapes, stacks or memory records."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def short_name(name):
    """A kernel's name without its template arguments, parameters and
    namespaces: ``void ns::k<float>(int)`` -> ``k``; other names (copies,
    sets) as they are."""
    if not (name.startswith("void ") or "::" in name or "<" in name):
        return name
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).split("(")[0].split()
    s = s[-1] if s else name
    return s.split("::")[-1] or name


def union_gaps(intervals, lo, hi):
    """(busy length, gaps) of sorted-or-not (start, end) intervals clipped
    to [lo, hi]: the union's length and the uncovered (start, end)
    stretches."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _span_at(spans, t):
    """The innermost span (shortest) holding time ``t``, or None."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else None


def reduce(prof, timeline=None):
    """The traced window's numbers: ``busy_s`` and ``window_s``, device
    seconds by short op name (``op_seconds``) and the ``breakdown`` (the
    10 device ops that took most time; the idle time by span, and each
    span's longest gap). Writes the Chrome trace to ``timeline`` when
    given."""
    events = prof.profiler.kineto_results.events()
    dev, spans, window = [], [], None
    for e in events:
        name = e.name()
        on_card = "CUDA" in str(e.device_type())
        if name.startswith("bench."):
            # a span's copy on the card's timeline is no device work
            if not on_card:
                sp = (name[len("bench."):], e.start_ns(), e.end_ns())
                if sp[0] == "window":
                    window = sp
                else:
                    spans.append(sp)
        elif on_card:
            dev.append((name, e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    lo, hi = window[1], window[2]
    inside = [(n, s, e) for n, s, e in dev if e > lo and s < hi]
    busy, gaps = union_gaps([(s, e) for _, s, e in inside], lo, hi)
    op_s = defaultdict(float)
    for n, s, e in inside:
        op_s[short_name(n)] += (min(e, hi) - max(s, lo)) * 1e-9
    idle, longest = defaultdict(float), {}
    for s, e in gaps:
        where = _span_at(spans, 0.5 * (s + e)) or "harness"
        idle[where] += (e - s) * 1e-9
        longest[where] = max(longest.get(where, 0.0), (e - s) * 1e-9)
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    gap_rows = sorted(idle.items(), key=lambda kv: -kv[1])
    gap_rows += [(f"{k} longest", v) for k, v in
                 sorted(longest.items(), key=lambda kv: -kv[1])]
    if timeline:
        prof.export_chrome_trace(str(timeline))
    return dict(busy_s=busy * 1e-9, window_s=(hi - lo) * 1e-9,
                op_seconds=dict(op_s),
                breakdown=dict(device_ops=[[k, v] for k, v in ops],
                               idle_gaps=[[k, v] for k, v in gap_rows[:10]]))
