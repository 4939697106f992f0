"""The tiled engine's per-NSIDE geometry, kept for the process.

A tiling (``tiles.SkyTiling``, which keeps its circumradii and its tables
on each device it is asked for), the stencil's tables
(``stencil.stencil_tables``) and its geometric source list
(``stencil.stencil_geo``: kernel K6 on CUDA) are pure functions of NSIDE,
the tile shape, the regrid dtype and the device. Each is built at its first
lookup (``utils.trace.cached``: the span ``cache.<name>``, counted in
``count.cache_fills``; a lookup that finds it counts in
``count.cache_hits``) and then shared by every runner and thread of the
process, so that a campaign's new runner a shell builds none of it again.

Every entry, and every memo of a kept tiling, is filled under one lock of
the process, so that threads asking for one key build it once; and a
value that holds CUDA tensors is complete on its card (the filling
thread's stream synchronised) before it is stored, so that another
thread's stream never reads it half made.

The entries are grouped by (NSIDE, tile shape); the stencil's belong to
the default 16 x 32 tiling's group. At most ``MAX_GROUPS`` groups are
kept, the least recently used dropped first, and
:func:`clear_geometry_cache` drops them all. At NSIDE 1024 a group holds
a few MB on the host and ~10 MB on the card.
"""

import threading
from collections import OrderedDict

import torch

from . import stencil as _stencil
from . import tiles as _tiles
from ..utils import trace

__all__ = ["MAX_GROUPS", "tiling", "stencil_tables", "stencil_geo",
           "clear_geometry_cache"]

MAX_GROUPS = 4

_groups = OrderedDict()       # (nside, shape) -> {entry key: value}
# re-entrant: a build looks other entries up
_lock = threading.RLock()


def _resolved(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cuda_devices(value):
    """The cards that the tensors in ``value`` (nested in dicts, lists and
    tuples) lie on."""
    if torch.is_tensor(value):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = value.values()
    elif not isinstance(value, (list, tuple)):
        return set()
    return set().union(*map(_cuda_devices, value))


def _complete(value):
    """``value``, once the filling thread's stream has finished making its
    tensors on each card they lie on."""
    for d in _cuda_devices(value):
        torch.cuda.current_stream(d).synchronize()
    return value


def _shared(store, key, name, build):
    """``trace.cached`` under the lock, the built value complete before it
    is stored."""
    with _lock:
        return trace.cached(store, key, name, lambda: _complete(build()))


def _drop(groups):
    """Let each card that holds the groups' tensors finish the work it was
    given before they go back to the allocator: a kernel queued on
    another stream than the one that made them may still read them."""
    devices = set()
    for group in groups:
        devices.update(k[-1] for k in group if isinstance(k, tuple))
        if "tiling" in group:
            devices.update(map(torch.device, group["tiling"]._dev))
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _group(nside, shape):
    """The entries of (nside, shape), now the most recently used group."""
    key = (int(nside), shape)
    with _lock:
        group = _groups.setdefault(key, {})
        _groups.move_to_end(key)
        old = [_groups.popitem(last=False)[1]
               for _ in range(len(_groups) - MAX_GROUPS)]
    _drop(old)
    return group


def tiling(nside, shape=None):
    """The SkyTiling of ``nside`` with ``shape`` = (ring_block, seg_slots),
    ``tiles.DEFAULT_SHAPE`` by default (``cache.tiling``); its memos are
    filled under the lock too."""
    shape = _tiles.DEFAULT_SHAPE if shape is None else tuple(map(int, shape))

    def build():
        t = _tiles.SkyTiling(nside, *shape)
        t._fill = _shared
        return t
    return _shared(_group(nside, shape), "tiling", "tiling", build)


def stencil_tables(nside, device):
    """``stencil.stencil_tables`` of the default tiling on ``device``
    (``cache.stencil_tables``)."""
    device = _resolved(device)

    def build():
        t = tiling(nside)
        return _stencil.stencil_tables(t, _tiles.stencil_host_info(t),
                                       device)
    return _shared(_group(nside, _tiles.DEFAULT_SHAPE),
                   ("stencil_tables", device), "stencil_tables", build)


def stencil_geo(nside, rdt, device):
    """``stencil.stencil_geo`` of the default tiling in the regrid dtype
    ``rdt`` on ``device`` (``cache.stencil_geo``)."""
    device = _resolved(device)
    return _shared(
        _group(nside, _tiles.DEFAULT_SHAPE), ("stencil_geo", rdt, device),
        "stencil_geo",
        lambda: _stencil.stencil_geo(tiling(nside),
                                     stencil_tables(nside, device), rdt))


def clear_geometry_cache():
    """Drop every kept tiling, stencil table and source list, giving
    their host and device memory back; the next lookup builds anew."""
    with _lock:
        old = list(_groups.values())
        _groups.clear()
    _drop(old)
