"""Halo meshes, the runners' sharded sum, and the reference's parallel
front-ends (port of ``baryonforge_tpu.parallel.mesh``).

A mesh is an ordered list of ``torch.device``s, one a shard of the halo
catalog. A runner given ``mesh=`` splits its catalog into contiguous
shards (``np.array_split`` of the halo indices), runs phase A (or the
paint) of each shard into its own accumulator on that shard's device, on
a CUDA stream of its own, and sums the accumulators in shard order on the
runner's device (``sharded_sum``); phase B, if any, runs once on the sum.
On one card ``halo_mesh(4, device="cuda")`` gives four shards of that
card: their kernels may overlap one shard's host prep with another's
kernels; no collective is involved and no multi-GPU speed is claimed.
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["halo_mesh", "SimpleParallel", "SplitJoinParallel",
           "check_mesh", "sharded_sum", "to_device"]


def halo_mesh(n_devices=None, device=None):
    """The mesh: the visible CUDA devices (the first ``n_devices``), or,
    given ``device``, ``n_devices`` shards (1 by default) of that one
    device (the counterpart of the JAX tests' virtual 8-CPU mesh)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("halo_mesh: no CUDA device; pass device="
                               "'cpu' for a mesh of CPU shards")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        return devs if n_devices is None else devs[:int(n_devices)]
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"halo_mesh: n_devices={n_devices}")
    return [torch.device(device)] * n


def check_mesh(mesh, device):
    """``mesh`` as a list of torch.devices of ``device``'s type, or None.
    Raises TypeError for what is not a sequence of devices, ValueError for
    an empty mesh or one of another device type than the runner's."""
    if mesh is None:
        return None
    if isinstance(mesh, (str, torch.device)):
        raise TypeError("mesh: a sequence of devices (halo_mesh), not one "
                        "device")
    try:
        devs = [torch.device(d) for d in mesh]
    except (TypeError, RuntimeError) as e:
        raise TypeError(f"mesh: a sequence of devices (halo_mesh), not "
                        f"{mesh!r}") from e
    if not devs:
        raise ValueError("mesh: no device")
    if any(d.type != device.type for d in devs):
        raise ValueError(f"mesh: devices {devs} for a runner on {device}")
    return devs


def _resolved(device):
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


def to_device(x, dev):
    """``x`` (a tensor, or a tuple, list or dict of them and of other
    values) with its tensors on ``dev``: the same tensors where they are
    there already."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x


def sharded_sum(mesh, device, n, work):
    """``work(i, idx, dev)`` for each contiguous shard ``i``, ``idx``
    (numpy int64 indices of ``range(n)``, ``np.array_split`` into
    ``len(mesh)``) on its device ``dev``, each on a CUDA stream of its own
    that first waits for the runner's stream; its result, a tuple of
    tensors (or None), moved to ``device`` and summed in shard order on the
    runner's stream. Empty shards are skipped. Returns the summed tuple
    (None where every shard gave None). Without a mesh (``mesh`` None) the
    whole catalog is one shard: ``work(0, range(n), device)`` on the
    current stream, its result returned as it is."""
    if mesh is None:
        return tuple(work(0, np.arange(n), device))
    device = _resolved(device)
    cuda = device.type == "cuda"
    main = torch.cuda.current_stream(device) if cuda else None
    parts = []
    for i, (idx, dev) in enumerate(zip(np.array_split(np.arange(n),
                                                      len(mesh)), mesh)):
        if idx.size == 0:
            continue
        if not cuda:
            parts.append((work(i, idx, dev), None))
            continue
        dev = _resolved(dev)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            parts.append((work(i, idx, dev), stream))
    total = None
    for out, stream in parts:
        if stream is not None:
            main.wait_stream(stream)
            for x in out:
                if x is None:
                    continue
                if x.device == device:
                    # freed on the shard's stream only after the sum reads it
                    x.record_stream(main)
                else:
                    stream.synchronize()
        out = tuple(None if x is None else x.to(device) for x in out)
        total = out if total is None else tuple(
            _add(a, b) for a, b in zip(total, out))
    return total


class SimpleParallel:
    """Run a list of independent runners concurrently and return their
    outputs in order (reference Parallelize.py:58-113).

    The reference farms runners to loky processes; here each runner runs
    in a thread of a pool, on a CUDA stream of its own (made in the calling
    thread, after the calling thread's stream), so that one runner's host
    prep overlaps another's kernels on the card. Runners may share a model:
    its kept casts are made under a lock and complete before another
    stream reads them (``ops.interp.cast_copy``).

    ``njobs``: -1/None = one thread a runner (at most the host's cores);
    1 = sequential; N = N threads.
    """

    def __init__(self, Runner_list, njobs=-1, verbose=True):
        self.Runner_list = list(Runner_list)
        self.njobs = njobs
        self.verbose = verbose

    def process(self):
        runners = self.Runner_list
        n = len(runners)
        workers = (min(n, os.cpu_count() or 1) if self.njobs in (-1, None)
                   else max(1, int(self.njobs)))
        if workers <= 1 or n <= 1:
            return [r.process() for r in runners]
        streams = []
        for r in runners:
            dev = getattr(r, "device", torch.device("cpu"))
            if dev.type != "cuda":
                streams.append(None)
                continue
            dev = _resolved(dev)
            s = torch.cuda.Stream(device=dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            streams.append((dev, s))

        def run_one(i):
            if streams[i] is None:
                return runners[i].process()
            dev, s = streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(s):
                out = runners[i].process()
            s.synchronize()
            return out

        with ThreadPoolExecutor(max_workers=workers) as ex:
            futures = [ex.submit(run_one, i) for i in range(n)]
            return [f.result() for f in futures]


class SplitJoinParallel:
    """Split one runner's halo catalog across a mesh and sum the partial
    results (reference Parallelize.py:116-320): a copy of the runner with
    the mesh attached (``mesh``, else ``halo_mesh(njobs)`` on the runner's
    device type: the visible cards, or one CPU shard a job). Paint runners
    sum their maps, Baryonify runners their offsets (also a linear sum)."""

    def __init__(self, Runner, njobs=-1, seed=42, verbose=True, mesh=None):
        self.Runner = Runner
        if mesh is None:
            n = None if njobs in (-1, None) else njobs
            dev = getattr(Runner, "device", torch.device("cuda"))
            mesh = (halo_mesh(n) if dev.type == "cuda"
                    else halo_mesh(n or os.cpu_count() or 1, device=dev))
        self.mesh = mesh
        self.seed = seed
        self.verbose = verbose

    def process(self):
        runner = copy.copy(self.Runner)
        runner.mesh = self.mesh
        return runner.process()
