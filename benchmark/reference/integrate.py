"""Integration primitives: cumulative Simpson and trapezoid rules.

Port of ``baryonforge_tpu.ops.integrate`` (scipy's cumulative_simpson and
trapezoid rules on tensors). Results lie on the input's device.

A frozen copy of ``baryonforge_torch/ops/integrate.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import numpy as np
import torch

__all__ = ["cumulative_simpson_uniform", "cumulative_trapezoid", "trapz",
           "simpson_increments"]


def simpson_increments(y, dx=1.0):
    """The per-interval increments of scipy's cumulative Simpson rule along
    the last axis of ``y`` (n >= 3 samples), shape (..., n - 1).

    Each interval takes half of the quadratic through a triplet: scipy
    walks non-overlapping triplets (0,1,2), (2,3,4), ...; an even interval
    is the left half of the quadratic starting there, an odd interval the
    right half of the one starting before it, and when the interval count
    is odd the last one is the right half of the final triplet.
    """
    n = y.shape[-1]
    f0, f1, f2 = y[..., :-2], y[..., 1:-1], y[..., 2:]
    left = dx / 12.0 * (5.0 * f0 + 8.0 * f1 - f2)
    right = dx / 12.0 * (-f0 + 8.0 * f1 + 5.0 * f2)
    i = np.arange(n - 1)
    use_right = (i % 2 == 1) | (i == n - 2) & (i % 2 == 0) & (i > 0)
    qidx = torch.as_tensor(np.where(use_right, i - 1, np.minimum(i, n - 3)),
                           device=y.device)
    return torch.where(torch.as_tensor(use_right, device=y.device),
                       right[..., qidx], left[..., qidx])


def cumulative_simpson_uniform(y, dx=1.0, axis=-1):
    """Cumulative composite Simpson integral on a uniform grid, initial=0
    (scipy.integrate.cumulative_simpson(y, dx=dx, initial=0))."""
    y = torch.movedim(y, axis, -1)
    inc = simpson_increments(y, dx)
    out = torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(inc, -1)],
                    dim=-1)
    return torch.movedim(out, -1, axis)


def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, initial=0.0):
    """Cumulative trapezoid with an ``initial`` value prepended."""
    y = torch.movedim(y, axis, -1)
    d = torch.diff(x) if x is not None else dx
    inc = 0.5 * d * (y[..., 1:] + y[..., :-1])
    out = torch.cat([torch.full_like(y[..., :1], initial),
                     initial + torch.cumsum(inc, -1)], dim=-1)
    return torch.movedim(out, -1, axis)


def trapz(y, x, axis=-1):
    """Trapezoid rule of ``y`` over the sample points ``x`` along ``axis``,
    in ``jnp.trapezoid``'s order of operations. ``x`` is 1-D or has the
    shape of ``y``."""
    y = torch.movedim(y, axis, -1)
    if x.dim() > 1:
        x = torch.movedim(x, axis, -1)
    return 0.5 * (torch.diff(x) * (y[..., 1:] + y[..., :-1])).sum(-1)
