"""Host grids with ``jax.numpy``'s rounding.

``jnp.linspace`` and ``jnp.geomspace`` round differently from numpy's: a
linspace point is start (1 - i/n) + stop (i/n), and a geomspace is
10 ** linspace(log10 start, log10 stop) with neither end forced. The JAX
package builds some grids with jnp and others with np; where parity needs
the same points, the port builds each with the same arithmetic, in float64
numpy on the host.

A frozen copy of ``baryonforge_torch/ops/grids.py`` at the commit that added
the benchmark: the benchmark's reference, which imports nothing of the
program and is not edited with it.
"""

import numpy as np

__all__ = ["jnp_linspace", "jnp_geomspace"]


def jnp_linspace(start, stop, num):
    """``jnp.linspace(start, stop, num)`` (endpoint included), float64."""
    start, stop = np.float64(start), np.float64(stop)
    if num == 1:
        return np.array([start])
    div = num - 1
    step = np.arange(div, dtype=np.float64) / np.float64(div)
    return np.concatenate([start * (1 - step) + stop * step, [stop]])


def jnp_geomspace(start, stop, num):
    """``jnp.geomspace(start, stop, num)`` for positive ends, float64."""
    lin = jnp_linspace(np.log10(np.float64(start)),
                       np.log10(np.float64(stop)), num)
    return np.power(10.0, lin)
