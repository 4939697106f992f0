"""Integration and interpolation primitives of the torch port against
baryonforge_tpu.ops.{integrate,interp}: cumulative Simpson (odd and even
sample counts), the trapezoid rules, jnp's searchsorted and interp, PCHIP,
the masked PCHIP (invalid points, too few points) and the not-a-knot
cubic spline family.

Inputs come from numpy seeds. Tolerances are float64 rounding: the
packages sum in other orders (XLA's cumulative sum, its fused
multiply-adds), so results agree to ~1e-14 of the largest value, held
here at 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import integrate as jint           # noqa: E402
from baryonforge_tpu.ops import interp as jinterp           # noqa: E402
from baryonforge_torch.ops import integrate as tint         # noqa: E402
from baryonforge_torch.ops import interp as tinterp         # noqa: E402
from baryonforge_torch.ops.grids import (jnp_geomspace,     # noqa: E402
                                         jnp_linspace)

RTOL = 1e-12


def close(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    fin = np.isfinite(j)
    scale = np.abs(j[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(t[fin], j[fin], rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("n", [3, 4, 7, 8, 500])
def test_cumulative_simpson_matches_jax(n):
    y = np.random.default_rng(n).normal(size=(3, n))
    close(tint.cumulative_simpson_uniform(torch.as_tensor(y), dx=0.3),
          jint.cumulative_simpson_uniform(jnp.asarray(y), dx=0.3))
    # along another axis
    close(tint.cumulative_simpson_uniform(torch.as_tensor(y.T), axis=0),
          jint.cumulative_simpson_uniform(jnp.asarray(y.T), axis=0))


def test_trapezoid_rules_match_jax():
    rng = np.random.default_rng(1)
    y = rng.normal(size=(4, 50))
    x = np.cumsum(rng.uniform(0.1, 1.0, 50))
    close(tint.cumulative_trapezoid(torch.as_tensor(y), torch.as_tensor(x),
                                    initial=2.0),
          jint.cumulative_trapezoid(jnp.asarray(y), jnp.asarray(x),
                                    initial=2.0))
    close(tint.trapz(torch.as_tensor(y), torch.as_tensor(x)),
          jint.trapz(jnp.asarray(y), jnp.asarray(x)))
    x2 = np.cumsum(rng.uniform(0.1, 1.0, (4, 50)), axis=1)
    close(tint.trapz(torch.as_tensor(y), torch.as_tensor(x2)),
          jnp.trapezoid(jnp.asarray(y), jnp.asarray(x2), axis=-1))


def test_jnp_grids():
    """The port's jnp-rounding grids against jnp's own, to an ulp or so
    (XLA's linspace arithmetic differs from numpy's in the last bit)."""
    for a, b, n in ((np.log(1e-4), 0.0, 512), (0.0, 1.0, 500)):
        np.testing.assert_allclose(jnp_linspace(a, b, n),
                                   np.asarray(jnp.linspace(a, b, n)),
                                   rtol=0, atol=4e-16 * max(abs(a), abs(b)))
    for a, b, n in ((1e-8, 1e5, 5000), (1e-6, 1e3, 500)):
        np.testing.assert_allclose(jnp_geomspace(a, b, n),
                                   np.asarray(jnp.geomspace(a, b, n)),
                                   rtol=1e-14)


def test_searchsorted_and_interp_match_jax():
    rng = np.random.default_rng(2)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 37))
    xq = rng.uniform(xp[0] - 2, xp[-1] + 2, 300)
    xq[:5] = [xp[0], xp[-1], xp[10], np.nan, xp[3]]
    j = np.asarray(jnp.searchsorted(jnp.asarray(xp), jnp.asarray(xq),
                                    side="right"))
    t = tinterp.searchsorted_right(torch.as_tensor(xp)[None],
                                   torch.as_tensor(xq)[None])[0]
    np.testing.assert_array_equal(t.numpy(), j)
    # an array that does not increase: JAX's bisection gives its own answer
    xu = rng.normal(size=20)
    j = np.asarray(jnp.searchsorted(jnp.asarray(xu), jnp.asarray(xq),
                                    side="right"))
    t = tinterp.searchsorted_right(torch.as_tensor(xu)[None],
                                   torch.as_tensor(xq)[None])[0]
    np.testing.assert_array_equal(t.numpy(), j)

    fp = rng.normal(size=(3, 37))
    xq2 = xq[5:].reshape(5, -1)
    for left, right in ((None, None), (0.0, -1.0)):
        j = np.stack([np.asarray(jnp.interp(jnp.asarray(xq2), jnp.asarray(xp),
                                            jnp.asarray(f), left=left,
                                            right=right)) for f in fp])
        t = tinterp.interp(torch.as_tensor(xq2), torch.as_tensor(xp),
                           torch.as_tensor(fp), left=left, right=right)
        close(t, j)
    close(tinterp.interp1d_linear(torch.as_tensor(xp), torch.as_tensor(fp[0]),
                                  torch.as_tensor(xq[5:])),
          jinterp.interp1d_linear(jnp.asarray(xp), jnp.asarray(fp[0]),
                                  jnp.asarray(xq[5:])))


def _curve(rng, n):
    x = np.cumsum(rng.uniform(0.05, 1.0, n))
    y = np.cumsum(rng.normal(0.3, 1.0, n))     # not monotone: sign changes
    y[5:9] = y[5]                              # a flat stretch
    return x, y


def test_pchip_matches_jax():
    rng = np.random.default_rng(3)
    x, y = _curve(rng, 40)
    xq = rng.uniform(x[0] - 1, x[-1] + 1, 200)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    d_j = jinterp.pchip_derivatives(jnp.asarray(x), jnp.asarray(y))
    d_t = tinterp.pchip_derivatives(xt, yt)
    close(d_t, d_j)
    close(tinterp.pchip_eval(xt, yt, d_t, torch.as_tensor(xq)),
          jinterp.pchip_eval(jnp.asarray(x), jnp.asarray(y), d_j,
                             jnp.asarray(xq)))
    for ext in (True, False):
        close(tinterp.pchip_interp(xt, yt, torch.as_tensor(xq), ext),
              jinterp.pchip_interp(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(xq), ext))
    # a batch of rows sharing x, as the relaxation of CollisionlessMatter
    ys = np.stack([_curve(rng, 40)[1] for _ in range(4)])
    d_b = tinterp.pchip_derivatives(xt, torch.as_tensor(ys))
    for k in range(4):
        close(d_b[k], jinterp.pchip_derivatives(jnp.asarray(x),
                                                jnp.asarray(ys[k])))


@pytest.mark.parametrize("case", ["some_invalid", "few_valid", "none_valid",
                                  "all_valid"])
@pytest.mark.parametrize("min_pts", [2, 5])
def test_masked_pchip_matches_jax(case, min_pts):
    rng = np.random.default_rng(4)
    x, y = _curve(rng, 30)
    valid = np.ones(30, bool)
    if case == "some_invalid":
        valid[rng.choice(30, 9, replace=False)] = False
    elif case == "few_valid":
        valid[:] = False
        valid[[3, 7, 11, 20, 25][:min_pts]] = True    # exactly min_pts
    elif case == "none_valid":
        valid[:] = False
    xq = rng.uniform(x[0] - 1, x[-1] + 1, 100)
    j = jinterp.masked_pchip_interp(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(valid), jnp.asarray(xq),
                                    min_pts=min_pts)
    t = tinterp.masked_pchip_interp(torch.as_tensor(x), torch.as_tensor(y),
                                    torch.as_tensor(valid),
                                    torch.as_tensor(xq), min_pts=min_pts)
    close(t, j)
    assert np.isnan(t.numpy()).all() == (case in ("few_valid",
                                                  "none_valid"))


def test_cubic_spline_family_matches_jax():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.uniform(0.05, 1.0, 60))
    y = np.stack([np.sin(x) * k + rng.normal(0, 0.01, 60) for k in (1, 2)])
    xq = rng.uniform(x[0], x[-1], 150)
    d_j = jinterp.cubic_spline_coeffs(jnp.asarray(x), jnp.asarray(y))
    d_t = tinterp.cubic_spline_coeffs(torch.as_tensor(x), torch.as_tensor(y))
    close(d_t, d_j)
    for fj, ft in ((jinterp.cubic_spline_eval, tinterp.cubic_spline_eval),
                   (jinterp.cubic_spline_derivative_eval,
                    tinterp.cubic_spline_derivative_eval)):
        close(ft(torch.as_tensor(x), torch.as_tensor(y), d_t,
                 torch.as_tensor(xq)),
              fj(jnp.asarray(x), jnp.asarray(y), d_j, jnp.asarray(xq)))
    # one row: the JAX function returns it as (1, N)
    close(tinterp.cubic_spline_coeffs(torch.as_tensor(x),
                                      torch.as_tensor(y[0])),
          jinterp.cubic_spline_coeffs(jnp.asarray(x), jnp.asarray(y[0])))
