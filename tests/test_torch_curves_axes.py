"""Kernel K1 (the per-halo curve collapse) past four parameter axes, on the
CPU against the JAX package.

K1 takes any number of parameter axes: up to four in one kernel a number of
axes, from five on in ``collapse_curves_wide``, which forms the 2^(2+P)
corners' weights in groups of 64 and carries each radius' sum from one
group to the next in the output row. Its plain version,
``ops.interp.collapse_curves_plain``, is held against the JAX
``collapse_curves`` at P = 5 and 6 (float64 to 1e-12 of the largest |curve|,
float32 to 1e-6 with that floor, as at fewer axes), with halos off every
axis getting ``fill``; the per-halo corners of ``halo_corners_plain``,
summed group by group as the wide kernel sums them, rebuild the plain
collapse bit for bit. A JAX ``ParamTabulatedProfile`` with five ``p_keys``
goes across through ``utils.convert`` and gives the JAX ``halo_curves``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import utils as JUtils                 # noqa: E402
from baryonforge_tpu.cosmo import core as jcore             # noqa: E402
from baryonforge_tpu.cosmo import massdef as jmassdef       # noqa: E402
from baryonforge_tpu.ops import interp as jinterp           # noqa: E402
from baryonforge_torch.ops import interp as tinterp         # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402

from test_torch_curves import COSMO_DICT                    # noqa: E402

TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}
# the wide kernel's corners a group (kGroup in csrc/curves.cu)
GROUP = 64
P_SIZES = (3, 2, 2, 3, 2, 2)


def wide_table(n_p, seed, n=40):
    """A random (z, M, r, p1 .. pP) table with increasing, unevenly spaced
    axes, and n halos inside it, but for one below and one above each axis
    (halos 0 .. 2 (2 + P) - 1) and one on a parameter axis' first point."""
    rng = np.random.default_rng(seed)
    shape = (3, 4, 8) + P_SIZES[:n_p]
    axes = [np.cumsum(rng.uniform(0.2, 1.0, k)) for k in shape]
    table = rng.normal(size=shape)
    M = np.exp(rng.uniform(axes[1][0], axes[1][-1], n))
    a = 1.0 / np.exp(rng.uniform(axes[0][0], axes[0][-1], n))
    p = {f"p{k}": rng.uniform(axes[3 + k][0], axes[3 + k][-1], n)
         for k in range(n_p)}
    a[0:2] = 1.0 / np.exp([axes[0][0] - 0.1, axes[0][-1] + 0.1])
    M[2:4] = np.exp([axes[1][0] - 0.1, axes[1][-1] + 0.1])
    for k in range(n_p):
        p[f"p{k}"][4 + 2 * k:6 + 2 * k] = [axes[3 + k][0] - 0.1,
                                           axes[3 + k][-1] + 0.1]
        p[f"p{k}"][-1] = axes[3 + k][0]
    return table, axes, M, a, p


@pytest.mark.parametrize("n_p", [5, 6])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_collapse_curves_many_axes_match_jax(n_p, dt):
    """The plain collapse (the CPU's ``collapse_curves``) against the JAX
    collapse_curves at 5 and 6 parameter axes; every halo with a
    coordinate off an axis is a row of fill, the rest are not."""
    table, axes, M, a, p = wide_table(n_p, seed=60 + n_p)
    keys = sorted(p)
    tt = torch.as_tensor(table, dtype=TDT[dt])
    tax = tuple(torch.as_tensor(x, dtype=TDT[dt]) for x in axes)
    got, r0, dl = tinterp.collapse_curves(tt, tax, 2, M, a, keys, p,
                                          fill=-3.0)
    jc, jr0, jdl = jinterp.collapse_curves(
        jnp.asarray(table, JDT[dt]), tuple(jnp.asarray(x, JDT[dt])
                                           for x in axes),
        2, M, a, keys, p, fill=-3.0)
    jc = np.asarray(jc)
    rtol = 1e-12 if dt == "f64" else 1e-6
    np.testing.assert_allclose(got.numpy(), jc, rtol=rtol,
                               atol=rtol * np.abs(jc).max())
    assert (r0, dl) == (float(jr0), float(jdl))
    off = (jc == -3.0).all(axis=1)
    assert off[:2 * (2 + n_p)].all() and not off[2 * (2 + n_p):].any()


@pytest.mark.parametrize("n_p", [5, 6])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_wide_corner_groups_rebuild_the_plain_collapse(n_p, dt):
    """The wide kernel's sum: each group of 64 corners (weights and row
    offsets of ``halo_corners_plain``) added in corner order onto the sum
    the groups before it left, from 0; bit for bit the plain collapse."""
    table, axes, M, a, p = wide_table(n_p, seed=70 + n_p)
    keys = sorted(p)
    tt = torch.as_tensor(table, dtype=TDT[dt])
    tax = tuple(torch.as_tensor(x, dtype=TDT[dt]) for x in axes)
    w, off, stride_r, oob = tinterp.halo_corners_plain(tt, tax, 2, M, a,
                                                       keys, p)
    corners = 2 ** (2 + n_p)
    assert w.shape == off.shape == (M.size, corners)
    assert corners % GROUP == 0
    rows = tt.reshape(-1)[off[:, :, None]
                          + torch.arange(table.shape[2]) * stride_r]
    acc = torch.zeros((M.size, table.shape[2]), dtype=TDT[dt])
    for c0 in range(0, corners, GROUP):
        for c in range(c0, c0 + GROUP):
            acc = acc + w[:, c:c + 1] * rows[:, c]
    acc = torch.where(oob[:, None], torch.full_like(acc, -3.0), acc)
    plain = tinterp.collapse_curves_plain(tt, tax, 2, M, a, keys, p,
                                          fill=-3.0)[0]
    assert torch.equal(acc, plain)


def test_axis_capacity_is_the_table_limit():
    """The ctypes copies of CurveAxes / CurveHalos hold 2 + MAX_P_AXES
    axes: as many as a table of fewer than 2^31 values can have with 2
    points on every axis (one more axis reaches 2^31)."""
    cap = 2 + tinterp.MAX_P_AXES
    assert 2 ** (cap + 1) < 2 ** 31 <= 2 ** (cap + 2)
    for struct in (tinterp._CurveAxes, tinterp._CurveHalos):
        for name, ctype in struct._fields_:
            if hasattr(ctype, "_length_"):
                assert ctype._length_ == cap, name


P_VALS = {"theta_ej": [3.0, 4.0, 5.0], "theta_co": [0.05, 0.1],
          "M_c": [5e13, 3e14], "mu_beta": [0.3, 0.5], "delta": [6.0, 8.0]}


def jax_five_key_table(seed=5):
    """A JAX ParamTabulatedProfile with five p_keys and a random table, set
    as its setup_interpolator sets them (no profile is evaluated)."""
    rng = np.random.default_rng(seed)
    z = np.geomspace(0.7, 1.1, 3)
    M = np.geomspace(5e12, 2e15, 5)
    r = np.geomspace(1e-3, 60, 12)
    vals = [np.asarray(v) for v in P_VALS.values()]
    shape = [z.size, M.size, r.size] + [v.size for v in vals]
    jt = JUtils.ParamTabulatedProfile(None, jcore.cosmology_from_dict(
        COSMO_DICT), mass_def=jmassdef.MassDef200c)
    jt.p_keys = list(P_VALS)
    jt.raw_input_z_range = np.log(1 + z)
    jt.raw_input_M_range = np.log(M)
    jt.raw_input_r_range = np.log(r)
    for k, v in zip(jt.p_keys, vals):
        setattr(jt, f"raw_input_{k}_range", v)
    jt._axes = tuple(jnp.asarray(x) for x in
                     [jt.raw_input_z_range, jt.raw_input_M_range,
                      jt.raw_input_r_range] + vals)
    jt._tab3D = jnp.asarray(np.exp(rng.normal(size=shape)))
    jt._tab2D = jnp.asarray(np.exp(rng.normal(size=shape)))
    return jt


def test_five_key_table_converts():
    """``utils.convert.tabulated_from_jax`` carries a five-key JAX
    ParamTabulatedProfile across: its p_keys, axes and tables, and on the
    CPU its projected halo_curves (per-halo columns, some halos off an
    axis: fill 0) equal the JAX object's to 1e-12."""
    jt = jax_five_key_table()
    tt = convert.tabulated_from_jax(jt, device="cpu")
    assert tt.p_keys == list(P_VALS) and len(tt._axes) == 8
    for x, y in zip(tt._axes, jt._axes):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rng = np.random.default_rng(8)
    n = 30
    M = 10 ** rng.uniform(13.0, 15.0, n)
    a = 1.0 / (1.0 + rng.uniform(0.75, 1.05, n))
    kw = {k: rng.uniform(min(v) - 0.05 * (max(v) - min(v)),
                         max(v) + 0.05 * (max(v) - min(v)), n)
          for k, v in P_VALS.items()}
    kw["theta_ej"][:3] = [2.5, 5.5, 3.0]
    np.testing.assert_array_equal(tt._tab3D.numpy(), np.asarray(jt._tab3D))
    c, r0, dl = tt.halo_curves(M, a, **kw)
    jc, jr0, jdl = jt.halo_curves(M, a, **kw)
    jc = np.asarray(jc)
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-12,
                               atol=1e-12 * np.abs(jc).max())
    assert (r0, dl) == (float(jr0), float(jdl))
    assert (jc[:2] == 0).all() and (jc[2] != 0).any()
