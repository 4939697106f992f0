"""The public grid deposits (``ops.scatter.deposit_2d`` / ``deposit_3d``)
and the ``native`` CPU helpers of the port, against the JAX package.

``deposit_2d`` / ``deposit_3d`` take the JAX names and arguments (grid,
positions (M, d), values (M,)) and return a new grid. On the CPU they run
the plain versions, held here against the JAX functions on positions
inside and outside [0, N), at exact integers, at -N, N and at a tiny
negative value that rounds onto N: float64 to 1e-12 of the largest |cell|;
float32 against the float64 result within 1.25 times the JAX float32
result's own error (XLA rounds the float32 weights its own way). The
wrappers check their arguments as the list entry of kernel K16 needs them
(the card test holds the kernel against the plain version).

``native.regrid_hpix_cpu``, ``deposit_2d_cpu``, ``deposit_3d_cpu`` and
``cell_query_counts`` take the JAX native functions' arguments and give
their float64 / int64 results (the JAX ones from host C++ built with g++,
the port's in numpy and its own cell list): the deposits and the regrid to
1e-12, the counts equal where the JAX list visits each cell once (rmax <=
L / 3), and equal to brute force past that, where the JAX list counts a
cell twice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu import native as jnative               # noqa: E402
from baryonforge_tpu.ops import scatter as jscatter         # noqa: E402
from baryonforge_torch import native as tnative             # noqa: E402
from baryonforge_torch.ops import scatter as tscatter       # noqa: E402

TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def deposit_inputs(ndim, N, M, seed):
    """A random grid, M positions in [-N/4, 5N/4) (some outside [0, N)),
    a tenth of them exact integers, and edge values -N, N, -1e-9 (float32
    rounds it onto N once N is added) and 0; values in [0, 2)."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0, 1, (N,) * ndim)
    pos = rng.uniform(-N / 4, 5 * N / 4, (M, ndim))
    pos[: M // 10] = np.floor(pos[: M // 10])
    pos[-4:] = np.array([-N, N, -1e-9, 0.0])[:, None]
    vals = rng.uniform(0, 2, M)
    return grid, pos, vals


def jax_deposit(ndim, grid, pos, vals, dt):
    fn = jscatter.deposit_2d if ndim == 2 else jscatter.deposit_3d
    return np.asarray(fn(jnp.asarray(grid, JDT[dt]), jnp.asarray(pos, JDT[dt]),
                         jnp.asarray(vals, JDT[dt])), dtype=np.float64)


def port_deposit(ndim, grid, pos, vals, dt):
    fn = tscatter.deposit_2d if ndim == 2 else tscatter.deposit_3d
    out = fn(*(torch.as_tensor(x, dtype=TDT[dt]) for x in (grid, pos, vals)))
    assert out.dtype == TDT[dt] and out.shape == grid.shape
    return out.double().numpy()


@pytest.mark.parametrize("ndim,N,M", [(2, 33, 3000), (3, 12, 4000)])
def test_public_deposits_match_jax(ndim, N, M):
    """deposit_2d / deposit_3d on the CPU against the JAX functions, f64 to
    1e-12 of the grid's scale and f32 within 1.25 times the JAX f32 error
    against the f64 result; the input grid is left as it was and the mass
    added is the values' sum."""
    grid, pos, vals = deposit_inputs(ndim, N, M, seed=ndim * 100 + N)
    keep = grid.copy()
    ref = jax_deposit(ndim, grid, pos, vals, "f64")
    got = port_deposit(ndim, grid, pos, vals, "f64")
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(grid, keep)
    np.testing.assert_allclose(got.sum() - grid.sum(), vals.sum(),
                               rtol=1e-12)
    err32 = np.abs(port_deposit(ndim, grid, pos, vals, "f32") - ref).max()
    jerr32 = np.abs(jax_deposit(ndim, grid, pos, vals, "f32") - ref).max()
    assert 0 < jerr32 and err32 <= 1.25 * jerr32, (err32, jerr32)


def test_public_deposit_edges():
    """An integer position deposits its whole value into its cell, and N
    or a negative value wraps (float64)."""
    N = 8
    grid = torch.zeros((N, N, N), dtype=torch.float64)
    pos = torch.tensor([[1.0, 2.0, 3.0], [-1.0, 8.0, 15.0]],
                       dtype=torch.float64)
    out = tscatter.deposit_3d(grid, pos, torch.tensor([2.0, 5.0],
                                                      dtype=torch.float64))
    want = torch.zeros_like(grid)
    want[1, 2, 3] = 2.0
    want[7, 0, 7] = 5.0
    assert torch.equal(out, want)


def test_public_deposits_check_arguments():
    """Shapes and dtypes the list entry does not take are refused on every
    device: a grid that is not (N,) * d, positions that are not (M, d),
    values that are not (M,), and mixed or integer dtypes."""
    g2 = torch.zeros((4, 4), dtype=torch.float64)
    p2 = torch.zeros((3, 2), dtype=torch.float64)
    v = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="grid"):
        tscatter.deposit_2d(torch.zeros((4, 5), dtype=torch.float64), p2, v)
    with pytest.raises(ValueError, match="positions"):
        tscatter.deposit_3d(torch.zeros((4,) * 3, dtype=torch.float64), p2,
                            v)
    with pytest.raises(ValueError, match="values"):
        tscatter.deposit_2d(g2, p2, v[:2])
    with pytest.raises(TypeError, match="positions"):
        tscatter.deposit_2d(g2, p2.float(), v)
    with pytest.raises(TypeError, match="dtype"):
        tscatter.deposit_2d(g2.long(), p2.long(), v.long())
    assert set(tscatter.__all__) >= {"deposit_2d", "deposit_3d"}


@pytest.mark.parametrize("ndim", [2, 3])
def test_native_deposits_match_jax(ndim):
    """native.deposit_{2,3}d_cpu against the JAX native's (host C++) to
    1e-12, float64 grids of zeros of shape (N,) * d."""
    N = 32 if ndim == 2 else 16
    _, pos, vals = deposit_inputs(ndim, N, 600, seed=ndim)
    jfn = jnative.deposit_2d_cpu if ndim == 2 else jnative.deposit_3d_cpu
    tfn = tnative.deposit_2d_cpu if ndim == 2 else tnative.deposit_3d_cpu
    ref = jfn(N, pos, vals)
    got = tfn(N, pos, vals)
    assert got.dtype == np.float64 and got.shape == (N,) * ndim
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_native_regrid_hpix_matches_jax():
    rng = np.random.default_rng(9)
    npix, n = 300, 120
    vals = rng.uniform(0, 1, n)
    cpix = rng.integers(0, npix, (n, 4))
    w = rng.dirichlet(np.ones(4), n)
    got = tnative.regrid_hpix_cpu(npix, vals, cpix, w)
    assert got.dtype == np.float64 and got.shape == (npix,)
    np.testing.assert_allclose(got, jnative.regrid_hpix_cpu(npix, vals, cpix,
                                                            w),
                               rtol=1e-12, atol=1e-15)


def brute_counts(pos, L, centers, radii):
    d = pos[None, :, :] - centers[:, None, :]
    d = d - L * np.round(d / L)
    return ((d ** 2).sum(-1) <= radii[:, None] ** 2).sum(1)


def test_native_cell_query_counts():
    """cell_query_counts equals the JAX native's where its list visits
    each cell once (radii under L / 3), the port's cell_query counts, and
    brute force; past L / 3 it equals brute force (the JAX list counts
    some cells twice there)."""
    rng = np.random.default_rng(4)
    L = 60.0
    pos = rng.uniform(-L, 2 * L, (3000, 3))
    centers = rng.uniform(0, L, (25, 3))
    radii = rng.uniform(2.0, 12.0, 25)
    got = tnative.cell_query_counts(pos, L, centers, radii)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, jnative.cell_query_counts(pos, L, centers, radii))
    np.testing.assert_array_equal(
        got, tnative.cell_query(pos, L, centers, radii)[0])
    np.testing.assert_array_equal(
        got, brute_counts(np.mod(pos, L), L, centers, radii))
    wide = radii + L / 3
    np.testing.assert_array_equal(
        tnative.cell_query_counts(pos, L, centers, wide),
        brute_counts(np.mod(pos, L), L, centers, wide))
    assert tnative.cell_query_counts(pos, L, centers[:0],
                                     radii[:0]).shape == (0,)


def test_ptr_holds_its_tensor():
    """A launcher's pointer argument ``_build.ptr(x.contiguous())`` keeps
    the copy alive while the pointer lives, and passes where a ctypes
    function takes a c_void_p (here ctypes.memmove on CPU tensors)."""
    import ctypes
    import gc
    import weakref

    from baryonforge_torch.ops import _build
    data = torch.arange(40, dtype=torch.float64).reshape(10, 4)
    col = data[:, 3].contiguous()
    alive = weakref.ref(col)
    p = _build.ptr(col)
    del col
    gc.collect()
    assert alive() is not None and p.value == alive().data_ptr()
    dst = torch.zeros(10, dtype=torch.float64)
    ctypes.memmove(_build.ptr(dst), p, 10 * 8)
    assert torch.equal(dst, data[:, 3])
    del p
    gc.collect()
    assert alive() is None


def test_deposits_take_column_slices():
    """deposit_2d / deposit_3d of positions and values given as column
    slices of one (M, d + 1) tensor equal the same deposit of contiguous
    copies, bit for bit."""
    rng = np.random.default_rng(9)
    for ndim, fn in ((2, tscatter.deposit_2d), (3, tscatter.deposit_3d)):
        N = 7
        data = torch.as_tensor(rng.uniform(-N, 2 * N, (500, ndim + 1)))
        grid = torch.as_tensor(rng.uniform(0, 1, (N,) * ndim))
        want = fn(grid, data[:, :ndim].contiguous(),
                  data[:, ndim].contiguous())
        assert torch.equal(fn(grid, data[:, :ndim], data[:, ndim]), want)
