"""The utility profiles (Profiles/misc.py) and the Battaglia12 profiles of
the torch port against baryonforge_tpu, the row-batched root finder
(utils.misc.safe_Pchip_minimize), the splines with knots of their own a
row (ops.interp), the per-halo radial route of the profiles
(Profiles.Base.eval_rows), and the package's exports.

Profiles run on the CPU (CPU tensors in the port) at a few (r, M, a).
Tolerances: profiles 1e-10 relative, with a floor at that fraction of the
array's largest value (tests/test_torch_profiles_s19.py; measured <=
3e-13); roots 1e-12 (measured: equal); the per-halo route 1e-13 of the
largest value against one call a halo (the same elementwise arithmetic on
other shapes); the splines bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

import baryonforge_tpu                                      # noqa: E402
from baryonforge_tpu import Profiles as JP                  # noqa: E402
from baryonforge_tpu import cosmo as jc                     # noqa: E402
from baryonforge_tpu.utils.misc import \
    safe_Pchip_minimize as jroot                            # noqa: E402
import baryonforge_torch as bf                              # noqa: E402
from baryonforge_torch import Profiles as TP                # noqa: E402
from baryonforge_torch.ops import interp as tinterp         # noqa: E402
from baryonforge_torch.Profiles import Base as TBase        # noqa: E402
from baryonforge_torch.Profiles import Schneider19 as TS19  # noqa: E402
from baryonforge_torch.utils import convert                 # noqa: E402
from baryonforge_torch.utils.misc import \
    safe_Pchip_minimize as troot                            # noqa: E402

from defaults import COSMO_DICT, bpar_A20, bpar_S19, bpar_S25  # noqa: E402
from test_torch_integrate_interp import close               # noqa: E402

RTOL = 1e-10
JCOSMO = jc.cosmology_from_dict(COSMO_DICT)
TCOSMO = bf.cosmo.cosmology_from_dict(COSMO_DICT)
M = np.array([3e12, 4e13, 8e14])
R = np.geomspace(2e-3, 3.0, 8)
K = np.geomspace(0.05, 20, 9)
A = 0.6


def t_(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# name -> (constructor on a Profiles package, methods to compare)
CASES = {
    "Truncation": (lambda P: P.misc.Truncation(epsilon_trunc=1.5),
                   ("real", "projected")),
    "Identity": (lambda P: P.misc.Identity(), ("real", "projected")),
    "Zeros": (lambda P: P.misc.Zeros(), ("real", "projected", "fourier")),
    "TruncatedFourier_B12": (lambda P: P.misc.TruncatedFourier(
        P.Battaglia.GasDensity("200_AGN"), epsilon_max=2.0, N_int=256),
        ("real", "fourier")),
    "TruncatedFourier_S19": (lambda P: P.misc.TruncatedFourier(
        P.DarkMatter(**bpar_S19), N_int=256), ("fourier",)),
    "ComovingToPhysical": (lambda P: P.misc.ComovingToPhysical(
        P.Battaglia.GasDensity("200_SH", proj_cutoff=100), factor=-3),
        ("real", "projected")),
    "Pressure_200_AGN": (lambda P: P.Battaglia.Pressure(
        "200_AGN", proj_cutoff=100), ("real", "projected", "fourier")),
    "Pressure_500_AGN": (lambda P: P.Battaglia.Pressure(
        "500_AGN", proj_cutoff=100), ("real", "projected")),
    "Pressure_500_SH": (lambda P: P.Battaglia.Pressure(
        "500_SH", truncate=2.0, proj_cutoff=100), ("real", "projected")),
    "ElectronPressure": (lambda P: P.Battaglia.ElectronPressure(
        "200_AGN", proj_cutoff=100), ("real", "projected")),
    "GasDensity_200_AGN": (lambda P: P.Battaglia.GasDensity(
        "200_AGN", proj_cutoff=100), ("real", "projected", "fourier")),
    "GasDensity_200_SH": (lambda P: P.Battaglia.GasDensity(
        "200_SH", truncate=1.0, proj_cutoff=100), ("real", "projected")),
}
RUNS = [(name, m) for name, (_, ms) in CASES.items() for m in ms]


def _eval(prof, method, cosmo, arr):
    x = K if method == "fourier" else R
    return getattr(prof, method)(cosmo, arr(x), arr(M), A)


@pytest.mark.parametrize("name,method", RUNS,
                         ids=[f"{n}-{m}" for n, m in RUNS])
def test_matches_jax(name, method):
    make = CASES[name][0]
    close(_eval(make(TP), method, TCOSMO, t_),
          _eval(make(JP), method, JCOSMO, jnp.asarray), RTOL)


def test_mdelta_to_mtot_matches_jax():
    for Ms in (M, 2e14):
        close(TP.Mdelta_to_Mtot(TP.Battaglia.GasDensity("200_AGN"))(
                  TCOSMO, t_(Ms), A),
              JP.Mdelta_to_Mtot(JP.Battaglia.GasDensity("200_AGN"))(
                  JCOSMO, Ms, A), RTOL)


def test_battaglia_refusals_and_rescaling():
    with pytest.raises(ValueError):
        TP.Battaglia.Pressure("200_SH")
    with pytest.raises(ValueError):
        TP.Battaglia.GasDensity("500_AGN")
    p = TP.Battaglia.Pressure("500_SH").real(TCOSMO, t_(R), t_(M), A)
    pe = TP.Battaglia.ElectronPressure("500_SH").real(TCOSMO, t_(R), t_(M),
                                                      A)
    torch.testing.assert_close(pe, bf.utils.constants.Pth_to_Pe * p,
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", ["Pressure", "GasDensity"])
def test_profile_from_jax(name):
    cal = "200_SH" if name == "GasDensity" else "500_AGN"
    jp = JP.misc.ComovingToPhysical(getattr(JP.Battaglia, name)(
        cal, truncate=1.5), factor=2) * 2.0
    tp = convert.profile_from_jax(jp)
    assert type(tp._A) is TP.misc.ComovingToPhysical
    assert type(tp._A.Profile) is getattr(TP.Battaglia, name)
    assert tp._A.Profile.mdef == getattr(TP.Battaglia, name)(cal).mdef
    close(tp.real(TCOSMO, t_(R), t_(M), A),
          jp.real(JCOSMO, R, jnp.asarray(M), A), RTOL)


# -- the root finder -------------------------------------------------------
def _rows(seed):
    """Seeded rows over a shared x: cubics with a root anywhere (the
    window clipped at both ends), falling and flat-topped ones, a row
    touching zero, an all-positive and an all-negative row, a row of
    zeros."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 3.0, 120)
    roots = np.concatenate([rng.uniform(-1.0, 3.0, 12), [-0.99, 2.99]])
    rows = [s * ((x - x0) ** 3 + rng.uniform(0.01, 1) * (x - x0))
            for x0, s in zip(roots, rng.choice([-1.0, 1.0], roots.size))]
    rows += [np.tanh(5 * (x - 1.3)) * (x < 2.0), (x - x[40]) ** 2,
             (x - 1.0) ** 2 + 0.3, -np.exp(x), np.zeros_like(x)]
    return x, np.array(rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_window", [2, 5])
def test_safe_pchip_minimize_matches_jax(seed, n_window):
    """Each row against the JAX function on that row (the way its callers
    vmap it), with a shared x and with x given a row; the fallbacks: +inf
    for an all-positive row, x at the smallest |y| otherwise."""
    x, ys = _rows(seed)
    want = np.array([float(jroot(jnp.asarray(y), jnp.asarray(x), n_window))
                     for y in ys])
    got = troot(t_(ys), t_(x), n_window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got_rows = troot(t_(ys), t_(np.tile(x, (len(ys), 1))), n_window)
    np.testing.assert_array_equal(got_rows.numpy(), got)
    assert np.isinf(got[-3]) and got[-2] == x[0] and got[-1] == x[0]
    np.testing.assert_allclose(got[-4], x[40], atol=1e-12)


# -- splines with knots of their own a row --------------------------------
def _old_spline_coeffs(x, y):
    """cubic_spline_coeffs before knots could vary by row (ops/interp.py
    of the parent tree), for the bitwise comparison."""
    x = x.to(device=y.device, dtype=torch.float64)
    h = x[1:] - x[:-1]
    zero = h.new_zeros(1)
    main = torch.cat([h[1:2], 2.0 * (h[:-1] + h[1:]), h[-2:-1]])
    lower = torch.cat([zero, h[:-1], (h[-1] + h[-2])[None]])
    upper = torch.cat([(h[0] + h[1])[None], h[1:], zero])
    slope = (y[..., 1:] - y[..., :-1]) / h
    rhs_int = 3.0 * (slope[..., 1:] * h[:-1] + slope[..., :-1] * h[1:])
    rhs0 = ((h[0] + 2.0 * (h[0] + h[1])) * h[1] * slope[..., 0]
            + h[0] ** 2 * slope[..., 1]) / (h[0] + h[1])
    rhsn = (h[-1] ** 2 * slope[..., -2]
            + (2.0 * (h[-1] + h[-2]) + h[-1]) * h[-2] * slope[..., -1]) \
        / (h[-1] + h[-2])
    rhs = torch.cat([rhs0[..., None], rhs_int, rhsn[..., None]], dim=-1)
    a, b, c = (t.cpu().numpy() for t in (lower, main, upper))
    n = b.size
    shape = (rhs.shape[:-1] or (1,)) + (n,)
    r = rhs.detach().reshape(-1, n).cpu().numpy().T
    cps = np.empty(n)
    dps = np.empty_like(r)
    cp_prev, dp_prev = 0.0, np.zeros(r.shape[1])
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (r[i] - a[i] * dp_prev) / denom
        cps[i], dps[i] = cp_prev, dp_prev
    ds = np.empty_like(r)
    x_next = np.zeros(r.shape[1])
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        ds[i] = x_next
    return torch.as_tensor(np.ascontiguousarray(ds.T).reshape(shape),
                           device=y.device)


def _old_spline_eval(x, y, d, xq, derivative):
    i = torch.clamp(tinterp.searchsorted_right(x, xq) - 1, 0,
                    x.shape[0] - 2)
    h = x[i + 1] - x[i]
    t = (xq - x[i]) / h
    if derivative:
        w = (6 * t * (t - 1) / h, (3 * t - 1) * (t - 1),
             -6 * t * (t - 1) / h, t * (3 * t - 2))
        return (w[0] * y[..., i] + w[1] * d[..., i] + w[2] * y[..., i + 1]
                + w[3] * d[..., i + 1])
    w = ((1 + 2 * t) * (1 - t) ** 2, t * (1 - t) ** 2,
         t ** 2 * (3 - 2 * t), t ** 2 * (t - 1))
    return (w[0] * y[..., i] + w[1] * h * d[..., i] + w[2] * y[..., i + 1]
            + w[3] * h * d[..., i + 1])


@pytest.fixture(scope="module")
def s19_spline_rows():
    """The knots and rows the Schneider19 collisionless matter hands its
    spline (recorded on a small call)."""
    seen = []
    solve = TS19.cubic_spline_coeffs

    def record(x, y):
        seen.append((x, y))
        return solve(x, y)
    TS19.cubic_spline_coeffs = record
    try:
        TP.CollisionlessMatter(**bpar_S19, r_steps=800).real(
            TCOSMO, t_(R), t_(M), A)
    finally:
        TS19.cubic_spline_coeffs = solve
    return seen[0]


def test_shared_knots_bitwise_unchanged(s19_spline_rows):
    x, y = s19_spline_rows
    xq = torch.log(t_(np.geomspace(1e-9, 2e5, 300)))
    d = tinterp.cubic_spline_coeffs(x, y)
    assert torch.equal(d, _old_spline_coeffs(x, y))
    assert torch.equal(tinterp.cubic_spline_coeffs(x, y[0]),
                       _old_spline_coeffs(x, y[0]))
    assert torch.equal(tinterp.cubic_spline_eval(x, y, d, xq),
                       _old_spline_eval(x, y, d, xq, False))
    assert torch.equal(tinterp.cubic_spline_derivative_eval(x, y, d, xq),
                       _old_spline_eval(x, y, d, xq, True))


def test_row_knots_match_a_loop(s19_spline_rows):
    """Knots of their own a row (each row's shifted by its own amount)
    give each row's shared-knot result, bitwise."""
    x, y = s19_spline_rows
    X = x[None, :] + torch.linspace(-0.3, 0.4, y.shape[0],
                                    dtype=torch.float64)[:, None]
    xq = torch.log(t_(np.geomspace(1e-9, 2e5, 300)))
    d = tinterp.cubic_spline_coeffs(X, y)
    v = tinterp.cubic_spline_eval(X, y, d, xq)
    g = tinterp.cubic_spline_derivative_eval(X, y, d, xq)
    for i in range(y.shape[0]):
        di = tinterp.cubic_spline_coeffs(X[i], y[i])
        assert torch.equal(d[i], di[0])
        assert torch.equal(v[i], tinterp.cubic_spline_eval(X[i], y[i], di[0],
                                                           xq))
        assert torch.equal(g[i], tinterp.cubic_spline_derivative_eval(
            X[i], y[i], di[0], xq))
    lower, main, upper, rhs = tinterp.spline_system(X, y)
    assert lower.shape == main.shape == upper.shape == rhs.shape == y.shape


# -- the per-halo radial route --------------------------------------------
def _per_halo_profiles():
    fams = {"Arico20": (TP.Arico20, bpar_A20),
            "Mead20": (TP.Mead20, TP.Mead20.Params_TAGN_7p8_All),
            "Schneider25": (TP.Schneider25, bpar_S25)}
    out = []
    for fam, (mod, par) in fams.items():
        for name in mod.__all__:
            cls = getattr(mod, name)
            if isinstance(cls, type) and cls.per_halo_r is True:
                out.append((f"{fam}.{name}", lambda c=cls, p=par: c(**p)))
    out += [(f"Battaglia.{n}", lambda n=n: getattr(TP.Battaglia, n)(
        "200_AGN")) for n in ("Pressure", "ElectronPressure", "GasDensity")]
    out += [("misc.Truncation", lambda: TP.misc.Truncation(epsilon_trunc=0.8)),
            ("Arico20.Gas algebra", lambda: 2.0 * TP.Arico20.BoundGas(
                **bpar_A20) + TP.Arico20.EjectedGas(**bpar_A20))]
    return out


PER_HALO = _per_halo_profiles()


@pytest.mark.parametrize("name,make", PER_HALO,
                         ids=[n for n, _ in PER_HALO])
def test_per_halo_route_is_one_call_a_halo(name, make):
    """eval_rows with radii of each halo's own (one call) equals one call a
    halo; a profile that is not elementwise in r takes the loop."""
    prof = make()
    assert prof.per_halo_r
    Ms = t_(np.geomspace(1e12, 1e15, 4))
    rows = t_(np.geomspace(1e-3, 2.0, 6)[None, :]
              * np.array([1.0, 0.7, 1.3, 2.1])[:, None])
    got = TBase.eval_rows(prof, TCOSMO, rows, Ms, A)
    want = torch.cat([prof._real(TCOSMO, rows[i], Ms[i:i + 1], A)
                      for i in range(4)])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-13 * float(want.abs().max()))


def test_eval_rows_loops_where_not_elementwise():
    prof = TP.DarkMatter(**bpar_S19)
    assert not prof.per_halo_r and not (prof + prof).per_halo_r
    Ms = t_([1e13, 1e14])
    rows = t_([[0.01, 0.1, 1.0], [0.02, 0.2, 2.0]])
    got = TBase.eval_rows(prof, TCOSMO, rows, Ms, A)
    for i in range(2):
        assert torch.equal(got[i], prof._real(TCOSMO, rows[i], Ms[i:i + 1],
                                              A)[0])


# -- exports ---------------------------------------------------------------
def test_profiles_export_the_jax_names():
    """baryonforge_torch.Profiles has every name baryonforge_tpu.Profiles
    has, the family modules hold the same public names, and the
    thermodynamic parameter list is the same set."""
    jnames = {n for n in dir(baryonforge_tpu.Profiles) if not
              n.startswith("_")}
    tnames = {n for n in dir(bf.Profiles) if not n.startswith("_")}
    assert jnames <= tnames, sorted(jnames - tnames)
    for n in ("Truncation", "Identity", "Zeros", "TruncatedFourier",
              "ComovingToPhysical", "Mdelta_to_Mtot", "Arico20", "Mead20",
              "Schneider25", "Battaglia", "misc"):
        assert n in tnames
        assert hasattr(bf, n) == hasattr(baryonforge_tpu, n)
    for mod in ("Arico20", "Mead20", "Schneider25", "Battaglia", "misc"):
        assert getattr(bf.Profiles, mod).__all__ == \
            getattr(baryonforge_tpu.Profiles, mod).__all__
    assert set(bf.Profiles.Thermodynamic.model_params) == \
        set(baryonforge_tpu.Profiles.Thermodynamic.model_params)
    assert bf.Profiles.Arico20.model_params == \
        baryonforge_tpu.Profiles.Arico20.model_params
    assert bf.Profiles.Mead20.model_params == \
        baryonforge_tpu.Profiles.Mead20.model_params
    assert bf.Profiles.Schneider25.model_params == \
        baryonforge_tpu.Profiles.Schneider25.model_params
