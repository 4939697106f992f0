"""The layout that kernel K20 forms on the card, on the CPU (torch only):
its layout pass emulated step by step (each halo's width class, the class
counts, each halo's rank among its chunk's, warp's and round's halos of its
class, the scan over the warps) and the groups cut from the class counts
(``ops.direct.class_groups``), against the plain version
``ops.direct.row_layout``; the readout on a layout whose ids lie in tensors
against the readout on the host layout; and the plain K20's rows under a
budget that cuts its classes.

Tolerances: none. The layout is integers, and the readout and the rows are
the same operations on the same values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_torch.ops import deposit, direct           # noqa: E402

# the layout pass's shape (csrc/disc_direct.cu: kLayoutWarps, kPerLane)
WARPS, PER_LANE = 32, 4
CHUNK = 32 * WARPS * PER_LANE


def _row_class(c):
    """Each count's width class as the kernel's row_class forms it (the
    highest set bit, then the power of two, 1.5 times it or twice it); -1
    for 0."""
    lg = torch.zeros_like(c)
    x = c.clone()
    for s in (32, 16, 8, 4, 2, 1):
        m = x >= (1 << s)
        lg += m * s
        x = torch.where(m, x >> s, x)
    p = torch.ones_like(c) << lg
    k = torch.where(c == p, torch.where(lg == 0, 0, 2 * lg - 1),
                    torch.where((p >= 2) & (c <= p + p // 2), 2 * lg,
                                2 * lg + 1))
    return torch.where(c > 0, k, -1)


def _layout_pass(counts):
    """The layout pass of K20 emulated: (base, order, class_counts) from
    the row counts (n,) int64, chunk by chunk as the block takes them."""
    n = counts.numel()
    cls = _row_class(counts)
    hist = torch.bincount(cls[cls >= 0], minlength=direct.CLASSES)
    width = torch.tensor([direct.class_width(k)
                          for k in range(direct.CLASSES)])
    first = torch.cumsum(hist, 0) - hist
    slot0 = torch.cumsum(hist * width, 0) - hist * width
    seen = torch.zeros(direct.CLASSES, dtype=torch.int64)
    base = torch.full((n,), -7, dtype=torch.int64)
    order = torch.full((n,), -7, dtype=torch.int64)
    for c0 in range(0, n, CHUNK):
        # halo c0 + 32 (PER_LANE w + j) + lane: warp w's round j
        h = torch.arange(c0, c0 + CHUNK).view(WARPS, PER_LANE, 32)
        k = torch.full(h.shape, -1, dtype=torch.int64)
        k[h < n] = cls[h[h < n]]
        onehot = torch.nn.functional.one_hot(k.clamp(min=0),
                                             direct.CLASSES) * (k >= 0)[
                                                 ..., None]
        # a lane's rank among its warp's halos of its class: the rounds
        # before (the warp's running count) and the lanes below (the match)
        per_round = onehot.sum(2)                         # (W, R, C)
        before = torch.cumsum(per_round, 1) - per_round
        below = torch.cumsum(onehot, 2) - onehot          # (W, R, 32, C)
        rank = (before[:, :, None, :] + below).gather(
            3, k.clamp(min=0)[..., None])[..., 0]
        # the warps' counts scanned over the warps, after earlier chunks
        wc = per_round.sum(1)                             # (W, C)
        wfirst = seen[None, :] + torch.cumsum(wc, 0) - wc
        seen = seen + wc.sum(0)
        live = (h < n) & (k >= 0)
        hh, kk = h[live], k[live]
        r = wfirst[torch.arange(WARPS)[:, None, None].expand(h.shape)[live],
                   kk] + rank[live]
        order[first[kk] + r] = hh
        base[hh] = slot0[kk] + width[kk] * r
        base[h[(h < n) & (k < 0)]] = -1
    return base, order, hist.int()


def _card_layout(counts, budget=direct.ROW_BUDGET):
    """The RowLayout K20 forms from row counts, its arrays in tensors."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    base, order, hist = _layout_pass(counts)
    return direct.RowLayout(counts, base, direct.class_groups(
        hist.tolist(), order, budget), direct.class_slots(hist.tolist()))


def _same(lay, ref):
    got = lay.numpy()
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.base, ref.base)
    assert got.n_slots == ref.n_slots
    assert len(got.groups) == len(ref.groups)
    for (h, K, s0), (h0, K0, s00) in zip(got.groups, ref.groups):
        assert (K, s0) == (K0, s00)
        np.testing.assert_array_equal(h, h0)


def _counts(case, rng):
    if case == "paint":      # many discs of no member
        c = rng.integers(1, 400, 5000)
        c[rng.random(c.size) < 0.3] = 0
        return c, direct.ROW_BUDGET
    if case == "displace":   # under 4 members raised to 4
        m = rng.integers(0, 60, 9000)
        return deposit._row_counts("displace", m), direct.ROW_BUDGET
    if case == "classes":    # widths across ~30 classes, three chunks
        c = np.exp(rng.uniform(0, np.log(2e5), 10000)).astype(np.int64)
        c[:40] = [2 ** 31 - 1, 2 ** 30, 3 * 2 ** 29, 3 * 2 ** 29 + 1] * 10
        return c, direct.ROW_BUDGET
    if case == "cut":        # a budget that cuts classes into groups
        return rng.integers(0, 40, 4200), 64
    if case == "tiny":       # one halo
        return np.array([5]), direct.ROW_BUDGET
    return np.zeros(0, dtype=np.int64), direct.ROW_BUDGET


CASES = ["paint", "displace", "classes", "cut", "tiny", "none"]


@pytest.mark.parametrize("case", CASES)
def test_card_layout_is_row_layout(case):
    """K20's layout pass and the host's groups give row_layout's layout
    bit for bit: counts, bases, groups (ids, width, first slot), slots."""
    counts, budget = _counts(case, np.random.default_rng(CASES.index(case)))
    lay = _card_layout(counts, budget)
    ref = direct.row_layout(counts, budget)
    _same(lay, ref)
    if case == "cut":
        assert len(ref.groups) > 2 * len(np.unique(
            direct.row_width(counts[counts > 0])))


def test_row_class_widths():
    """The kernel's class of a count, by its highest bit, is row_width's
    width: every count to 2^16 and some to 2^31 - 1."""
    c = np.concatenate([np.arange(1, 1 << 16),
                        np.random.default_rng(2).integers(1 << 16, 2 ** 31,
                                                          20000),
                        [2 ** 31 - 1, 2 ** 30, 3 * 2 ** 29]])
    k = _row_class(torch.as_tensor(c)).numpy()
    w = np.array([direct.class_width(int(x)) for x in range(direct.CLASSES)])
    np.testing.assert_array_equal(w[k], direct.row_width(c))
    assert k.max() < direct.CLASSES


@pytest.mark.parametrize("budget", [direct.ROW_BUDGET, 48])
def test_readout_device_ids(budget):
    """The readout on a layout whose counts and ids lie in tensors (K20's)
    equals the readout on the host layout, bit for bit."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 30, 700)
    lay = _card_layout(counts, budget)
    host = direct.row_layout(counts, budget)
    r = torch.as_tensor(rng.uniform(0.1, 5.0, host.n_slots))
    cols = {"M": torch.as_tensor(rng.uniform(1, 2, counts.size)),
            "a": torch.as_tensor(rng.uniform(0.5, 1, counts.size))}

    def fn(rr, M, a):
        return torch.sin(rr * a) * M / rr

    got = direct.readout(fn, r, lay, cols, torch.float64)
    want = direct.readout(fn, r, host, cols, torch.float64)
    assert torch.equal(got, want)
    assert lay.describe() == host.describe()


def test_disc_radii_plain_budget(monkeypatch):
    """The plain K20 under a budget that cuts its classes: the same rows
    and bases, more groups, each the row_layout of the counts."""
    rng = np.random.default_rng(4)
    n, nside = 300, 64
    halos = {"theta": np.arccos(rng.uniform(-1, 1, n)),
             "phi": rng.uniform(0, 2 * np.pi, n),
             "radius": rng.uniform(0.002, 0.06, n),
             "D": rng.uniform(1000, 2000, n), "a": rng.uniform(0.5, 0.6, n)}
    halos = {k: torch.as_tensor(v) for k, v in halos.items()}
    rows, lay = deposit.disc_radii(nside, halos, "paint", torch.float64)
    monkeypatch.setattr(direct, "ROW_BUDGET", 100)
    cut, lcut = deposit.disc_radii(nside, halos, "paint", torch.float64)
    for k in ("pix", "hid", "r"):
        assert torch.equal(rows[k], cut[k])
    np.testing.assert_array_equal(lay.base, lcut.base)
    assert len(lcut.groups) > len(lay.groups)
    _same(lcut, direct.row_layout(lay.counts, 100))
