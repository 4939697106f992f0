"""The direct readout: the runners' path for models without ``halo_curves``.

The JAX runners' bodies call such a model on each halo's padded window of
pixels, cells or pairs (``model.displacement(r, M_h, a_h, **p_keys)``,
``model.projected(cosmo, r, M_h, a_h)`` or ``model.real(...)``) under
``jax.vmap`` (baryonforge_tpu/Runners/HealpixRunner.py:914, 1972,
2405-2408; Map2DRunner.py:410, 584, 609, 757-759; SnapshotRunner.py:196).
The port splits each body around that call: a kernel lays every halo's
radii out in rows (K20 ``ops.deposit.disc_radii``, K22
``ops.grid.grid_radii``, K23 ``ops.snapshot.snapshot_radii``),
:func:`readout` reads the model on the rows with ``torch.func.vmap``, one
call a group of rows, and a kernel turns the values into the body's sums
(K21 ``ops.paint.disc_apply``, K22 ``ops.grid.grid_direct``, K23
``ops.snapshot.snapshot_direct``).

A row holds one halo's radii, padded to its group's width: the halos are
grouped by their count (:func:`row_layout`), the widths running 1, 2, 3, 4,
6, 8, 12, 16, ... (each a power of two or 1.5 times one), so that a row
carries less than a third of padding. A pad slot holds the row's first
radius, a harmless value, and its value is set to 0 after the call, as the
JAX body masks its window.

The contract of such a model: its readout runs under ``torch.func.vmap``,
on a row of radii (a 1-D tensor) and the halo's scalars (0-d tensors), and
returns a tensor of the row's shape (or one the row's shape reshapes to).
So it is written in batchable torch operations on its arguments: no
``.item()``, no numpy and no Python branch on a value. This is the port's
form of the JAX contract "traceable jnp" (HealpixRunner.py:808-813). A
model that breaks it raises :class:`ReadoutContractError`; the runners
never fall back to a loop over the halos.
"""

import numpy as np
import torch

__all__ = ["ROW_BUDGET", "ReadoutContractError", "RowLayout", "row_width",
           "row_layout", "uniform_layout", "readout", "readout_model",
           "require"]

# padded slots a group, and so a model call, holds at most
ROW_BUDGET = 1 << 22

CONTRACT = (
    "a model without halo_curves is read by the runners under "
    "torch.func.vmap, on one halo's row of radii (a 1-D tensor) and its "
    "scalars (0-d tensors), and must return a tensor of the row's shape: "
    "write its readout in batchable torch operations on its arguments (no "
    ".item(), no numpy, no Python branch on a tensor's value)")


class ReadoutContractError(TypeError):
    """The model's readout could not run under ``torch.func.vmap`` (see the
    module docstring for the contract)."""


def row_width(counts):
    """The padded width of rows of ``counts`` radii: the least of 1, 2, 3,
    4, 6, 8, 12, 16, ... (powers of two and 1.5 times them) that holds
    them; 0 for 0. ``counts`` an int array, the widths int64."""
    c = np.asarray(counts, dtype=np.int64)
    p = np.where(c > 0, 2 ** np.floor(np.log2(np.maximum(c, 1))), 0) \
        .astype(np.int64)
    mid = p + p // 2
    return np.where(c <= p, p, np.where((p >= 2) & (c <= mid), mid, 2 * p))


class RowLayout:
    """Each halo's row: ``counts`` (n,) its radii, ``base`` (n,) int64 its
    first slot (-1 for a halo of no radii), ``groups`` [(halo ids (G,)
    int64, width K, first slot)], the rows of a group consecutive, ``G K``
    slots, and ``n_slots`` in all."""

    def __init__(self, counts, base, groups, n_slots):
        self.counts = counts
        self.base = base
        self.groups = groups
        self.n_slots = n_slots

    @property
    def n_radii(self):
        return int(self.counts.sum())

    @property
    def padded_share(self):
        """The share of the slots that are padding."""
        return 1.0 - self.n_radii / self.n_slots if self.n_slots else 0.0

    def describe(self):
        """One line a group (the runners print it when ``verbose``)."""
        lines = [f"direct readout: {self.n_radii} radii of "
                 f"{int((self.counts > 0).sum())} halos in "
                 f"{len(self.groups)} groups, {self.n_slots} slots "
                 f"({100 * self.padded_share:.1f}% padding)"]
        for gi, (h, K, s0) in enumerate(self.groups):
            n = int(self.counts[h].sum())
            lines.append(f"  group {gi + 1}/{len(self.groups)}: {h.size} "
                         f"halos x width {K}, {n} radii "
                         f"({100 * (1 - n / (h.size * K)):.1f}% padding)")
        return "\n".join(lines)


def row_layout(counts, budget=ROW_BUDGET):
    """Group the halos by :func:`row_width` of their ``counts`` (host ints),
    each group's halos in ascending index, a group cut where it would pass
    ``budget`` slots; returns the :class:`RowLayout`."""
    counts = np.asarray(counts, dtype=np.int64)
    width = row_width(counts)
    base = np.full(counts.shape, -1, dtype=np.int64)
    groups = []
    slot = 0
    for K in np.unique(width[width > 0]):
        K = int(K)
        idx = np.nonzero(width == K)[0]
        per = max(1, budget // K)
        for start in range(0, idx.size, per):
            h = idx[start:start + per]
            base[h] = slot + K * np.arange(h.size, dtype=np.int64)
            groups.append((h, K, slot))
            slot += K * h.size
    return RowLayout(counts, base, groups, slot)


def uniform_layout(m, K):
    """The :class:`RowLayout` of ``m`` rows of ``K`` radii each, one group,
    no padding (a grid bucket's cutouts)."""
    return RowLayout(np.full(m, K, dtype=np.int64),
                     K * np.arange(m, dtype=np.int64),
                     [(np.arange(m), K, 0)] if m else [], m * K)


def require(model, *names, runner=""):
    """Raise TypeError unless ``model`` has every readout of ``names`` (a
    model without ``halo_curves`` is read through them)."""
    missing = [n for n in names if not callable(getattr(model, n, None))]
    if missing:
        raise TypeError(
            f"{runner}: the model has no halo_curves, so it is read "
            f"directly, and it has no {' or '.join(missing)}() either "
            f"({type(model).__name__})")


def readout_model(model, dtype, device):
    """The model the direct readout calls: ``model.with_dtype(dtype,
    device)`` where the model has it (its tables in ``dtype`` on the
    runners' device), else the model itself, read in its own dtype."""
    if hasattr(model, "with_dtype"):
        return model.with_dtype(dtype, device=device)
    return model


def readout(fn, r, layout, cols, out_dtype, out=None):
    """Read a model on every row of ``layout``.

    fn        : fn(r_row, **scalars) -> the values at the row's radii; the
                halo's scalars are ``cols``' entries at its index
    r         : (n_slots,) radii in the rows' slots (pads not read)
    layout    : the :class:`RowLayout`
    cols      : dict name -> (n,) tensor of per-halo scalars
    out_dtype : dtype of the values returned
    out       : an (n_slots,) tensor of ``out_dtype`` on ``r``'s device to
                write them into (every slot is written), or None

    Returns the (n_slots,) values on ``r``'s device, 0 in pad slots, non-
    finite values kept (each body zeroes them where the JAX body does).
    Each group is one ``torch.func.vmap`` call of ``fn`` over its rows;
    a readout that cannot run so raises :class:`ReadoutContractError`.
    """
    dev = r.device
    vals = torch.zeros(layout.n_slots, dtype=out_dtype, device=dev) \
        if out is None else out
    names = list(cols)

    def row(rr, *scalars):
        out = fn(rr, **dict(zip(names, scalars)))
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"the readout returned {type(out).__name__}, "
                            "not a tensor")
        return out.reshape(rr.shape)

    call = torch.func.vmap(row)
    for h, K, s0 in layout.groups:
        G = h.size
        rows = r[s0:s0 + G * K].view(G, K)
        hi = torch.as_tensor(h, device=dev)
        valid = (torch.arange(K, device=dev)[None, :]
                 < torch.as_tensor(layout.counts[h], device=dev)[:, None])
        rows = torch.where(valid, rows, rows[:, :1])
        args = [cols[k][hi.to(cols[k].device)] for k in names]
        try:
            got = call(rows, *args)
        except (RuntimeError, TypeError, NotImplementedError) as e:
            raise ReadoutContractError(
                f"{CONTRACT}; the readout failed: {type(e).__name__}: {e}") \
                from e
        got = got.to(device=dev, dtype=out_dtype)
        vals[s0:s0 + G * K] = torch.where(valid, got,
                                          torch.zeros_like(got)).reshape(-1)
    return vals
