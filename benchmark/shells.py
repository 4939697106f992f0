"""What the HEALPix shell configurations share: the program's inputs made
from a traffic shell, the reference's per-halo columns, and the numbers
that decide ``correct``.

The program side imports ``baryonforge_torch`` (inside the functions, so
that the reference side and the CPU tests can import this module alone);
the reference side uses ``benchmark.reference`` only.
"""

import numpy as np
import torch

__all__ = ["cosmo_dict", "profile_params", "table_grid", "program_inputs",
           "reference_halos", "reference_curves", "mass_gap", "map_gaps",
           "dtype_of"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def dtype_of(name):
    return _DTYPES[name]


def cosmo_dict(cfg):
    return dict(cfg["cosmology"])


def profile_params(cfg):
    """The profile parameters as floats (JSON holds -inf as a string)."""
    return {k: float(v) for k, v in cfg["profile_params"].items()}


def table_grid(cfg, mix):
    """setup_interpolator's keywords: the configuration's M and r grids and
    its z samples over the traffic's shell, widened by ``z_pad`` on both
    sides."""
    t = dict(cfg["table"])
    pad = t.pop("z_pad")
    t["z_min"] = float(mix["z_lo"]) - pad
    t["z_max"] = float(mix["z_hi"]) + pad
    return t


def program_inputs(cfg, shell):
    """The program's (HaloLightConeCatalog, LightconeShell) for a traffic
    shell."""
    from baryonforge_torch import utils
    cd = cosmo_dict(cfg)
    cat = utils.HaloLightConeCatalog(ra=shell["ra"], dec=shell["dec"],
                                     M=shell["M"], z=shell["z"], cosmo=cd)
    return cat, utils.LightconeShell(map=shell["map"], cosmo=cd)


def reference_halos(cosmo, shell, epsilon_max, device):
    """Per-halo float64 columns on ``device`` in the reference's own
    cosmology: theta, phi, the disc's angular radius epsilon_max R200c /
    D_A, D_A, a, comoving R200c (Rcom), rscale (1: r-sampled tables) and
    M. The declination is kept off the poles by 1e-10 degrees, as the
    catalog does."""
    from .reference import cosmo_core, massdef
    z = torch.as_tensor(shell["z"], dtype=torch.float64, device=device)
    M = torch.as_tensor(shell["M"], dtype=torch.float64, device=device)
    a = 1.0 / (1.0 + z)
    R = massdef.MassDef200c.get_radius(cosmo, M, a)
    D = cosmo_core.angular_diameter_distance(cosmo, a)
    dec = np.clip(shell["dec"], -90 + 1e-10, 90 - 1e-10)
    theta = torch.as_tensor(np.radians(90.0 - dec), device=device)
    phi = torch.as_tensor(np.radians(shell["ra"]), device=device)
    return dict(theta=theta, phi=phi, radius=R * epsilon_max / D, D=D, a=a,
                Rcom=R / a, rscale=torch.ones_like(a), M=M)


def reference_curves(table, axes, halos, dtype, fill):
    """Per-halo radial curves of a (z, M, r) table at each halo's (z, M),
    in float64, rounded to ``dtype``; (curves, ln_r0, dlnr)."""
    from .reference.interp import collapse_curves_plain
    dev = halos["M"].device
    tab = torch.as_tensor(table, dtype=torch.float64, device=dev)
    ax = tuple(torch.as_tensor(x, dtype=torch.float64, device=dev)
               for x in axes)
    curves, ln_r0, dlnr = collapse_curves_plain(tab, ax, 2, halos["M"],
                                                halos["a"], [], {}, fill)
    return curves.to(dtype), float(ln_r0), float(dlnr)


def mass_gap(out, orig):
    """|sum(out) - sum(orig)| / sum(orig), the map's mass lost or made."""
    s = float(np.sum(orig))
    return abs(float(np.sum(out)) - s) / s


def map_gaps(out, ref, base):
    """(sum |out - ref| / sum |ref - base|, max |out - ref| / max |ref -
    base|): the answer's misplaced share, summed and at its worst pixel,
    against what the reference puts there (base = the input map for a
    displacement, zero for a paint)."""
    diff = np.abs(np.asarray(out, np.float64) - ref)
    scale = np.abs(ref - base)
    return (float(diff.sum() / scale.sum()), float(diff.max() / scale.max()))
