"""The yardstick of the roofline metrics: the card's published peaks and the
least work of each layer, counted from the cell's own inputs.

Nothing here reads the program's layouts (tiles, slots, pair lists): the
work is what the layer has to do for these halos and this map, whatever
implements it, so a redesign of a kernel leaves the counts as they are.

Bytes: each halo's columns and the table read once, the map read and
written once, and the offsets of the pixels the discs touch written once
(phase A) and read once (phase B). Operations: the member pixels of each
halo's disc, pi (epsilon_max R200c / D_A)^2 / pixel area with R200c and
D_A in the benchmark's plain cosmology (``benchmark.reference``), times a
count of operations per member pixel, each written below with its reason.
Every count is a floor of the work, so a share of the roofline stays at
or under 100%.
"""

import math

import numpy as np
import torch

__all__ = ["PEAKS", "least_seconds", "member_pixels", "touched_pixels",
           "phase_a", "phase_b", "paint"]

# NVIDIA H100 SXM5 80GB data sheet, dense, at the 700 W power limit
PEAKS = {"bytes_per_s": 3.35e12,
         "flops_per_s": {"float32": 67e12, "float64": 34e12}}

_SIZE = {"float32": 4, "float64": 8}

# per halo: theta, phi, M and z as given (float64), the columns every
# layer reads to place and size a disc
HALO_BYTES = 4 * 8

# operations per member pixel, the least any implementation does:
# phase A: the pixel's offset from the centre (3 products and 2 sums of
#   unit vectors for the chord), its radius (1 product), the table lerp in
#   ln r (1 log, 2 products, 2 sums), the tangent direction (4 products,
#   2 sums) and the two accumulations (2 sums): 19
PHASE_A_OPS = 19
# the paint: the chord (5), the radius (1), the lerp of the log curve (5),
#   its exp and the 1/a factor (2) and the accumulation (1): 14
PAINT_OPS = 14
# phase B, per pixel of the map: the displaced position (2 products, 2
#   sums), its 4 neighbours' bilinear weights (4 products, 4 sums) and the
#   4 weighted accumulations (4 products, 4 sums): 20
PHASE_B_OPS = 20


def least_seconds(n_bytes, n_ops, dtype):
    """The least time the card takes: the larger of bytes over the memory
    bandwidth and operations over the dtype's peak rate."""
    return max(n_bytes / PEAKS["bytes_per_s"],
               n_ops / PEAKS["flops_per_s"][dtype])


def member_pixels(cfg, shell):
    """Expected member pixels of the shell's discs: sum over halos of
    pi radius^2 / pixel area, radius = epsilon_max R200c / D_A."""
    from .reference import cosmo_core, massdef
    cosmo = cosmo_core.cosmology_from_dict(cfg["cosmology"])
    a = torch.as_tensor(1.0 / (1.0 + shell["z"]), dtype=torch.float64)
    M = torch.as_tensor(shell["M"], dtype=torch.float64)
    R = massdef.MassDef200c.get_radius(cosmo, M, a)
    D = cosmo_core.angular_diameter_distance(cosmo, a)
    rad = (cfg["epsilon_max"] * R / D).numpy()
    npix = 12 * cfg["nside"] ** 2
    return float(np.sum(math.pi * rad ** 2) / (4 * math.pi / npix))


def touched_pixels(cfg, members):
    """Expected distinct pixels of the shell's discs, npix (1 - exp(-members
    / npix)), as for discs spread uniformly over the sky: the pixels whose
    offsets phase A has to write and phase B has to read."""
    npix = 12 * cfg["nside"] ** 2
    return npix * -math.expm1(-members / npix)


def _table_values(cfg):
    t = cfg["table"]
    return t["N_samples_z"] * t["N_samples_Mass"] * t["N_samples_R"]


def phase_a(cfg, shell, members):
    """(bytes, ops, dtype) of phase A (the curves and the deposit of the
    tangent offsets): the halos' columns and the table read once, the
    touched pixels' two offsets written once, in the deposit dtype."""
    dt = cfg["runner"]["dtype"]
    n = shell["M"].size
    b = n * HALO_BYTES + _table_values(cfg) * _SIZE[dt] \
        + touched_pixels(cfg, members) * 2 * _SIZE[dt]
    return b, members * PHASE_A_OPS, dt


def phase_b(cfg, shell, members):
    """(bytes, ops, dtype) of phase B (the regrid): the touched pixels'
    offsets read once, the input map read once and the new map written
    once, in the regrid dtype."""
    dt, rdt = cfg["runner"]["dtype"], cfg["runner"]["regrid_dtype"]
    npix = 12 * cfg["nside"] ** 2
    b = touched_pixels(cfg, members) * 2 * _SIZE[dt] + 2 * npix * _SIZE[rdt]
    return b, npix * PHASE_B_OPS, rdt


def paint(cfg, shell, members):
    """(bytes, ops, dtype) of the paint (the curves and the disc or tile
    paint): the halos' columns and the table read once, the map written
    once, in the paint dtype."""
    dt = cfg["runner"]["dtype"]
    npix = 12 * cfg["nside"] ** 2
    n = shell["M"].size
    b = n * HALO_BYTES + _table_values(cfg) * _SIZE[dt] + npix * _SIZE[dt]
    return b, members * PAINT_OPS, dt
