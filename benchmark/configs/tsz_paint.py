"""tsz_paint: PaintProfilesShell painting Compton-y from a tabulated,
pixel-convolved ThermalSZ profile on the S19 parameters
(``tsz_paint.json``).

The program side builds the table on the card and a new runner a shell;
the reference side builds the table's projected half in plain PyTorch
(``benchmark.reference``) and paints the shell by the disc paint's plain
version in float64, or in the control's lower precisions (``control`` in
the JSON).
"""

import numpy as np
import torch

from benchmark import shells as S


def _tsz(Profiles, Thermodynamic, utils, cfg):
    """The quickstart's chain: ThermalSZ(Pressure) convolved with the
    shell's HEALPix pixel window."""
    bpar = S.profile_params(cfg)
    prof = Thermodynamic.ThermalSZ(Thermodynamic.Pressure(**bpar), **bpar)
    return utils.ConvolvedProfile(prof, utils.HealPixel(cfg["nside"]))


def program_model(cfg, mix, device):
    """The program's TabulatedProfile, built on ``device``."""
    from baryonforge_torch import Profiles, cosmo, utils
    from baryonforge_torch.Profiles import Thermodynamic
    tab = utils.TabulatedProfile(_tsz(Profiles, Thermodynamic, utils, cfg),
                                 cosmo.cosmology_from_dict(S.cosmo_dict(cfg)),
                                 device=device)
    return tab.setup_interpolator(**S.table_grid(cfg, mix))


def runner(cfg, model, inputs, device):
    """A new PaintProfilesShell on one shell's (catalog, map)."""
    from baryonforge_torch.Runners import PaintProfilesShell
    r = cfg["runner"]
    return PaintProfilesShell(*inputs, epsilon_max=cfg["epsilon_max"],
                              model=model, dtype=S.dtype_of(r["dtype"]),
                              regrid_dtype=S.dtype_of(r["regrid_dtype"]),
                              deposit=r["deposit"], device=device)


def program_table(model):
    """The log table of projected * a that the paint reads."""
    return np.asarray(model.raw_input_2D)


class _Table:
    """The reference's log table of projected * a on the (log(1+z), log M,
    log r) grid."""

    def __init__(self, cfg, mix, device, control):
        from benchmark.reference import cosmo_core, pixel, tabulate
        from benchmark.reference import thermodynamic
        self.cosmo = cosmo_core.cosmology_from_dict(S.cosmo_dict(cfg))
        conv = _tsz(None, thermodynamic, pixel, cfg)
        if control:
            conv.dtype = S.dtype_of(cfg["control"]["convolution"])
        grid = S.table_grid(cfg, mix)
        z, M, r = tabulate._grids(
            grid["z_min"], grid["z_max"], grid["N_samples_z"],
            grid["M_min"], grid["M_max"], grid["N_samples_Mass"],
            grid["R_min"], grid["R_max"], grid["N_samples_R"],
            grid["z_linear_sampling"])
        r_t = torch.as_tensor(r, device=device)
        M_t = torch.as_tensor(M, device=device)
        tab = np.stack([(conv.projected(self.cosmo, r_t, M_t, 1 / (1 + zj))
                         / (1 + zj)).cpu().numpy() for zj in z])
        with np.errstate(divide="ignore", invalid="ignore"):
            self.table = np.log(tab)
        self.axes = (np.log(1 + z), np.log(M), np.log(r))


def reference_model(cfg, mix, device, control=False):
    """The reference's table, built on ``device`` (the pixel-window
    convolution in float32 for the control)."""
    return _Table(cfg, mix, device, control)


def reference_table(model):
    return model.table


def reference_map(cfg, model, shell, device, control=False):
    """The shell painted by the reference: float64 numpy."""
    from benchmark.reference.paint import disc_paint_plain
    dt, acc = ((cfg["control"]["paint"], cfg["control"]["accumulate"])
               if control else ("float64", "float64"))
    halos = S.reference_halos(model.cosmo, shell, cfg["epsilon_max"], device)
    curves, ln_r0, dlnr = S.reference_curves(model.table, model.axes, halos,
                                             S.dtype_of(dt), -np.inf)
    out = disc_paint_plain(cfg["nside"], halos, curves, ln_r0, dlnr, True,
                           False, S.dtype_of(acc))
    return out.double().cpu().numpy()


def compare(cfg, prog_table, ref_table, shell, out, ref_out, kept):
    """The numbers compared: the log table's largest gap (infinite where
    the two differ in which entries are finite); the sampled shell's
    paint, its summed gap over the reference's sum and its worst pixel's
    gap over the reference's largest pixel."""
    fin_p, fin_r = np.isfinite(prog_table), np.isfinite(ref_table)
    if prog_table.shape != ref_table.shape or (fin_p != fin_r).any():
        table_gap = float("inf")
    else:
        table_gap = float(np.abs(prog_table[fin_r] - ref_table[fin_r]).max())
    map_gap, pixel_gap = S.map_gaps(out, ref_out, 0.0)
    return dict(table_gap=table_gap, map_gap=map_gap, pixel_gap=pixel_gap)
