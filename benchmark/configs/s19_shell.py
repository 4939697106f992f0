"""s19_shell: BaryonifyShell with a Baryonification2D(DarkMatterOnly,
DarkMatterBaryon) table on the S19 parameters (``s19_shell.json``).

The program side builds the table on the card and a new runner a shell;
the reference side builds the same table in plain PyTorch
(``benchmark.reference``) and displaces the shell by the scatter path's
plain versions (the disc deposit, then the 4-neighbour regrid), in
float64, or in the control's lower precisions (``control`` in the JSON).
"""

import numpy as np
import torch

from benchmark import shells as S


def program_model(cfg, mix, device):
    """The program's model with its table built on ``device``."""
    from baryonforge_torch import Profiles, cosmo
    from baryonforge_torch.Profiles.BaryonCorrection import Baryonification2D
    bpar = S.profile_params(cfg)
    model = Baryonification2D(Profiles.DarkMatterOnly(**bpar),
                              Profiles.DarkMatterBaryon(**bpar),
                              cosmo.cosmology_from_dict(S.cosmo_dict(cfg)),
                              epsilon_max=cfg["epsilon_max"], device=device)
    return model.setup_interpolator(**S.table_grid(cfg, mix))


def runner(cfg, model, inputs, device):
    """A new BaryonifyShell on one shell's (catalog, map)."""
    from baryonforge_torch.Runners import BaryonifyShell
    r = cfg["runner"]
    return BaryonifyShell(*inputs, epsilon_max=cfg["epsilon_max"],
                          model=model, dtype=S.dtype_of(r["dtype"]),
                          regrid_dtype=S.dtype_of(r["regrid_dtype"]),
                          deposit=r["deposit"], regrid=r["regrid"],
                          device=device)


def program_table(model):
    return np.asarray(model.raw_input_d)


def reference_model(cfg, mix, device, control=False):
    """The reference's table, built on ``device`` (rows in float32 for the
    control)."""
    from benchmark.reference import baryon_correction, cosmo_core
    from benchmark.reference import schneider19 as s19
    bpar = S.profile_params(cfg)
    model = baryon_correction.Baryonification2D(
        s19.DarkMatterOnly(**bpar), s19.DarkMatterBaryon(**bpar),
        cosmo_core.cosmology_from_dict(S.cosmo_dict(cfg)),
        epsilon_max=cfg["epsilon_max"], device=device)
    if control:
        model.rows_dtype = S.dtype_of(cfg["control"]["table_rows"])
    return model.setup_interpolator(**S.table_grid(cfg, mix))


def reference_table(model):
    return np.asarray(model.raw_input_d)


def reference_map(cfg, model, shell, device, control=False):
    """The shell displaced by the reference: float64 numpy."""
    from benchmark.reference.deposit import disc_deposit_plain
    from benchmark.reference.regrid import regrid_plain
    eps = cfg["epsilon_max"]
    dep, reg = ((cfg["control"]["deposit"], cfg["control"]["regrid"])
                if control else ("float64", "float64"))
    halos = S.reference_halos(model.cosmo, shell, eps, device)
    axes = (model.raw_input_z_range, model.raw_input_M_range,
            model.raw_input_r_range)
    curves, ln_r0, dlnr = S.reference_curves(model.raw_input_d, axes, halos,
                                             S.dtype_of(dep), 0.0)
    po = disc_deposit_plain(cfg["nside"], halos, curves, ln_r0, dlnr, eps)
    orig = torch.as_tensor(shell["map"], device=device).to(S.dtype_of(reg))
    return regrid_plain(cfg["nside"], po, orig).double().cpu().numpy()


def compare(cfg, prog_table, ref_table, shell, out, ref_out, kept):
    """The numbers compared: the table's largest gap over its largest
    value; the sampled shell's misplaced mass, summed and at its worst
    pixel, against the mass the reference moved; and the largest share of
    mass lost or made over the kept outputs (``kept``: (shell, output)
    pairs)."""
    scale = np.abs(ref_table).max()
    if prog_table.shape != ref_table.shape:
        table_gap = float("inf")
    else:
        table_gap = float(np.abs(prog_table - ref_table).max() / scale)
    map_gap, pixel_gap = S.map_gaps(out, ref_out, shell["map"])
    mass = max(S.mass_gap(o, s["map"]) for s, o in kept)
    return dict(table_gap=table_gap, map_gap=map_gap, pixel_gap=pixel_gap,
                mass_gap=mass)
