"""anis_paint: PaintProfilesAnisShell painting the gas temperature weighted
by the N-body map, from three tabulated S19 profiles (``anis_paint.json``):
the model a Temperature (the S19 pressure over the gas number density),
the tracer the S19 Gas, Mtot the S19 DarkMatterBaryon.

The program side builds the three tables on the card and a new runner a
shell, the shell at the mix's ``z_mid``; the reference side builds the
tables' projected halves in plain PyTorch (``benchmark.reference``) and
paints the shell by the upstream runner's disc scatter path
(``reference.anis``) in float64, or, for the control (``control`` in the
JSON), with the tables' line-of-sight sums in float32 and the paint in
bfloat16 summed in float32.
"""

import numpy as np
import torch

from benchmark import shells as S


def _profiles(S19, Thermo, Temp, cfg):
    """(model, tracer, Mtot): Temperature(Pressure, GasNumberDensity),
    Gas and DarkMatterBaryon on the S19 parameters (with their
    proj_cutoff)."""
    bpar = S.profile_params(cfg)
    temp = Temp.Temperature(pressure=Thermo.Pressure(**bpar),
                            gasnumberdensity=Temp.GasNumberDensity(**bpar),
                            **bpar)
    return temp, S19.Gas(**bpar), S19.DarkMatterBaryon(**bpar)


def _tracer_fraction(cfg):
    """The runner's global_tracer_fraction: Omega_b / Omega_m."""
    return cfg["cosmology"]["Omega_b"] / cfg["cosmology"]["Omega_m"]


class _Program:
    """The program's three TabulatedProfiles and the shells' redshift."""

    def __init__(self, model, tracer, mtot, redshift):
        self.model, self.tracer, self.mtot = model, tracer, mtot
        self.redshift = redshift


def program_model(cfg, mix, device):
    """The program's three TabulatedProfiles, built on ``device``."""
    from baryonforge_torch import cosmo, utils
    from baryonforge_torch.Profiles import Schneider19, Thermodynamic
    c = cosmo.cosmology_from_dict(S.cosmo_dict(cfg))
    grid = S.table_grid(cfg, mix)
    tabs = [utils.TabulatedProfile(p, c, device=device).setup_interpolator(
        **grid) for p in _profiles(Schneider19, Thermodynamic, Thermodynamic,
                                   cfg)]
    return _Program(*tabs, redshift=float(mix["z_mid"]))


def runner(cfg, model, inputs, device):
    """A new PaintProfilesAnisShell on one shell's (catalog, map), the
    shell at the mix's z_mid."""
    from baryonforge_torch.Runners import PaintProfilesAnisShell
    cat, shell = inputs
    shell.redshift = model.redshift
    r = cfg["runner"]
    return PaintProfilesAnisShell(
        cat, shell, epsilon_max=cfg["epsilon_max"], model=model.model,
        Tracer_model=model.tracer, Mtot_model=model.mtot,
        background_val=r["background_val"],
        global_tracer_fraction=_tracer_fraction(cfg),
        dtype=S.dtype_of(r["dtype"]),
        regrid_dtype=S.dtype_of(r["regrid_dtype"]), deposit=r["deposit"],
        device=device)


def program_table(model):
    """The three log tables of projected * a (model, tracer, Mtot)."""
    return np.stack([np.asarray(t.raw_input_2D)
                     for t in (model.model, model.tracer, model.mtot)])


def _los_projected(prof, cosmo, r, M, a, dtype):
    """``prof.projected`` with its line-of-sight sums in ``dtype``: the
    reference's real-space projection (``profile_base.Profile.
    _projected_realspace``) with the integrand and the sum rounded to
    ``dtype``; a Temperature the ratio of two such, a GasNumberDensity its
    gas's times its factor."""
    from benchmark.reference import temperature
    from benchmark.reference.integrate import trapz
    if isinstance(prof, temperature.Temperature):
        return prof._ratio(
            _los_projected(prof.Pressure, cosmo, r, M, a, dtype),
            _los_projected(prof.GasNumberDensity, cosmo, r, M, a, dtype))
    if isinstance(prof, temperature.GasNumberDensity):
        return _los_projected(prof.Gas, cosmo, r, M, a, dtype) * prof.factor
    _, r_proj_np = prof._projection_grids(r)
    r_proj = torch.as_tensor(r_proj_np, device=r.device)
    s = torch.sqrt(r_proj[None, :] ** 2 + r[:, None] ** 2)
    vals = prof._real(cosmo, s.reshape(-1), M, a).reshape(
        M.numel(), r.numel(), r_proj.numel()).to(dtype)
    rp = r_proj.to(dtype)
    proj = 2.0 * trapz(vals * rp, torch.log(rp)) + 2.0 * rp[0] * vals[..., 0]
    return proj.double()


class _Tables:
    """The reference's three log tables of projected * a (model, tracer,
    Mtot) on the (log(1+z), log M, log r) grid, and what the paint needs
    besides: the cosmology, Mtot's proj_cutoff and the shells' redshift."""

    def __init__(self, cfg, mix, device, control):
        from benchmark.reference import cosmo_core, schneider19
        from benchmark.reference import tabulate, temperature, thermodynamic
        from benchmark.reference.anis import no_tf32
        no_tf32()
        self.cosmo = cosmo_core.cosmology_from_dict(S.cosmo_dict(cfg))
        profs = _profiles(schneider19, thermodynamic, temperature, cfg)
        self.proj_cutoff = float(profs[2].proj_cutoff)
        self.redshift = float(mix["z_mid"])
        grid = S.table_grid(cfg, mix)
        z, M, r = tabulate._grids(
            grid["z_min"], grid["z_max"], grid["N_samples_z"],
            grid["M_min"], grid["M_max"], grid["N_samples_Mass"],
            grid["R_min"], grid["R_max"], grid["N_samples_R"],
            grid["z_linear_sampling"])
        r_t = torch.as_tensor(r, device=device)
        M_t = torch.as_tensor(M, device=device)
        los = S.dtype_of(cfg["control"]["projection"] if control
                         else "float64")

        def table(p):
            return np.stack([
                (_los_projected(p, self.cosmo, r_t, M_t, 1 / (1 + zj), los)
                 / (1 + zj)).cpu().numpy() for zj in z])
        with np.errstate(divide="ignore", invalid="ignore"):
            self.tables = np.log(np.stack([table(p) for p in profs]))
        self.axes = (np.log(1 + z), np.log(M), np.log(r))


def reference_model(cfg, mix, device, control=False):
    """The reference's three tables, built on ``device`` (their
    line-of-sight sums in float32 for the control)."""
    return _Tables(cfg, mix, device, control)


def reference_table(model):
    return model.tables


def reference_map(cfg, model, shell, device, control=False):
    """The shell painted by the reference: float64 numpy."""
    from benchmark.reference.anis import anis_paint_plain, no_tf32
    no_tf32()
    dt, acc = ((cfg["control"]["paint"], cfg["control"]["accumulate"])
               if control else ("float64", "float64"))
    halos = S.reference_halos(model.cosmo, shell, cfg["epsilon_max"], device)
    painting, tracer, mtot = (
        S.reference_curves(t, model.axes, halos, S.dtype_of(dt), -np.inf)
        for t in model.tables)
    orig = torch.as_tensor(shell["map"], dtype=torch.float64, device=device)
    bgw = cfg["runner"]["background_val"] * _tracer_fraction(cfg)
    out, _ = anis_paint_plain(cfg["nside"], halos, painting, tracer, mtot,
                              orig, model.cosmo, model.redshift,
                              model.proj_cutoff, bgw, S.dtype_of(acc))
    return out.double().cpu().numpy()


def compare(cfg, prog_table, ref_table, shell, out, ref_out, kept):
    """The numbers compared: the largest gap of the three log tables
    (infinite where the two differ in which entries are finite); the
    sampled shell's map, its summed gap over the reference's sum and its
    worst pixel's gap over the reference's largest pixel."""
    fin_p, fin_r = np.isfinite(prog_table), np.isfinite(ref_table)
    if prog_table.shape != ref_table.shape or (fin_p != fin_r).any():
        table_gap = float("inf")
    else:
        table_gap = float(np.abs(prog_table[fin_r] - ref_table[fin_r]).max())
    map_gap, pixel_gap = S.map_gaps(out, ref_out, 0.0)
    return dict(table_gap=table_gap, map_gap=map_gap, pixel_gap=pixel_gap)
