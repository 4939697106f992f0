"""halos_per_s: halos of every shell whose call completed in the window,
over the window's whole time (its start to the end of its last call)."""


def read(ctx):
    halos = sum(u["halos"] for u in ctx.done())
    return halos / ctx.window_s if halos else None
