"""peak_device_gib: torch.cuda.max_memory_allocated() over the window
(reset at its start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
