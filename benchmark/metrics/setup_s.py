"""setup_s: from the process's start to the window's: imports, the kernels
loaded (built in a checkout's first run), the table built on the card,
the traffic made, one warm call."""


def read(ctx):
    return ctx.setup_s
