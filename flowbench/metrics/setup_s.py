"""setup_s: from the harness's start to the window's: imports, the kernel library, the inputs and
one warm-up call of the cell's own shape (host clock)."""


def read(ctx):
    return ctx["setup_s"]
