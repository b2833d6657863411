"""``setup_s``: from the process's start to the window's: imports, the
kernels' build (a checkout's first run only), the inputs, the warm-up call
that captures the goal graphs."""


def read(run):
    return run.setup_s
