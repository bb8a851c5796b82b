"""Seconds from the process's start to the end of set-up: imports, weights
and inputs made from the seed, the program built, converted and captured,
its kernels built or loaded, and the warm-up requests or steps."""


def read(run):
    return run.setup_s
