"""Process start to the first timed request: imports, CUDA start, weights on
the card, engines, the warm-up of every shape the cell uses (and, in a
checkout's first run, the kernel library's build)."""


def read(run):
    return run.setup_s
