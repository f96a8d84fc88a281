"""``setup_s``: seconds from the process's start to the window: the
program's import, its kernels' build (the first run in a checkout) or load,
the inputs made from the seed, and one warm call an input.  Host clock."""


def read(run):
    return run.setup_s
