"""``align_gcups``: table cells (m * n) of every alignment completed in the
window, over the window's seconds, in 10^9 a second.  Host clock."""


def read(run):
    return run.cells_done / run.window_s / 1e9
