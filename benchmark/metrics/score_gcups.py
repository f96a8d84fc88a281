"""``score_gcups``: DP cells (the sum of m * n over every pair scored) of
every call completed in the window, over the window's seconds, in 10^9 a
second.  Host clock."""


def read(run):
    return run.cells_done / run.window_s / 1e9
