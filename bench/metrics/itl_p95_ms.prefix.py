"""itl_p95_ms.prefix: ``itl_p95_ms``'s arithmetic in a cell served above
what it sustains (recorded, not bounded): there the tail is the host's
stall on each finish, whose share of the gaps swings with the load."""

from bench.timeline import percentile_ms


def read(run):
    return percentile_ms(run.itl_gaps_s(), 95)
