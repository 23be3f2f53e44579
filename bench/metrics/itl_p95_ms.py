"""itl_p95_ms: 95th percentile of the gaps between consecutive tokens of
one request, over every gap whose later token reached the host inside the
window; a preempted request's wait is one gap (host clock)."""

from bench.timeline import percentile_ms


def read(run):
    return percentile_ms(run.itl_gaps_s(), 95)
