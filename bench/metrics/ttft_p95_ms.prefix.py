"""ttft_p95_ms.prefix: ``ttft_p95_ms``'s arithmetic in a cell served above
what it sustains, where the queue grows all through the window and the
tail follows the backlog, not the system's speed (recorded, not
bounded)."""

from bench.timeline import percentile_ms


def read(run):
    return percentile_ms(run.ttfts_s(), 95)
