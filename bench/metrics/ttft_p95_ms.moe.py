"""ttft_p95_ms.moe: ``ttft_p95_ms``'s arithmetic where the window holds too
few first tokens for the tail to judge a change (recorded, not bounded)."""

from bench.timeline import percentile_ms


def read(run):
    return percentile_ms(run.ttfts_s(), 95)
