"""ttft_p95_ms: 95th percentile, over every request due inside the window,
of its due (open loop) or send (closed loop) time to the host holding its
first token; a request without one by the window's end counts at its wait
so far, a refused one as infinitely late (host clock)."""

from bench.timeline import percentile_ms


def read(run):
    return percentile_ms(run.ttfts_s(), 95)
