"""mfu_pct: the window's model FLOPs (``Run.model_flops``: the useful
work, top-k experts only, no padding) ÷ the window's seconds ÷ the card's
dense bf16 peak."""

from bench.roofline import PEAK_BF16_FLOPS


def read(run):
    return 100.0 * run.model_flops() / run.window_s / PEAK_BF16_FLOPS
