"""The card's peaks and the work of the fused append-and-attention launch.

Peaks: frozen copies of ``repro_torch/launch/roofline.py``'s H100 SXM5
data-sheet figures (dense bf16, HBM3), which ``chip_smoke.py`` also uses.
The work of one launch is a frozen adaptation of ``chip_smoke.py``'s
``attention_work`` to the rows of a serving step: each row's context K/V
(every position before the step and the chunk's own) read once, the
chunk's new K/V written once and read once as the kernel's input, q read
and the output written once; 4·D operations per (query, visible key) pair
per query head.  Counted from the rows' lengths, whatever kernel does the
work.
"""

from __future__ import annotations

from bench.spec import ModelSpec

PEAK_BF16_FLOPS = 989e12  # dense, H100 SXM5 data sheet
PEAK_HBM_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM5 data sheet


def attention_work(spec: ModelSpec, rows, itemsize: int = 2):
    """(bytes, ops) of ONE layer's launch over ``rows``: (context length
    before the step, tokens the step appends) per running row."""
    Hq, Hkv, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    byts = ops = 0
    for before, n in rows:
        if n <= 0:
            continue
        byts += 2 * (before + n) * Hkv * D * itemsize  # K/V read
        byts += 2 * 2 * n * Hkv * D * itemsize  # new K/V in, then written
        byts += 2 * n * Hq * D * itemsize  # q in, out written
        pairs = n * before + n * (n + 1) // 2  # query j sees before + j + 1
        ops += 4 * D * Hq * pairs
    return byts, ops


def bound_s(byts: float, ops: float) -> float:
    """The least time the card could take: bytes or operations at peak."""
    return max(byts / PEAK_HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)
