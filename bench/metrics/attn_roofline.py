"""attn_roofline: the fused append-and-attention launch's roofline share
in the profiled slice: the launches' bound (each step's attention work in
all its layers, by the cell's family from the step's rows, at the peaks of
``bench/roofline.py``) ÷ the device time of ``paged_attention_kernel``.
Nothing without a traced slice, or where the slice's trace, retaken,
still saw another number of launches than the family's a step × steps."""

from bench.roofline import bound_s
from bench.trace import ATTN_KERNEL


def read(run):
    sl = run.profile
    if sl is None or sl.launches != sl.expected:
        return None
    bound = sum(bound_s(*run.family.attention_work(run.spec, s.rows))
                for s in sl.steps)
    device = sl.op_seconds(ATTN_KERNEL)
    return 100.0 * bound / device
