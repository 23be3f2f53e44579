"""attn_roofline: the fused append-and-attention launch's roofline share
in the profiled slice: the launches' bound (``bench/roofline.py``, from
each step's rows) ÷ the device time of ``paged_attention_kernel``.
Nothing without a traced slice, or where the slice's trace, retaken,
still saw another number of launches than layers × steps."""

from bench.roofline import attention_work, bound_s
from bench.trace import ATTN_KERNEL


def read(run):
    sl = run.profile
    if sl is None or sl.launches != sl.expected:
        return None
    bound = sum(bound_s(*attention_work(run.spec, s.rows))
                for s in sl.steps) * run.spec.n_layers
    device = sl.op_seconds(ATTN_KERNEL)
    return 100.0 * bound / device
