"""expert_roofline: the grouped expert products' roofline share in the
profiled slice: their bound (each step's expert work in all its expert
layers, by the cell's family from the step's live tokens — the tokens
its rows committed — at the peaks of ``bench/roofline.py``) ÷ the device
time of the kernels the family names (``EXPERT_KERNELS``).  Nothing
without a traced slice, where the family names no expert kernels, or
where the trace holds none of them."""

from bench.roofline import bound_s


def read(run):
    sl = run.profile
    kernels = getattr(run.family, "EXPERT_KERNELS", None)
    if sl is None or kernels is None:
        return None
    device = sum(sl.op_seconds(k) for k in kernels)
    if not device:
        return None
    bound = sum(bound_s(*run.family.expert_work(
        run.spec, sum(n for _, n in s.rows))) for s in sl.steps)
    return 100.0 * bound / device
