"""FLOPs and memory traffic of an eager step: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the compiled, partitioned HLO of a jitted step and
walks its call graph with trip-count multipliers (a ``lax.scan`` body
counted once by XLA's own cost analysis runs L times).  The port has no
HLO: its step is Python that dispatches aten ops one by one.  So
:func:`analyze` runs the step under two dispatch modes and counts what it
runs:

- ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total —
  2·M·N·K for every matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions, fused attention), forward and backward;
  elementwise work and reductions are not counted, as the reference counts
  only ``dot`` and ``convolution`` ops;
- ``hbm_bytes``: every aten op's tensor operands and outputs, in bytes,
  each counted where the op runs (an in-place op reads and writes its
  operand); views (``OpOverload.is_view``, and ``_unsafe_view``, a
  reshape that aliases) and queries that return no tensor (``prim.device``)
  move nothing and count 0.  As
  the reference counts slices and updates by the bytes they touch: a
  gather (``index``, ``index_select``, ``gather``, ``embedding``) twice
  its output, a scatter (``index_put``, ``index_copy``, ``index_add``,
  ``scatter``, ``scatter_add``, in place or not) twice its update, a
  ``copy_`` twice its source and a fill its output — never the whole
  tensor it reads from or writes into.  Like the reference's estimate this
  is an upper bound: nothing is fused.

A Python loop of L layers runs its body L times and is counted L times:
the counterpart of the trip-count correction.  Recomputation (``remat``,
the flash backward, checkpointed loss chunks) runs again and is counted
again, as the reference's HLO counts its recompute.

The step runs as given: on real tensors, or on fake ones
(``launch/abstract.py``) at shapes no device could hold — the op counts
need no data.  On one device there are no collectives:
``collective_bytes`` is empty and its total 0 (the port has no sharded
step yet; the dry run records the term as unknown).

The repository's CUDA kernels launch through ctypes, below the dispatcher,
so a dispatch mode does not see them: the caller adds their work with
``extra={"dot_flops": ..., "hbm_bytes": ...}`` (``chip_smoke.py`` has the
formulas: ``attention_work``).  On CPU tensors the kernels' plain versions
run as aten ops and are counted like any other.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


aten = torch.ops.aten


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


#: ops that read a slice of their input: twice the output's bytes
_GATHER = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
           aten.embedding.default}
#: ops that write a slice of their input: twice the update's bytes, the
#: update being this argument (a scalar update: the index's elements in
#: the destination's dtype)
_SCATTER = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2,
            aten.index_copy_.default: 3, aten.index_copy.default: 3,
            aten.index_add_.default: 3, aten.index_add.default: 3,
            aten.scatter_.src: 3, aten.scatter.src: 3,
            aten.scatter_.value: 2, aten.scatter.value: 2,
            aten.scatter_add_.default: 3, aten.scatter_add.default: 3}
_FILL = {aten.fill_.Scalar, aten.zero_.default}
#: aliasing reshapes whose schema does not say so
_ALIAS = {aten._unsafe_view.default, aten.lift_fresh.default}


def _op_bytes(func, args, kwargs, out) -> int:
    outs = tree_flatten(out)[0]
    if func.is_view or func in _ALIAS or not any(
            isinstance(o, torch.Tensor) for o in outs):
        return 0
    if func in _GATHER:
        return 2 * sum(map(_bytes, outs))
    if func in _SCATTER:
        upd = args[_SCATTER[func]]
        if isinstance(upd, torch.Tensor):
            return 2 * _bytes(upd)
        idx = args[2]  # scatter.value(self, dim, index, value)
        return 2 * idx.numel() * args[0].element_size()
    if func is aten.copy_.default:
        return 2 * _bytes(args[1])
    if func in _FILL:
        return _bytes(args[0])
    ins, _ = tree_flatten((args, kwargs))
    return sum(map(_bytes, ins)) + sum(map(_bytes, outs))


class _ByteCounter(TorchDispatchMode):
    """Adds each aten op's bytes (:func:`_op_bytes`) and counts the ops
    that move any."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = _op_bytes(func, args, kwargs, out)
        self.bytes += n
        self.ops += n > 0
        return out


def analyze(fn, *args, extra: dict | None = None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its work (module
    docstring).  Returns the reference's keys — ``dot_flops``,
    ``hbm_bytes``, ``collective_bytes``, ``collective_bytes_total``,
    ``collective_counts`` — and ``n_ops`` (aten ops that move bytes)
    and ``result`` (what ``fn`` returned)."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with flops, counter:
        result = fn(*args, **kwargs)
    extra = extra or {}
    return {
        "dot_flops": float(flops.get_total_flops()
                           + extra.get("dot_flops", 0.0)),
        "hbm_bytes": float(counter.bytes + extra.get("hbm_bytes", 0.0)),
        "collective_bytes": {},
        "collective_bytes_total": 0.0,
        "collective_counts": {},
        "n_ops": counter.ops,
        "result": result,
    }
