"""FLOPs and memory traffic of an eager step: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the compiled, partitioned HLO of a jitted step and
walks its call graph with trip-count multipliers (a ``lax.scan`` body
counted once by XLA's own cost analysis runs L times).  The port has no
HLO: its step is Python that dispatches aten ops one by one.  So
:func:`analyze` runs the step under one dispatch mode and counts what it
runs:

- ``dot_flops``: ``torch.utils.flop_counter``'s formulas (those of its
  ``FlopCounterMode``) summed —
  2·M·N·K for every matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions, fused attention), forward and backward; and
  for the token-major expert layer's grouped product (``_grouped_mm``,
  which that counter does not know) 2·M·N·K over every row of its
  [M, K] operand, the segments' total where every assignment is computed;
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
need no data.  On DTensors (a sharded step, ``launch/steps.py::sharded``)
every count is one device's: each DTensor op is let through to DTensor,
which runs it as ops on the rank's shards and collectives, and those are
counted.  ``collective_bytes`` counts the ``_c10d_functional``
collectives by the reference's definitions (``hlo_analysis.py``): an
all-reduce moves twice its output, an all-gather its gathered output, an
all-to-all its output, a reduce-scatter its scattered output times
``n_shards_hint`` (the reference passes the mesh's 'model' size, whatever
the group).  On one device there are none: ``collective_bytes`` is empty
and its total 0.

The repository's CUDA kernels launch through ctypes, below the dispatcher,
so a dispatch mode does not see them: the caller adds their work with
``extra={"dot_flops": ..., "hbm_bytes": ...}`` (``chip_smoke.py`` has the
formulas: ``attention_work``).  On CPU tensors the kernels' plain versions
run as aten ops and are counted like any other.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


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


_c10d = torch.ops._c10d_functional
#: the collectives DTensor issues -> (the reference's name, bytes moved as
#: a multiple of the output's; None: times ``n_shards_hint``)
_COLLECTIVES = {_c10d.all_reduce.default: ("all-reduce", 2),
                _c10d.all_gather_into_tensor.default: ("all-gather", 1),
                _c10d.reduce_scatter_tensor.default: ("reduce-scatter", None),
                _c10d.all_to_all_single.default: ("all-to-all", 1)}


_MUTED = threading.local()


@contextlib.contextmanager
def muted():
    """Ops run in the block are not counted: shape arithmetic that DTensor
    runs on tensors, which no device would."""
    prev = getattr(_MUTED, "on", False)
    _MUTED.on = True
    try:
        yield
    finally:
        _MUTED.on = prev


@contextlib.contextmanager
def _mute_sharding_propagation():
    """DTensor works out an op's output shape by running the op on fake
    tensors of the GLOBAL shapes; under an active ``FakeTensorMode`` those
    runs pass through the counter.  For the block they are muted.  The
    method is DTensor's own, private: a PyTorch without it raises, as its
    runs would otherwise be counted as one device's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    fn = ShardingPropagator.__dict__.get(name)
    if not callable(fn):
        raise RuntimeError(
            f"op_analysis: PyTorch {torch.__version__} has no "
            f"ShardingPropagator.{name}; DTensor's shape propagation "
            f"cannot be kept out of the count")

    def quiet(*args, **kwargs):
        with muted():
            return fn(*args, **kwargs)

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, fn)


class _Counter(TorchDispatchMode):
    """Counts each aten op's dot FLOPs (``torch.utils.flop_counter``'s
    formulas) and bytes (:func:`_op_bytes`), and each collective's bytes;
    DTensor ops pass through to DTensor, so what is counted is one rank's
    local ops and collectives."""

    def __init__(self, n_shards_hint: int = 1):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.n_shards = n_shards_hint
        self.coll_bytes = defaultdict(float)
        self.coll_count = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_MUTED, "on", False):
            return out
        if func in _COLLECTIVES:
            name, mult = _COLLECTIVES[func]
            self.coll_bytes[name] += _bytes(out) * (mult or self.n_shards)
            self.coll_count[name] += 1
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet is torch.ops.aten._grouped_mm:
            (m, k), n = args[0].shape, args[1].shape[-1]
            self.flops += 2 * m * k * n
        n = _op_bytes(func, args, kwargs, out)
        self.bytes += n
        self.ops += n > 0
        return out


def analyze(fn, *args, extra: dict | None = None, n_shards_hint: int = 1,
            **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its work (module
    docstring).  Returns the reference's keys — ``dot_flops``,
    ``hbm_bytes``, ``collective_bytes``, ``collective_bytes_total``,
    ``collective_counts`` — and ``n_ops`` (aten ops that move bytes)
    and ``result`` (what ``fn`` returned)."""
    counter = _Counter(n_shards_hint)
    with _mute_sharding_propagation(), counter:
        result = fn(*args, **kwargs)
    extra = extra or {}
    return {
        "dot_flops": float(counter.flops + extra.get("dot_flops", 0.0)),
        "hbm_bytes": float(counter.bytes + extra.get("hbm_bytes", 0.0)),
        "collective_bytes": dict(counter.coll_bytes),
        "collective_bytes_total": float(sum(counter.coll_bytes.values())),
        "collective_counts": dict(counter.coll_count),
        "n_ops": counter.ops,
        "result": result,
    }
