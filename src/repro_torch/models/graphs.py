"""The non-paged decode step as captured CUDA graphs: the port's
counterpart of ``jax.jit(model.decode_step, donate_argnums=1)``.

``graph_decode_step(model)`` returns ``step(params, cache, batch) ->
(logits, cache)``, with ``Model.decode_step``'s signature and result.  On
a card it captures one ``torch.cuda.CUDAGraph`` per key and replays it on
every later call.  The key is the ``params`` module (by identity), the
card, and each cache and batch leaf's name, shape and dtype (the batch
size among them).  A graph reads the addresses it was captured with:

- static ``token`` and ``pos`` buffers, which each call's batch is
  copied into;
- the static cache.  The cache is donated: on the first call of a key the
  caller's cache tensors *become* the static buffers, with no copy.  The
  cache a call returns is a new dict of the static buffers; passed back,
  every leaf is its static buffer and nothing is copied.  A leaf that is
  another tensor (a new prefill's cache, say) is copied into its static
  buffer first, by a device copy with no host read.  As with a donated
  argument, a cache passed in is not read afterwards: a step advances the
  static buffers, and every cache returned by a key's calls is their
  newest state;
- a static logits buffer.  Each call returns a fresh copy of it, so a
  caller that keeps every step's logits never sees them overwritten.

The recorded body runs the family's decode step over the static buffers,
copies each returned cache leaf into its static buffer unless it is that
buffer (``len`` in every family; the recurrent states of the hybrid and
SSM families — K/V are written in place, the encoder's K/V returned as
they are), and writes the logits into the static output.  A returned
leaf that shares memory with a static buffer without being it, or that
changes its shape or dtype (a float32 model's first step from
``init_cache``'s bf16 conv caches: step that one eagerly), raises.  Every
call runs under ``torch.no_grad()``.

A capture first runs the step once on the capture stream over a clone of
the cache, its results discarded, so that kernels are loaded, cuBLAS has
its workspace and the allocator has settled before recording: the
caller's state does not advance.  A step's graphs on one card share one
memory pool and one capture stream (``capture.py``).  Kernel launches a
capture records are counted at each replay
(``kernels/build.py::count_replay``).  A capture that fails raises: the
card never falls back to the eager step.

The rule (:func:`graph_device`): a step is captured where every tensor of
it is a plain tensor on one card (``capture.py::uses_graphs``).  The CPU,
the DTensors of the sharded step (``launch/steps.py::sharded``) and fake
tensors (``launch/dryrun.py``, ``launch/op_analysis.py``) run the eager
``decode_step`` unchanged.
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.capture import record_graph, side_stream, uses_graphs
from repro_torch.kernels.build import count_replay

#: the tensor types a captured step takes: a subclass (DTensor,
#: FakeTensor) steps eagerly
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def graph_device(params, cache: dict, batch: dict):
    """The card a step over these arguments is captured on, or None where
    it runs eagerly: every cache and batch tensor and the weights (their
    token embedding stands for them) plain tensors on one device, which
    :func:`uses_graphs` takes."""
    ts = [params.embed["tok"], *cache.values(), *batch.values()]
    dev = ts[0].device
    if all(type(t) in _PLAIN and t.device == dev for t in ts) \
            and uses_graphs(dev):
        return dev
    return None


def _leaves(tree: dict) -> tuple:
    return tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(tree.items()))


def _shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storages of ``a`` and ``b`` overlap in memory."""
    sa, sb = a.untyped_storage(), b.untyped_storage()
    a0, b0 = sa.data_ptr(), sb.data_ptr()
    return a0 < b0 + sb.nbytes() and b0 < a0 + sa.nbytes()


class DecodeGraph:
    """One captured decode step (module docstring): the graph, its static
    batch, cache and logits, the kernel launches its capture recorded
    (wrapper -> count), its replays and its capture's wall time."""

    def __init__(self, batch: dict, cache: dict):
        self.batch = batch
        self.cache = cache
        self.logits = None
        self.graph = None
        self.launches: dict = {}
        self.replays = 0
        self.capture_ms = 0.0


class GraphDecodeStep:
    """``model.decode_step`` replayed from captured graphs on a card, eager
    elsewhere (module docstring); made by :func:`graph_decode_step`."""

    def __init__(self, model):
        self.model = model
        #: captured steps by key
        self.graphs: dict[tuple, DecodeGraph] = {}
        #: card -> (capture stream, the memory pool its graphs share)
        self.streams: dict = {}

    def __call__(self, params, cache: dict, batch: dict):
        dev = graph_device(params, cache, batch)
        if dev is None:
            return self.model.decode_step(params, cache, batch)
        key = (params, dev, _leaves(cache), _leaves(batch))
        with torch.no_grad():
            g = self.graphs.get(key)
            if g is None:
                g = self.capture(params, cache, batch, key, dev)
            self._stage(g, cache, batch)
            self._replay(g.graph)
            count_replay(g.launches)
            g.replays += 1
            return g.logits.clone(), dict(g.cache)

    def capture(self, params, cache: dict, batch: dict, key: tuple,
                dev: torch.device) -> DecodeGraph:
        """Capture the step of ``key`` over ``cache`` (donated: its tensors
        become the static buffers); returns its :class:`DecodeGraph`, now
        in :attr:`graphs`.  Raises where the capture fails."""
        t0 = time.perf_counter()
        with self._capture_stream(dev):
            g = DecodeGraph({k: t.clone() for k, t in batch.items()},
                            dict(cache))
            logits, _ = self.model.decode_step(
                params, {k: t.clone() for k, t in cache.items()}, g.batch)
            g.logits = torch.empty_like(logits)
            del logits
        g.graph, g.launches = self._record(dev, lambda: self._body(params, g))
        g.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.graphs[key] = g
        return g

    def _body(self, params, g: DecodeGraph) -> None:
        """What a graph records: the step over the static buffers, each new
        cache leaf copied into its static buffer, the logits into the
        static output."""
        logits, new = self.model.decode_step(params, g.cache, g.batch)
        if set(new) != set(g.cache):
            raise RuntimeError(f"decode_step returned the cache leaves "
                               f"{sorted(new)}, not {sorted(g.cache)}")
        for k, t in new.items():
            s = g.cache[k]
            if t is s:
                continue
            if any(_shares_memory(t, b) for b in g.cache.values()):
                raise RuntimeError(
                    f"decode_step returned cache leaf {k!r} as a view of a "
                    f"static buffer: a captured step needs each leaf "
                    f"written in place or returned as a new tensor")
            if t.shape != s.shape or t.dtype != s.dtype:
                raise RuntimeError(
                    f"decode_step returned cache leaf {k!r} as {t.dtype} "
                    f"{tuple(t.shape)}, its static buffer is {s.dtype} "
                    f"{tuple(s.shape)}: step a cache whose leaves change "
                    f"dtype eagerly first")
            s.copy_(t)
        g.logits.copy_(logits)

    @staticmethod
    def _stage(g: DecodeGraph, cache: dict, batch: dict) -> None:
        """Bring this call's arguments to the addresses ``g`` reads: the
        batch copied into the static batch, each cache leaf that is not
        its static buffer copied into it (device copies, no host read)."""
        for k, t in batch.items():
            g.batch[k].copy_(t)
        for k, t in cache.items():
            if t is not g.cache[k]:
                g.cache[k].copy_(t)

    @contextlib.contextmanager
    def _capture_stream(self, dev: torch.device):
        """Run the block on ``dev``'s capture stream (on the CPU, in
        place)."""
        if dev.type != "cuda":
            yield
            return
        if dev not in self.streams:
            self.streams[dev] = (torch.cuda.Stream(dev),
                                 torch.cuda.graph_pool_handle())
        with side_stream(self.streams[dev][0], dev):
            yield

    def _record(self, dev: torch.device, body):
        """Capture ``body()`` on ``dev``'s capture stream into its pool;
        nothing runs.  Returns (the graph, the launches it recorded)."""
        stream, pool = self.streams[dev]
        return record_graph(body, stream, pool)

    @staticmethod
    def _replay(graph) -> None:
        """Launch a captured graph on the current stream."""
        graph.replay()


def graph_decode_step(model) -> GraphDecodeStep:
    """``model.decode_step`` (a :class:`~repro_torch.models.Model`'s) as
    captured graphs: ``step(params, cache, batch) -> (logits, cache)``
    (module docstring)."""
    return GraphDecodeStep(model)
