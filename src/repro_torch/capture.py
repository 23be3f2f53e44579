"""CUDA graph capture, shared by the serving runner's step graphs
(``serving/runner.py``) and the model path's decode graphs
(``models/graphs.py``).

The rule (:func:`uses_graphs`): a step is captured where every tensor of
it lies on one card; the CPU and a mesh over several cards step eagerly.
An owner of graphs captures all of them on one side stream of its card
(:func:`side_stream`), into one memory pool its graphs share: they never
run at once.  :func:`record_graph` records a body without running it;
the kernel launches the body makes are tallied, not counted, and each
replay adds the tally (``kernels/build.py::count_replay``).  A capture
that fails raises: nothing falls back to the eager step.

A capture waits for nothing but its own stream (no card-wide
synchronise), so a fleet replica on a card can capture (revived, or over
a wider prompt buffer) while another replica's stream is still busy,
even stalled.  Every capture runs in ``thread_local`` mode, so the calls
of other threads (another replica's driver, or an abandoned one waking
from a stall) cannot invalidate it.  A capture that fails leaves the
caller's current stream as it was (``torch.cuda.graph`` leaves its
capture stream current when the capture fails).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.build import recording_launches


def uses_graphs(device: torch.device, mesh=None) -> bool:
    """The module docstring's rule: a step is captured where every tensor
    of it lies on one card — ``device`` a CUDA device, and ``mesh`` (if
    any) of shards all on one card."""
    return torch.device(device).type == "cuda" and (
        mesh is None or len(set(mesh.devices)) == 1)


@contextlib.contextmanager
def side_stream(stream, device):
    """Run the block on ``stream``, after the work ``device``'s current
    stream holds so far and before what it enqueues next."""
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def record_graph(body, stream, pool, generator=None):
    """Capture ``body()`` as a CUDA graph on ``stream``, into the memory
    pool ``pool``; nothing runs.  ``generator`` (a sampling generator) is
    registered with the graph, so each replay draws on from its state.
    Returns (the graph, the kernel launches it recorded: wrapper ->
    count)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with recording_launches() as tally, torch.cuda.stream(stream):
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    return graph, tally
