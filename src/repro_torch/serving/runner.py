"""ModelRunner: the fused-step executor of the serving stack (PyTorch).

The port of ``repro.serving.runner``.  The runner owns the model, the
sampling generator and the ONE-device→host-transfer-per-step invariant.
It treats the device state bundle
(:class:`repro_torch.serving.kv_manager.DeviceStepState`) as opaque: it
forwards the pool into the fused step and hands the updated state
straight back to the manager, never reading an anchor or a version.

Under tensor parallelism (``mesh=``) the model is the sequence of shard
models and the step runs on every shard; its results still land on the
mesh's lead device, so the one read stays one read.

``launch`` enqueues a step's work on the device and returns its six [B]
results, packed into one int32 tensor, still on the device; ``collect``
reads them back in one transfer — the one read of a steady step: on a
card a copy into pinned memory and a wait for the current stream.

**Captured steps.**  The reference's runner owns one compiled executable
per static key; on a card this one owns one captured
``torch.cuda.CUDAGraph`` per key and replays it each step.  The key is the
reference's (chunk size, speculation) plus the validation verdict — a
graph each, as ``lax.cond`` picks a branch, so a skipped validation is
never computed — and the prompt buffer's width, the one shape of the state
the host can change: a longer prompt makes the manager widen its buffer,
a new tensor, so a new key, and the graphs of the narrower buffer are
dropped.  A graph reads the addresses it was captured with:

- the KV arena and the manager's per-slot tensors, which the step and
  ``install_slot``/``clear_slot`` write in place;
- one static pool the runner owns.  The host replaces the manager's pool
  between steps (every allocator call returns a new one), so before a
  replay the pool it last installed is written into the static pool
  (``pagepool.assign_pool``: device copies, no host read) unless it is the
  static pool itself; after the replay the static pool is installed back;
- the chunk budget and the temperature as resident 0-dim tensors, and the
  drafts, copied into the graph's static buffers before the replay.

The graph's packed output is its static output: :meth:`collect` reads it,
so a step is collected before its key is replayed again.  A capture first
runs a dry step (no row active: nothing is granted, appended or copied,
over a clone of the pool) on the stream it captures on, so that the
kernels are built and cuBLAS has its workspace there before capture
begins — on a fleet replica's stream, or where the default stream is
current on the runner's own; the graphs' split-merge tickets are the
runner's own buffer,
reserved outside the graphs' memory pool
(``kernels/paged_attention.py::reserve_tickets``); the generator is
registered with every graph that samples.  All graphs of one runner share
one memory pool and one ticket buffer: they never run at once.  A graph
replays on the current stream — a fleet replica's own stream
(``serving/parallel.py``) — and a capture waits for nothing but its own
stream (``capture.py``); graphs dropped for a wider prompt buffer are
dropped once the streams they replayed on have run them.  A capture that
fails raises — the card never falls back to the eager step.  Kernel
launches recorded by a capture are counted at each replay
(``kernels/build.py::count_replay``), the dry step's as it runs.

**Held captures.**  While a fleet replica stalled on the card may still
have work on its stream, the fleet holds captures
(:attr:`ModelRunner.hold_captures`): a graph's instantiation can wait
until that stream wakes (a revived replica's ``capture_end`` did,
``tools/stall_probe.py``), so a step whose key has no graph runs the
eager step — the same kernels, bitwise the graph's — and is counted;
keys already captured still replay.

The rule: graphs serve wherever every tensor of the step lies on one card
— without a mesh, or with every shard of the mesh on one card (one
single-device graph).  A mesh over several cards, and the CPU, run the
eager step.  ``ModelRunner.graphs`` is the rule's verdict
(``capture.py::uses_graphs``, which also decides for the model path's
decode graphs); the tests set it to compare the two paths.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.capture import record_graph, side_stream, uses_graphs
from repro_torch.core import pagepool as pp
from repro_torch.kernels.build import count_replay
from repro_torch.kernels.paged_attention import (capture_tickets,
                                                 reserve_tickets, ticket_count)
from .kv_manager import DeviceStepState, KVCacheManager
from .paged_decode import fused_decode_step, launch_heads


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a host sync: on CUDA the copy
    leaves from pinned memory and is queued on the current stream (an
    upload from pageable memory would wait for it to land)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StepResult(NamedTuple):
    """One step's host-side results — the contents of the single read:
    per-slot next tokens, OA validity, grant info (fresh pages granted, −1
    = starved), COW flags, advanced-token counts and accepted-draft counts
    (0 on non-speculative steps), all as numpy arrays."""

    tokens: np.ndarray
    valid: np.ndarray
    grant_info: np.ndarray
    cow: np.ndarray
    adv: np.ndarray
    n_acc: np.ndarray


class StepGraph:
    """One captured step (module docstring): the graph, the state it was
    captured over, its static draft buffers and packed [6, B] output, the
    kernel launches its capture recorded (wrapper -> count), its replays
    and its capture's wall time."""

    def __init__(self, state: DeviceStepState, out, draft_toks, draft_lens):
        self.state = state
        self.out = out
        self.draft_toks = draft_toks
        self.draft_lens = draft_lens
        self.graph = None
        self.launches: dict = {}
        self.replays = 0
        self.capture_ms = 0.0


def _arena(kv) -> list:
    """The arena's tensors (every shard's k and v)."""
    return [s[n] for s in (kv if isinstance(kv, list) else [kv])
            for n in ("k", "v")]


class ModelRunner:
    """Executes fused decode/prefill steps against a KV manager's device
    state (module docstring).  Holds everything the step needs that is NOT
    page lifecycle: the model, the attention tiling knob and sampling."""

    #: dry steps run by captures since the last reset, in every runner of
    #: the process (each launches its kernels as an eager step does): the
    #: counterpart, for launch counts, of the kernel wrappers' counters
    dry_steps = 0

    def __init__(self, cfg, model, *, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 pages_per_compute_block: int = 1, mesh=None, stats=None,
                 tracer):
        self.cfg = cfg
        self.model = model
        self.greedy = greedy
        self.temperature = float(temperature)
        self.pages_per_compute_block = pages_per_compute_block
        self.mesh = mesh
        self.device = dev = mesh.lead if mesh is not None else model.device
        # the sampling stream lives on the (lead) model's device, seeded once
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        #: serve through captured CUDA graphs (:func:`uses_graphs`)
        self.graphs = uses_graphs(dev, mesh)
        #: set while a fleet's driver threads run: a step whose graph was
        #: not captured before they started raises instead of capturing
        self.frozen = False
        #: set by a fleet while a stalled replica's stream may still run
        #: (``serving/parallel.py``): a step whose graph is missing runs
        #: eagerly, counted in ``stats.eager_steps_held``, and nothing is
        #: captured — an instantiation can wait for that stream
        self.hold_captures = False
        self.stats = stats
        #: the engine's tracer, for the ``runner.launch`` and
        #: ``runner.read`` spans (``repro_torch/spans.py``)
        self.tracer = tracer
        #: captured steps by key (chunk size, speculative, validate, width)
        self.step_graphs: dict[tuple, StepGraph] = {}
        self._pool = None  # the graphs' static pool
        # the runner's own capture stream, the stream of the last capture
        self._stream = self._capture_on = self._mempool = None
        #: the graphs' split-merge tickets, and grown-out buffers that
        #: graphs captured before still read
        self._tickets = None
        self._old_tickets: list = []
        #: the streams graphs were replayed on since the last drop
        self._replayed_on: dict = {}
        self._host_out = None  # the pinned buffer of the step's one read
        # resident operands: read by the graphs (and by the eager step on
        # a card), refreshed only when the host's value changes
        self._budget = torch.ones((), dtype=torch.int64, device=dev)
        self._budget_value = 1
        self._temp = torch.full((), self.temperature, dtype=torch.float32,
                                device=dev)

    # -- one step ------------------------------------------------------------

    def _operands(self, budget: int, resident: bool):
        """(temperature, chunk budget) for the step: the resident tensors
        (the budget's refreshed where it changed), or the host values."""
        if not resident:
            return self.temperature, budget
        if budget != self._budget_value:
            self._budget.fill_(budget)
            self._budget_value = budget
        return self._temp, self._budget

    def _step(self, st: DeviceStepState, generator, temperature, budget,
              draft_toks, draft_lens, key, out=None):
        """The fused step over ``st`` (updated in place), its six results
        packed into ``out`` (a new tensor when None)."""
        chunk_size, speculative, do_validate = key[:3]
        (_, _, _, _, _, _, nxt, valid, grant_info, cow, adv,
         n_acc) = fused_decode_step(
            self.model, st.kv, st.pool, st.block_tables, st.snapshot,
            st.lengths, st.last_tok, st.active, st.prompt_buf, st.prompt_len,
            generator, temperature, budget, draft_toks, draft_lens,
            do_validate, cfg=self.cfg, greedy=self.greedy,
            pages_per_compute_block=self.pages_per_compute_block,
            chunk_size=chunk_size, speculative=speculative, mesh=self.mesh)
        return torch.stack([nxt, valid.to(torch.int32), grant_info,
                            cow.to(torch.int32), adv, n_acc], out=out)

    @staticmethod
    def _drafts(kvm: KVCacheManager, chunk_size: int, drafts: dict):
        """The draft plan as dense host arrays [B, chunk_size−1] and [B]."""
        B = kvm.max_batch
        dt = np.zeros((B, max(chunk_size - 1, 1)), np.int32)
        dl = np.zeros((B,), np.int32)
        for slot, toks in drafts.items():
            dl[slot] = len(toks)
            dt[slot, :len(toks)] = toks
        return dt, dl

    def launch(self, kvm: KVCacheManager, *, chunk_size: int = 1,
               budget: int = 1, drafts: dict | None = None,
               do_validate: bool = True):
        """Enqueue ONE fused step (a graph replay where :attr:`graphs`) and
        install the updated device state back into the manager.  Returns
        the pending packed outputs for :meth:`collect`; nothing is read
        back here.  Its ``runner.launch`` span counts the positions the
        step computes: every row of the batch times the chunk.

        ``drafts`` (slot → draft token list) selects the speculative step:
        the plan rides a host→device upload (never a download)."""
        with self.tracer.span("runner.launch") as span:
            span.set(positions=kvm.max_batch * chunk_size)
            return self._launch(kvm, chunk_size, budget, drafts, do_validate)

    def _launch(self, kvm, chunk_size, budget, drafts, do_validate):
        st = kvm.step_state()
        key = (chunk_size, drafts is not None, bool(do_validate),
               st.prompt_buf.shape[1])
        held = (self.graphs and self.hold_captures
                and key not in self.step_graphs)
        if held:
            self.stats.record_eager_step_held()
        if not self.graphs or held:
            draft_toks = draft_lens = None
            if drafts is not None:
                draft_toks, draft_lens = (
                    _upload(a, kvm.device)
                    for a in self._drafts(kvm, chunk_size, drafts))
            temperature, budget = self._operands(
                budget, resident=self.device.type == "cuda")
            out = self._step(st, self.generator, temperature, budget,
                             draft_toks, draft_lens, key)
            kvm.install_state(st)  # written in place
            return out
        g = self.step_graphs.get(key)
        if g is None:
            g = self.capture(kvm, key)
        self._stage(g, st, budget)
        if drafts is not None:
            for dst, src in zip((g.draft_toks, g.draft_lens),
                                self._drafts(kvm, chunk_size, drafts)):
                dst.copy_(_upload(src, kvm.device))
        self._replay(g.graph)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._replayed_on.setdefault(stream.cuda_stream, stream)
        count_replay(g.launches)
        g.replays += 1
        kvm.install_state(st._replace(pool=self._pool))
        return g.out

    def collect(self, pending) -> StepResult:
        """THE one host transfer of a steady step: the six packed [B]
        results in a single read — on the CPU a ``.cpu()``; on a card a
        copy into the runner's pinned buffer and a wait for the current
        stream.  A ``.cpu()`` to pageable memory would wait inside the
        CUDA driver, where it holds up the CUDA calls of every other thread
        (the other replicas of a fleet on one card) until this stream's
        work ends; a stream's wait holds up nothing but its caller.  Its
        ``runner.read`` span is the host's wait on the device."""
        with self.tracer.span("runner.read"):
            host = self._read(pending)
        return StepResult(host[0], host[1].astype(bool), host[2],
                          host[3].astype(bool), host[4], host[5])

    def _read(self, pending) -> np.ndarray:
        if pending.device.type != "cuda":
            return pending.cpu().numpy()
        if self._host_out is None or self._host_out.shape != pending.shape:
            self._host_out = torch.empty(pending.shape, dtype=pending.dtype,
                                         pin_memory=True)
        self._host_out.copy_(pending, non_blocking=True)
        torch.cuda.current_stream(pending.device).synchronize()
        return self._host_out.numpy().copy()

    # -- graphs --------------------------------------------------------------

    def _stage(self, g: StepGraph, st: DeviceStepState, budget: int) -> None:
        """Bring the state the host last wrote to the addresses ``g`` reads:
        the pool copied into the static pool where it is another; the
        arena and the per-slot tensors must be the captured ones (the
        manager writes them in place), else the graph would read stale
        memory, and that raises."""
        cap = g.state
        same = all(a is b for a, b in zip(_arena(st.kv), _arena(cap.kv)))
        same &= all(getattr(st, f) is getattr(cap, f)
                    for f in DeviceStepState._fields[2:])
        if not same:
            raise RuntimeError(
                "a step graph's state tensors were replaced behind it: the "
                "KV manager must write the arena and per-slot arrays in place")
        if any(a is not b for a, b in zip(st.pool, self._pool)):
            pp.assign_pool(self._pool, st.pool)
        self._operands(budget, resident=True)

    @contextlib.contextmanager
    def _capture_stream(self):
        """Run the block on the stream this runner captures on: the
        current stream where it is not the card's default one (a fleet
        replica's own), else the runner's own stream, after the current
        stream's work and before what it enqueues next (on the CPU, in
        place)."""
        if self.device.type != "cuda":
            yield
            return
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        if cur != torch.cuda.default_stream(self.device):
            self._capture_on = cur
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._capture_on = self._stream
        with side_stream(self._stream, self.device):
            yield

    def _reserve_tickets(self, B: int, chunk_size: int) -> None:
        """The graphs' split-merge tickets at the size of this key's
        launches (the widest shard's), outside the graphs' pool."""
        if self.device.type != "cuda":
            return
        n = max(ticket_count(B, chunk_size, hq, hkv) for hq, hkv in
                launch_heads(self.cfg, self.mesh.tp if self.mesh else 1))
        buf = reserve_tickets(self.device, n, self._tickets)
        if self._tickets is not None and buf is not self._tickets:
            self._old_tickets.append(self._tickets)
        self._tickets = buf

    def capture(self, kvm: KVCacheManager, key: tuple) -> StepGraph:
        """Capture the step of ``key`` (chunk size, speculative, validate,
        prompt width) over the manager's current state; returns its
        :class:`StepGraph`, now in :attr:`step_graphs`.  Raises where the
        capture fails, and while :attr:`frozen`."""
        if self.frozen:
            raise RuntimeError(
                f"step graph {key} was not captured before the fleet's "
                f"driver threads started")
        st = kvm.step_state()
        chunk_size, speculative, _, width = key
        if width != st.prompt_buf.shape[1]:
            raise ValueError(f"key {key}: the prompt buffer is {width} wide")
        # graphs over a narrower prompt buffer read a buffer since replaced
        stale = [k for k in self.step_graphs if k[3] != width]
        if stale:  # their last replays ended: on their streams alone
            for stream in self._replayed_on.values():
                stream.synchronize()
            self._replayed_on.clear()
        for k in stale:
            del self.step_graphs[k]
        if stale and not self.step_graphs and self._mempool is not None:
            # a pool whose graphs are all gone takes no capture until the
            # allocator frees it, which a synchronised card would: a new one
            self._mempool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        dev = kvm.device
        B = kvm.max_batch
        with self._capture_stream():
            if self._pool is None:
                self._pool = pp.PagePool(*(t.clone() for t in st.pool))
            drafts = ((torch.zeros((B, max(chunk_size - 1, 1)),
                                   dtype=torch.int32, device=dev),
                       torch.zeros((B,), dtype=torch.int32, device=dev))
                      if speculative else (None, None))
            g = StepGraph(st._replace(pool=self._pool),
                          torch.empty((6, B), dtype=torch.int32, device=dev),
                          *drafts)
            self._reserve_tickets(B, chunk_size)
            dry = DeviceStepState(
                st.kv, pp.PagePool(*(t.clone() for t in st.pool)),
                torch.full_like(st.block_tables, -1),
                torch.zeros_like(st.snapshot), torch.zeros_like(st.lengths),
                torch.zeros_like(st.last_tok), torch.zeros_like(st.active),
                torch.zeros_like(st.prompt_buf),
                torch.zeros_like(st.prompt_len))
            self._step(dry, torch.Generator(device=dev), self._temp,
                       self._budget, *drafts, key)
            del dry
        ModelRunner.dry_steps += 1
        g.graph, g.launches = self._record(lambda: self._step(
            g.state, self.generator, self._temp, self._budget,
            g.draft_toks, g.draft_lens, key, out=g.out))
        g.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.step_graphs[key] = g
        return g

    def _record(self, body):
        """Capture ``body()`` as a CUDA graph on the stream of the capture
        (:meth:`_capture_stream`), into the runner's memory pool; nothing
        runs.  Returns (the graph, the
        kernel launches it recorded)."""
        with capture_tickets(self._tickets):
            return record_graph(body, self._capture_on, self._mempool,
                                None if self.greedy else self.generator)

    @staticmethod
    def _replay(graph) -> None:
        """Launch a captured graph on the current stream (a fleet
        replica's own)."""
        graph.replay()
