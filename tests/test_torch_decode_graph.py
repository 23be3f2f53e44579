"""``repro_torch.models.graph_decode_step`` on the CPU, against the JAX
package's ``jax.jit(decode_step)`` and the port's eager ``decode_step``.

A CUDA graph cannot be captured without a card.  Here the step takes its
graph path on the CPU (``uses_graphs`` answers yes) with capture and
replay swapped, in the test only, for an eager call of the recorded body
on the static buffers: ``_record`` returns the body, ``_replay`` calls it
(:func:`_plumbing`).  Every other part of the path runs as it does on the
card: the key, the warm-up over a clone of the cache, the donated cache,
the static batch and logits, the copy-in of a cache that is not the
static one, the copy of each new leaf into its static buffer and the
alias checks.

- Every reduced config of the zoo, from the reference's float32 weights
  (``tests/test_torch_models.py``'s ``_setup``, ``_float32``, ``_batch``):
  8 greedy graph steps from one prefill against ``jax.jit(jm.decode_step)``
  (one JAX reference per arch, cached), logits and every cache leaf
  within 1e-4 abs/rel (both compute in float32 and differ in summation
  order; a bf16 leaf also within one bf16 step), tokens and ``len``
  exactly; and bitwise against the port's eager ``decode_step`` over a
  second copy of the prefill's cache.
- Plumbing: a second prefill's cache of the same key is copied into the
  static buffers; new weights or a new batch size open a new key; the
  returned logits are fresh on every call; a leaf returned as a view of a
  static buffer, or in another dtype, raises.
- The rule: eager on the CPU, for DTensors and fake tensors, and for
  tensors on two devices.

The card's own checks (capture, replay, bitwise against the eager step,
no host read in a replay, a failed capture raising) are in
``tests/test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch.models import graph_decode_step, graphs
from test_torch_models import (B, CACHE, S, STEPS, _batch, _caches_close,
                               _close, _float32, _setup)

torch.set_num_threads(1)


@contextlib.contextmanager
def _plumbing():
    """The graph path on the CPU, capture and replay done eagerly on the
    static buffers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "uses_graphs", lambda dev, mesh=None: True)
        mp.setattr(graphs.GraphDecodeStep, "_record",
                   lambda self, dev, body: (body, {}))
        mp.setattr(graphs.GraphDecodeStep, "_replay",
                   staticmethod(lambda graph: graph()))
        yield


_weights = functools.cache(_float32)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _batch_of(tok, i):
    return {"token": tok, "pos": torch.full((B,), S + i, dtype=torch.int32)}


@functools.cache
def _reference(arch):
    """The JAX model's prefill, then STEPS greedy ``jax.jit`` decode steps:
    each step's (fed tokens, logits, cache) as numpy."""
    jc, _, jm, _, _ = _setup(arch)
    jp = _weights(arch)[0]
    jb, _ = _batch(jc, seed=1)
    jcache, jlog = jm.prefill(jp, jb, CACHE)
    step = jax.jit(jm.decode_step)
    tok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)
    out = []
    for i in range(STEPS):
        jlog, jcache = step(jp, jcache, {"token": tok, "pos": jnp.full(
            (B,), S + i, jnp.int32)})
        out.append((np.asarray(tok), np.asarray(jlog),
                    jax.tree.map(np.asarray, jcache)))
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    return out


@functools.cache
def _graph_run(arch):
    """The port's prefill (its cache kept), then STEPS greedy steps of
    ``graph_decode_step`` on the CPU plumbing: (the prefill's cache, each
    step's (fed tokens, logits, cache), the step)."""
    jc, _, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    _, tb = _batch(jc, seed=1)
    cache, logits = tm.prefill(tp, tb, CACHE)
    first = _clone(cache)
    step = graph_decode_step(tm)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    out = []
    with _plumbing():
        for i in range(STEPS):
            logits, cache = step(tp, cache, _batch_of(tok, i))
            out.append((tok, logits, _clone(cache)))
            tok = logits.argmax(-1).to(torch.int32)
    return first, out, step


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_step_matches_reference(arch):
    _, out, step = _graph_run(arch)
    assert len(step.graphs) == 1
    assert next(iter(step.graphs.values())).replays == STEPS
    for i, ((ttok, tlog, tcache), (jtok, jlog, jcache)) in enumerate(
            zip(out, _reference(arch))):
        assert np.array_equal(ttok.numpy(), jtok), f"step {i}"
        _close(tlog, jlog, f"step {i}")
        _caches_close(tcache, jcache, f"step {i}")
        assert np.array_equal(tcache["len"].numpy(), jcache["len"])
    assert np.array_equal(out[-1][2]["len"].numpy(),
                          np.full((B,), S + STEPS))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_step_is_the_eager_step(arch):
    """Bitwise: logits and every cache leaf at every step, the eager step
    over a second copy of the prefill's cache fed the same tokens."""
    _, _, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    first, out, _ = _graph_run(arch)
    cache = _clone(first)
    for i, (tok, glog, gcache) in enumerate(out):
        logits, cache = tm.decode_step(tp, cache, _batch_of(tok, i))
        assert torch.equal(logits, glog), f"step {i}"
        assert set(cache) == set(gcache)
        for k in cache:
            assert cache[k].dtype == gcache[k].dtype, (i, k)
            assert torch.equal(cache[k], gcache[k]), (i, k)


def _prefill(arch, seed, batch_size=B):
    jc, _, _, tm, _ = _setup(arch)
    _, tb = _batch(jc, seed=seed)
    tb = {k: v[:batch_size] for k, v in tb.items()}
    cache, logits = tm.prefill(_weights(arch)[1], tb, CACHE)
    return cache, logits[:, -1].argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny",
                                  "recurrentgemma-9b", "mamba2-780m"])
def test_second_prefill_is_copied_into_the_static_buffers(arch):
    """After two steps on one prefill's cache, a second prefill's cache of
    the same key replays the same graph: it is copied into the static
    buffers (which stay the first cache's tensors), is not itself
    written, and the step's results are the eager step's on it."""
    _, _, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    step = graph_decode_step(tm)
    cache, tok = _prefill(arch, seed=1)
    static = dict(cache)
    with _plumbing():
        for i in range(2):
            logits, cache = step(tp, cache, _batch_of(tok, i))
            tok = logits.argmax(-1).to(torch.int32)
        assert all(cache[k] is static[k] for k in static)
        other, tok2 = _prefill(arch, seed=5)
        before = _clone(other)
        got, out = step(tp, other, _batch_of(tok2, 0))
    want, want_cache = tm.decode_step(tp, _clone(before), _batch_of(tok2, 0))
    (g,) = step.graphs.values()
    assert g.replays == 3
    assert all(out[k] is static[k] for k in static)
    assert all(torch.equal(other[k], before[k]) for k in other)
    assert torch.equal(got, want)
    assert all(torch.equal(out[k], want_cache[k]) for k in want_cache)


def test_new_weights_or_batch_size_open_a_new_key():
    """A key a weights module, a batch size: each new one is captured, a
    known one replayed; the cache a call returns, passed back, is the
    static buffers themselves."""
    arch = "olmo-1b"
    _, tc, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    other = tm.init(seed=1, dtype=torch.float32, device="cpu")
    step = graph_decode_step(tm)
    with _plumbing():
        cache, tok = _prefill(arch, seed=1)
        _, cache = step(tp, cache, _batch_of(tok, 0))
        _, cache = step(tp, cache, _batch_of(tok, 1))
        assert len(step.graphs) == 1
        (g,) = step.graphs.values()
        assert all(cache[k] is g.cache[k] for k in cache)
        step(other, _prefill(arch, seed=2)[0], _batch_of(tok, 0))
        assert len(step.graphs) == 2
        small, tok1 = _prefill(arch, seed=3, batch_size=1)
        step(tp, small, {"token": tok1, "pos": torch.full(
            (1,), S, dtype=torch.int32)})
        assert len(step.graphs) == 3
        _, cache = step(tp, cache, _batch_of(tok, 2))
    assert len(step.graphs) == 3 and g.replays == 3
    assert {k[0] for k in step.graphs} == {tp, other}
    batch_sizes = [dict((n, s) for n, s, _ in k[3])["token"][0]
                   for k in step.graphs]
    assert sorted(batch_sizes) == [1, B, B]


def test_returned_logits_are_fresh_on_every_call():
    """Each call's logits are a new tensor, apart from the static output:
    a kept step's logits survive the next steps."""
    arch = "olmo-1b"
    _, _, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    step = graph_decode_step(tm)
    cache, tok = _prefill(arch, seed=1)
    kept = []
    with _plumbing():
        for i in range(3):
            logits, cache = step(tp, cache, _batch_of(tok, i))
            kept.append((logits, logits.clone()))
            tok = logits.argmax(-1).to(torch.int32)
    (g,) = step.graphs.values()
    for logits, copy in kept:
        assert not graphs._shares_memory(logits, g.logits)
        assert torch.equal(logits, copy)
    assert not torch.equal(kept[0][1], kept[1][1])


@pytest.mark.parametrize("fault", ["view", "dtype"])
def test_a_leaf_the_graph_cannot_keep_raises(fault):
    """A returned leaf that is a view of a static buffer (here ``len``),
    or that changes dtype (a float32 SSM model's first step from
    ``init_cache``: its bf16 conv cache comes back float32), raises."""
    arch = "olmo-1b" if fault == "view" else "mamba2-780m"
    _, _, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    if fault == "view":
        def aliasing(p, c, b):
            logits, new = tm.decode_step(p, c, b)
            return logits, {**new, "len": c["len"][:]}
        model = dataclasses.replace(tm, decode_step=aliasing)
        cache, tok = _prefill(arch, seed=1)
        match = "view of a static buffer"
    else:
        model = tm
        cache = tm.init_cache(B, CACHE, device="cpu")
        assert cache["conv"].dtype == torch.bfloat16
        tok = torch.zeros((B,), dtype=torch.int32)
        match = "its static buffer is torch.bfloat16"
    step = graph_decode_step(model)
    with _plumbing(), pytest.raises(RuntimeError, match=match):
        step(tp, cache, _batch_of(tok, 0))


@pytest.mark.parametrize("where", ["cpu", "fake", "dtensor", "two_devices"])
def test_the_rule_steps_eagerly(where):
    """Eager on the CPU (the card's rule itself), and, with the rule's card
    check answering yes, for fake tensors, DTensors and tensors on two
    devices: no key is opened and the eager step's results come back."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.abstract import fake_mode, fake_world

    arch = "olmo-1b"
    _, tc, _, tm, _ = _setup(arch)
    tp = _weights(arch)[1]
    step = graph_decode_step(tm)
    cache, tok = _prefill(arch, seed=1)
    batch = _batch_of(tok, 0)
    if where == "cpu":
        assert graphs.graph_device(tp, cache, batch) is None
        got, _ = step(tp, _clone(cache), batch)
        want, _ = tm.decode_step(tp, _clone(cache), batch)
        assert torch.equal(got, want) and not step.graphs
        return
    with _plumbing():
        assert graphs.graph_device(tp, cache, batch) == torch.device("cpu")
        if where == "fake":
            from repro_torch.launch.abstract import (abstract_cache,
                                                     abstract_params)
            mode = fake_mode()
            fp = abstract_params(tc, mode, torch.float32)
            fc = abstract_cache(tc, B, CACHE, mode)
            fb = {k: mode.from_tensor(v) for k, v in batch.items()}
            with mode:
                assert graphs.graph_device(fp, fc, fb) is None
                logits, _ = step(fp, fc, fb)
            assert logits.shape == (B, tc.vocab_padded)
        elif where == "dtensor":
            with fake_world(2):
                mesh = init_device_mesh("cpu", (2,))
                dcache = {**cache, "len": distribute_tensor(
                    cache["len"], mesh, [Replicate()])}
                assert graphs.graph_device(tp, dcache, batch) is None
        else:
            meta = {k: v.to("meta") for k, v in batch.items()}
            assert graphs.graph_device(tp, cache, meta) is None
    assert not step.graphs
