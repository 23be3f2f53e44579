"""Paged attention: the hand-written CUDA kernel and its plain version.

Port of the TPU kernel ``repro.kernels.paged_attention.paged_attention_pallas``
(source: ``kernels/csrc/paged_attention.cu``; its header note says what
bounds it and what the design does about it: split-KV over a row's pages
merged in the launch, a ``cp.async`` page ring, bf16 ``mma.sync`` tiles).
Semantics are the Pallas kernel's: C queries per row over the row's pages
with the in-chunk causal mask, −1 pages masked, float32 online softmax,
zeros for rows of length 0.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`paged_attention_plain` is the same
function in plain PyTorch (the chunked oracle of ``kernels/ref.py``), which
the dispatcher in ``kernels/ops.py`` uses for CPU tensors and
``chip_smoke.py`` holds the kernel against on the card.

:func:`paged_attention_append_cuda` is the same launch with the paged KV
append fused in (the kernel's append mode, point 6 of its header note):
it writes the chunk's new K/V into the arena and attends over them, the
serving path's one launch per layer in place of ``kv_append_cuda`` and
this kernel; :func:`paged_attention_append_plain` is ``kv_append_plain``
followed by :func:`paged_attention_plain`.

:func:`paged_attention_sharded` is the port of the TPU kernel
``paged_attention_sharded`` (tensor parallelism): this kernel launched once
per shard on the shard's slab of KV heads, with the fused append when it
is given one; its plain version :func:`paged_attention_sharded_plain` runs
the plain versions per shard.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import count_launch, load, locked_cache
from .kv_append import kv_append_plain
from .ref import paged_attention_chunked_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the kernel's split count S: each (row, KV head) is cut into S contiguous
#: shares of its pages, one block each, merged in the launch.  One constant
#: for every launch (never derived from B, Hkv or the shard count, so each
#: head's output is bitwise the same at every TP degree); chosen on the
#: card by ``chip_smoke.py``'s split sweep (PERF.md §6)
SPLITS = 2
_MAX_SPLITS = 8
_MAX_ROWS = 64  # query slots per block: C * G beyond it is cut into groups


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                          chunk_lens):
    """The kernel's function in plain PyTorch (the kernel ignores
    ``pages_per_compute_block``, so this version has none)."""
    return paged_attention_chunked_ref(q, k_pages, v_pages, block_tables,
                                       lengths, chunk_lens)


def paged_attention_append_plain(q, k_pages, v_pages, k_new, v_new,
                                 block_tables, lengths, chunk_lens, write_ok):
    """The fused launch's function in plain PyTorch: ``kv_append_plain``
    of each row's first ``chunk_lens`` new tokens at positions ``lengths -
    chunk_lens`` onward (the arena, in place), then
    :func:`paged_attention_plain`."""
    kv_append_plain(k_pages, v_pages, k_new, v_new, block_tables,
                    lengths - chunk_lens, chunk_lens, write_ok)
    return paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                                 chunk_lens)


@locked_cache
def _launcher():
    """The kernel's C entry point, typed once per process."""
    fn = load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return fn


_tickets: dict = {}
_tickets_lock = threading.Lock()


def _ticket_buffer(device, stream: int, n: int):
    """The zeroed int32 ticket counters of the split merge, one buffer per
    (device, stream): the last block of each (row, head) resets its ticket,
    so the buffer is zero again whenever a launch has ended.  Launches on
    one stream run in order, so every thread that launches on it (a
    fleet's driver threads on one card's default stream) may share the
    buffer; the get-or-grow holds a lock, so two threads that grow it at
    once keep one buffer."""
    with _tickets_lock:
        buf = _tickets.get((device, stream))
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _tickets[(device, stream)] = buf
        return buf


def _check(cond: bool, msg: str, name: str = "paged_attention_cuda") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths,
                         chunk_lens, pages_per_compute_block: int = 1, *,
                         _splits: int | None = None, _append=None):
    """q [B, C, Hq, D] and k/v pages [P, page, Hkv, D] (one layer's arena),
    each float32 or bfloat16, D one of :data:`HEAD_DIMS`; block_tables
    [B, M], lengths [B] and chunk_lens [B] int32, all contiguous CUDA
    tensors on one device.  Returns [B, C, Hq, D] in q's dtype.  Launches on
    the inputs' device's current stream and never reads a device value on
    the host.  ``pages_per_compute_block`` is accepted for the reference's
    signature and ignored: the kernel's stage size does not depend on it.
    ``_splits`` overrides :data:`SPLITS` for the split sweep and its
    tests only; the serving path never passes it.  ``_append`` is the
    fused append's (k_new, v_new, write_ok), checked by
    :func:`paged_attention_append_cuda`, its only caller."""
    tensors = (q, k_pages, v_pages, block_tables, lengths, chunk_lens)
    _check(all(t.is_cuda for t in tensors), "every input must be a CUDA tensor")
    _check(len({t.device for t in tensors}) == 1, "inputs on different devices")
    _check(q.dtype in _DTYPES and k_pages.dtype in _DTYPES,
           "q and the pages must be float32 or bfloat16")
    _check(v_pages.dtype == k_pages.dtype, "k and v pages must share a dtype")
    _check(all(t.dtype == torch.int32 for t in tensors[3:]),
           "block_tables, lengths and chunk_lens must be int32")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors[:3]),
           "q and the pages must be 16-byte aligned")
    _check(q.dim() == 4 and k_pages.dim() == 4, "q and pages must be 4-D")
    B, C, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    _check(tuple(v_pages.shape) == tuple(k_pages.shape), "k/v shapes differ")
    _check(Dk == D and Hkv > 0 and Hq % Hkv == 0, "head shapes do not match")
    _check(D in HEAD_DIMS, f"head dim {D} is not one of {HEAD_DIMS}")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B,
           "block_tables must be [B, M]")
    _check(tuple(lengths.shape) == (B,) and tuple(chunk_lens.shape) == (B,),
           "lengths and chunk_lens must be [B]")
    S = SPLITS if _splits is None else int(_splits)
    _check(1 <= S <= _MAX_SPLITS, f"splits must be in 1..{_MAX_SPLITS}")
    out = torch.empty_like(q)
    nq = C * (Hq // Hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = tickets = None
    if S > 1:
        # per split: float32 acc [nq, D], then m and l [nq] of every split
        part = torch.empty(B * Hkv * S * nq * (D + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _ticket_buffer(q.device, stream,
                                 B * Hkv * -(-nq // _MAX_ROWS))
    # the launch sizes itself for, and runs on, the CURRENT device: make
    # that the inputs' device (a shard on cuda:1 while cuda:0 is current)
    append = [None] * 3 if _append is None else [t.data_ptr()
                                                  for t in _append]
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), chunk_lens.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), *append, B, C,
            Hq, Hkv, D, page, block_tables.shape[1], P, S, _DTYPES[q.dtype],
            _DTYPES[k_pages.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(paged_attention_cuda)
    return out


#: launches of the CUDA kernel since the last reset (a plain integer),
#: with or without the fused append
paged_attention_cuda.launches = 0


def paged_attention_append_cuda(q, k_pages, v_pages, k_new, v_new,
                                block_tables, lengths, chunk_lens, write_ok,
                                pages_per_compute_block: int = 1, *,
                                _splits: int | None = None):
    """One launch that appends and attends: writes k_new/v_new [B, C, Hkv,
    D] (contiguous, the arena's dtype) into k/v pages in place — token j of
    row b at position ``lengths[b] - chunk_lens[b] + j`` for ``j <
    chunk_lens[b]``, unless ``write_ok[b]`` ([B] bool) is False, the page
    is −1 or past the arena, or the page slot is past the table's width —
    and returns the attention output over the updated arena, bitwise that
    of ``kv_append_cuda`` followed by :func:`paged_attention_cuda` when no
    row reads a slot another row writes (the kernel's header note).  Rows
    need ``chunk_lens <= lengths``.  Every other input as
    :func:`paged_attention_cuda` takes it; q and the arena share a dtype,
    or q is float32 over a bf16 arena.  Counts one launch here and one in
    :func:`paged_attention_cuda`, which it launches through."""
    def check(cond, msg):
        _check(cond, msg, "paged_attention_append_cuda")
    new = (k_new, v_new, write_ok)
    check(all(t.is_cuda for t in new), "every input must be a CUDA tensor")
    check(len({t.device for t in (q, k_pages, *new)}) == 1,
          "inputs on different devices")
    check(k_new.dtype == v_new.dtype == k_pages.dtype,
          "k_new and v_new must have the arena's dtype")
    check(q.dtype == k_pages.dtype or (q.dtype == torch.float32
                                       and k_pages.dtype == torch.bfloat16),
          "the fused append is built for q and arena of one dtype and for a "
          "float32 q over a bfloat16 arena")
    check(write_ok.dtype == torch.bool, "write_ok must be bool")
    check(all(t.is_contiguous() for t in new), "inputs must be contiguous")
    check(all(t.data_ptr() % 16 == 0 for t in new[:2]),
          "k_new and v_new must be 16-byte aligned")
    check(q.dim() == 4 and k_pages.dim() == 4, "q and pages must be 4-D")
    B, C = q.shape[:2]
    check(tuple(k_new.shape) == (B, C) + tuple(k_pages.shape[2:])
          and tuple(v_new.shape) == tuple(k_new.shape),
          "k_new and v_new must be [B, C, Hkv, D]")
    check(tuple(write_ok.shape) == (B,), "write_ok must be [B]")
    out = paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths,
                               chunk_lens, pages_per_compute_block,
                               _splits=_splits, _append=new)
    count_launch(paged_attention_append_cuda)
    return out


#: launches of the fused append + attention since the last reset
paged_attention_append_cuda.launches = 0


# ---------------------------------------------------------------------------
# tensor parallelism: kernel 1 once per shard, on the shard's head slab


def _replicated(x, mesh):
    """One tensor per shard: a tensor goes to every shard's device (itself
    where it already lies there); a sequence of per-shard tensors is kept."""
    return mesh.replicate(x) if isinstance(x, torch.Tensor) else tuple(x)


def _shard_args(qs, ks, vs, block_tables, lengths, chunk_lens, mesh,
                n_kv_heads, append=None):
    """Per shard: (q, k, v, block_tables, lengths, chunk_lens) and, with
    ``append`` = (k_news, v_news, write_ok), (k_new, v_new, write_ok)."""
    tp = mesh.tp
    if n_kv_heads % tp != 0:
        raise ValueError(f"n_kv_heads={n_kv_heads} not divisible by tp={tp}")
    if not len(qs) == len(ks) == len(vs) == tp:
        raise ValueError(f"paged_attention_sharded: want one q, k and v slab "
                         f"per shard ({tp}), got {len(qs)}, {len(ks)}, "
                         f"{len(vs)}")
    if any(k.shape[2] != n_kv_heads // tp for k in ks):
        raise ValueError(f"paged_attention_sharded: each k/v slab must hold "
                         f"n_kv_heads // tp = {n_kv_heads // tp} heads")
    args = zip(qs, ks, vs, *(_replicated(t, mesh)
                             for t in (block_tables, lengths, chunk_lens)))
    if append is None:
        return [(a, None) for a in args]
    k_news, v_news, write_ok = append
    if not len(k_news) == len(v_news) == tp:
        raise ValueError(f"paged_attention_sharded: want one k_new and v_new "
                         f"slab per shard ({tp}), got {len(k_news)}, "
                         f"{len(v_news)}")
    return list(zip(args, zip(k_news, v_news, _replicated(write_ok, mesh))))


def paged_attention_sharded_plain(qs, ks, vs, block_tables, lengths,
                                  chunk_lens, *, mesh, n_kv_heads: int,
                                  pages_per_compute_block: int = 1,
                                  append=None):
    """:func:`paged_attention_sharded` with the plain versions per shard
    (``pages_per_compute_block`` is ignored, as the kernel ignores it)."""
    outs = []
    for (q, k, v, bt, ln, cl), new in _shard_args(
            qs, ks, vs, block_tables, lengths, chunk_lens, mesh, n_kv_heads,
            append):
        if new is None:
            outs.append(paged_attention_plain(q, k, v, bt, ln, cl))
        else:
            kn, vn, ok = new
            outs.append(paged_attention_append_plain(q, k, v, kn, vn, bt, ln,
                                                     cl, ok))
    return outs


def paged_attention_sharded(qs, ks, vs, block_tables, lengths, chunk_lens, *,
                            mesh, n_kv_heads: int,
                            pages_per_compute_block: int = 1, append=None):
    """Port of ``repro.kernels.paged_attention.paged_attention_sharded``:
    the CUDA kernel launched once per shard of ``mesh`` on that shard's
    LOCAL head slab, with no collective (the caller sums the row-parallel
    ``wo`` products of the outputs).

    qs: per-shard q slabs [B, C, Hq/T, D]; ks/vs: per-shard arena slabs
    [P, page, Hkv/T, D], shard s's on ``mesh.devices[s]``; block_tables,
    lengths and chunk_lens: one tensor (copied to each shard's device
    without a host sync) or one per shard.  ``n_kv_heads`` is the GLOBAL
    count; T must divide it.  ``append`` = (k_news, v_news, write_ok):
    per-shard new K/V slabs [B, C, Hkv/T, D] and one write_ok (or one per
    shard) — each shard's launch then appends to its own slab
    (:func:`paged_attention_append_cuda`).  Returns the T per-shard
    outputs.  Counts one launch per shard."""
    outs = []
    for (q, k, v, bt, ln, cl), new in _shard_args(
            qs, ks, vs, block_tables, lengths, chunk_lens, mesh, n_kv_heads,
            append):
        if new is None:
            outs.append(paged_attention_cuda(q, k, v, bt, ln, cl,
                                             pages_per_compute_block))
        else:
            kn, vn, ok = new
            outs.append(paged_attention_append_cuda(
                q, k, v, kn, vn, bt, ln, cl, ok, pages_per_compute_block))
        count_launch(paged_attention_sharded)
    return outs


#: per-shard kernel launches made through the sharded entry point
paged_attention_sharded.launches = 0
