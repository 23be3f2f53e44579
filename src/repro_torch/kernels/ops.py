"""Public kernel entry points, dispatched by the tensors' device.

CUDA tensors go to the hand-written kernels (``paged_attention.py``,
``kv_append.py``), CPU tensors to their plain PyTorch versions.  No flag
sends a CUDA tensor to a plain version, or the fused append to two
launches: the JAX package's ``impl`` knob ("ref" / "interpret" /
"pallas") has no counterpart here.
"""

from __future__ import annotations

import torch

from .kv_append import kv_append_cuda, kv_append_plain
from .paged_attention import (paged_attention_append_cuda,
                              paged_attention_append_plain,
                              paged_attention_cuda, paged_attention_plain,
                              paged_attention_sharded,
                              paged_attention_sharded_plain)
from .ref import paged_attention_ref


def _one(x):
    """A replicated input given as one tensor or one per shard: the one."""
    return x if isinstance(x, torch.Tensor) else x[0]


def paged_attention(q, kv, block_tables, lengths, *,
                    pages_per_compute_block: int = 1, chunk_lens=None,
                    mesh=None, append=None, window: int = 0):
    """Decode or chunked-prefill attention over the paged pool.

    q [B, Hq, D] (decode) or [B, C, Hq, D] (chunk); kv {'k','v': [P, page,
    Hkv, D]}; block_tables [B, max_pages]; lengths [B] — the TOTAL valid KV
    length per row including the chunk's appended tokens; ``chunk_lens``
    [B] live query slots (None = all C live).  Returns q's rank.

    On CPU the decode form is the reference's decode oracle (−1 entries read
    as page 0) and the chunked form its chunked oracle; on CUDA both go
    through the kernel, which follows the Pallas kernel (−1 pages masked) —
    exactly the reference's ``impl="ref"`` / ``impl="pallas"`` split.  The
    kernel also writes zeros to the query slots past ``chunk_lens``, which
    the chunked oracle computes; no caller reads those slots.

    ``mesh`` (tensor-parallel serving, ``launch/mesh.py``): q is then a
    sequence of per-shard q slabs and kv of per-shard {'k','v'} arena slabs
    (shard s's KV heads, on ``mesh.devices[s]``); block_tables, lengths and
    chunk_lens are one tensor or one per shard, and the per-shard outputs
    are returned.  Over more than one shard both forms go through the
    sharded kernel (its plain version on CPU tensors, which masks −1 pages
    as the reference's interpret-mode sharded kernel does); a mesh of one
    shard is the single-device path, as the reference routes through its
    sharded kernel only when the 'model' axis is larger than 1.

    ``append`` = (k_new, v_new, write_ok) first writes the chunk's new K/V
    [B, C, Hkv, D] (per-shard slabs under ``mesh``; the arena's dtype) into
    the arena, in place, at positions ``lengths - chunk_lens`` onward
    (masks: ``kernels/kv_append.py``; ``write_ok`` [B] bool masks a whole
    row), then attends: the chunk form only.  On CUDA tensors that is ONE
    launch per shard (``paged_attention_append_cuda``); on CPU tensors
    ``kv_append_plain`` and then the attention above, the serving step's
    sequence before the fusion.

    ``window`` W > 0 (one device; a sliding-window layer): each query sees
    only the W key positions up to its own, and the kernel reads no page
    wholly before the chunk's first window; 0 = none.
    """
    qs, kvs = (q, kv) if mesh is not None else ([q], [kv])
    squeeze = qs[0].dim() == 3
    cuda = qs[0].is_cuda
    if append is not None and squeeze:
        raise ValueError("paged_attention: append needs the chunk form, "
                         "q [B, C, Hq, D]")
    if window and mesh is not None and mesh.tp > 1:
        raise ValueError("paged_attention: a sliding window is served on "
                         "one device")
    if squeeze and not cuda and (mesh is None or mesh.tp == 1):
        out = paged_attention_ref(qs[0], kvs[0]["k"], kvs[0]["v"],
                                  _one(block_tables), _one(lengths), window)
        return out if mesh is None else [out]
    q4 = [x[:, None].contiguous() if squeeze else x.contiguous() for x in qs]
    if squeeze or chunk_lens is None:
        # every query slot live; in the decode form (one query per row,
        # classic ``pos < lengths`` mask) chunk_lens is meaningless and is
        # dropped on every path
        B, C = q4[0].shape[:2]
        chunk_lens = torch.full((B,), C, dtype=torch.int32,
                                device=q4[0].device)
    ks = [x["k"] for x in kvs]
    vs = [x["v"] for x in kvs]
    if mesh is None or mesh.tp == 1:
        bt, ln, cl = _one(block_tables), _one(lengths), _one(chunk_lens)
        if append is None:
            args = (q4[0], ks[0], vs[0], bt, ln, cl)
            outs = [paged_attention_cuda(*args, pages_per_compute_block,
                                         window=window)
                    if cuda else paged_attention_plain(*args, window)]
        else:
            kn, vn, ok = (_one(x) for x in append)
            args = (q4[0], ks[0], vs[0], kn, vn, bt, ln, cl, ok)
            outs = [paged_attention_append_cuda(*args, pages_per_compute_block,
                                                window=window)
                    if cuda else paged_attention_append_plain(*args, window)]
    else:
        fn = paged_attention_sharded if cuda else paged_attention_sharded_plain
        outs = fn(q4, ks, vs, block_tables, lengths, chunk_lens, mesh=mesh,
                  n_kv_heads=sum(k.shape[2] for k in ks),
                  pages_per_compute_block=pages_per_compute_block,
                  append=append)
    outs = [o[:, 0] for o in outs] if squeeze else outs
    return outs[0] if mesh is None else outs


def kv_append(k_pages, v_pages, k_new, v_new, block_tables, lengths, n_new,
              write_ok):
    """Write each row's first ``n_new`` of C new K/V tokens into its pages,
    in place (masks: see ``kernels/kv_append.py``)."""
    if k_pages.is_cuda:
        kv_append_cuda(k_pages, v_pages, k_new, v_new, block_tables, lengths,
                       n_new, write_ok)
    else:
        kv_append_plain(k_pages, v_pages, k_new, v_new, block_tables, lengths,
                        n_new, write_ok)


def speculative_accept(target_toks, chunk_toks, draft_lens):
    """On-device accept scan for speculative decoding: per row, the longest
    draft prefix the verifier agrees with (``target_toks[:, j] ==
    chunk_toks[:, j + 1]`` for every ``j < n``, ``n <= draft_lens``).

    target_toks [B, C]; chunk_toks [B, C]; draft_lens [B] (0..C−1).
    Returns n_acc [B] int32.  A cumulative product over the match vector:
    the first mismatch zeroes everything after it."""
    C = target_toks.shape[1]
    j = torch.arange(C - 1, device=target_toks.device)
    match = (target_toks[:, : C - 1] == chunk_toks[:, 1:]) \
        & (j[None, :] < draft_lens[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(1).to(torch.int32)
