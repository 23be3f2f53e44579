"""Public kernel entry points, dispatched by the tensors' device.

CUDA tensors go to the hand-written kernels (``paged_attention.py``,
``kv_append.py``), CPU tensors to their plain PyTorch versions.  No flag
sends a CUDA tensor to a plain version: the JAX package's ``impl`` knob
("ref" / "interpret" / "pallas") has no counterpart here.
"""

from __future__ import annotations

import torch

from .kv_append import kv_append_cuda, kv_append_plain
from .paged_attention import paged_attention_cuda, paged_attention_plain
from .ref import paged_attention_ref


def paged_attention(q, kv, block_tables, lengths, *,
                    pages_per_compute_block: int = 1, chunk_lens=None):
    """Decode or chunked-prefill attention over the paged pool.

    q [B, Hq, D] (decode) or [B, C, Hq, D] (chunk); kv {'k','v': [P, page,
    Hkv, D]}; block_tables [B, max_pages]; lengths [B] — the TOTAL valid KV
    length per row including the chunk's appended tokens; ``chunk_lens``
    [B] live query slots (None = all C live).  Returns q's rank.

    On CPU the decode form is the reference's decode oracle (−1 entries read
    as page 0) and the chunked form its chunked oracle; on CUDA both go
    through the kernel, which follows the Pallas kernel (−1 pages masked) —
    exactly the reference's ``impl="ref"`` / ``impl="pallas"`` split.
    """
    if q.dim() == 3:
        # decode form: one query per row, classic ``pos < lengths`` mask —
        # chunk_lens is meaningless here and is dropped on every path
        chunk_lens = None
    if not q.is_cuda:
        if q.dim() == 3:
            return paged_attention_ref(q, kv["k"], kv["v"], block_tables,
                                       lengths)
        if chunk_lens is None:
            chunk_lens = torch.full((q.shape[0],), q.shape[1],
                                    dtype=torch.int32, device=q.device)
        return paged_attention_plain(q, kv["k"], kv["v"], block_tables,
                                     lengths, chunk_lens)
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    if chunk_lens is None:
        chunk_lens = torch.full((q4.shape[0],), q4.shape[1], dtype=torch.int32,
                                device=q.device)
    out = paged_attention_cuda(
        q4.contiguous(), kv["k"], kv["v"], block_tables, lengths, chunk_lens,
        pages_per_compute_block)
    return out[:, 0] if squeeze else out


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
