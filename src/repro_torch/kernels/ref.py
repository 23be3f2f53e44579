"""Plain PyTorch versions of the kernels (the port of ``repro.kernels.ref``).

``paged_attention_ref`` is the decode form: gather pages through the block
table (−1 entries read as page 0 and are NOT masked — the reference's
decode oracle semantics), mask to the live length, softmax.
``paged_attention_chunked_ref`` is the chunked form and the semantics of
the CUDA kernel: C queries per row, the in-chunk causal mask (query j of a
row whose chunk holds ``chunk_lens`` live tokens sees key positions
``< min(lengths - chunk_lens + j + 1, lengths)``), −1 pages masked, and the
guarded softmax that gives zeros for fully masked queries.  Both keep the
reference's forms exactly; they compute in float32 and return q's dtype.
Both take a sliding ``window`` W (0 = none, the reference's forms): a
query sees only the W key positions up to its own (those ``>= limit −
W``, ``limit`` its horizon above).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _gather(pages_arr, block_tables):
    """[B, M] page ids -> [B, M * page, Hkv, D]; ids clamp into the arena as
    the reference's gathers do."""
    P, page, Hkv, D = pages_arr.shape
    B, M = block_tables.shape
    idx = torch.clamp(block_tables.to(torch.int64), 0, P - 1)
    return pages_arr[idx].reshape(B, M * page, Hkv, D)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        window: int = 0):
    """q [B, Hq, D]; k_pages/v_pages [P, page, Hkv, D]; block_tables
    [B, max_pages] int (−1 = unmapped, read as page 0); lengths [B];
    ``window`` (module docstring).  Returns [B, Hq, D] (q.dtype)."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(k.shape[1], device=q.device)
    seen = pos[None, :] < lengths[:, None]
    if window:
        seen = seen & (pos[None, :] >= lengths[:, None] - window)
    s = torch.where(seen[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_attention_chunked_ref(q, k_pages, v_pages, block_tables, lengths,
                                chunk_lens, window: int = 0):
    """q [B, C, Hq, D]; k_pages/v_pages [P, page, Hkv, D]; block_tables
    [B, max_pages] (−1 = unmapped, masked); lengths [B] — the TOTAL valid
    KV length per row including the chunk; chunk_lens [B] (1..C) live query
    slots; ``window`` (module docstring).  Returns [B, C, Hq, D]
    (q.dtype); fully masked queries give 0."""
    B, C, Hq, D = q.shape
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    G = Hq // Hkv
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    S = k.shape[1]
    qg = q.reshape(B, C, Hkv, G, D).float()
    s = torch.einsum("bchgd,bshd->bchgs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    ln = lengths.to(torch.int64)[:, None]
    qpos = ln - chunk_lens.to(torch.int64)[:, None] \
        + torch.arange(C, device=q.device)[None, :]  # [B, C]
    limit = torch.minimum(qpos + 1, ln)  # in-chunk causal horizon
    mapped = (block_tables >= 0)[:, pos // page]  # [B, S]
    mask = (pos[None, None, :] < limit[:, :, None]) & mapped[:, None, :]
    if window:
        mask = mask & (pos[None, None, :] >= limit[:, :, None] - window)
    mask = mask[:, :, None, None, :]
    s = torch.where(mask, s, -torch.inf)
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    l = torch.clamp(p.sum(-1), min=1e-30)
    o = torch.einsum("bchgs,bshd->bchgd", p / l[..., None], v)
    return o.reshape(B, C, Hq, D).to(q.dtype)


def speculative_accept_ref(target_toks, chunk_toks, draft_lens):
    """Python-loop oracle for the speculative accept scan (numpy-friendly):
    per row, the longest prefix ``j < draft_lens`` with
    ``target_toks[j] == chunk_toks[j + 1]``.  Returns n_acc [B] int32."""
    t = np.asarray(target_toks)
    c = np.asarray(chunk_toks)
    d = np.asarray(draft_lens)
    B, C = t.shape
    out = np.zeros((B,), np.int32)
    for b in range(B):
        n = 0
        while n < min(int(d[b]), C - 1) and t[b, n] == c[b, n + 1]:
            n += 1
        out[b] = n
    return out
