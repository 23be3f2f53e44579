"""The split-KV paged-attention kernel's edge cases, as numpy arrays.

One generator for every place that holds the split design to the plain
version: the CPU emulation in ``tests/test_torch_paged_attention.py``, the
``cuda``-marked tests in ``tests/test_torch_cuda.py`` and the kernel phase
of ``chip_smoke.py``.  Imports numpy only.
"""

import numpy as np


def split_edge_case(S, page, C, Hq, Hkv, D, seed, B=8):
    """q [B, C, Hq, D], k/v [P, page, Hkv, D] (float32), block tables
    [B, M], lengths [B] and chunk lengths [B] (int32), M = 4S + 4 and
    P = B * M, whose rows the split-KV kernel must get right for split
    count S: row 0 one token; row 1 fewer pages than S; row 2 2S pages
    with split 1's pages (2 and 3) all −1; row 3 S pages, the last split
    holding 3 tokens and the chunk starting 5 tokens before it, so its
    causal horizon crosses the last split boundary; row 4 length 0; row 5
    a table entry past the arena (clamped to its last page); row 6 a −1
    hole; the rest random."""
    rng = np.random.default_rng(seed)
    M = 4 * S + 4
    P = B * M
    bt = np.stack([rng.permutation(P)[:M] for _ in range(B)]).astype(np.int32)
    ln = rng.integers(1, M * page + 1, B).astype(np.int32)
    cl = np.minimum(rng.integers(1, C + 1, B), ln).astype(np.int32)
    ln[0], cl[0] = 1, 1
    ln[1] = max(S - 1, 1) * page - 1
    cl[1] = min(C, ln[1])
    ln[2] = 2 * S * page
    bt[2, 2:4] = -1
    ln[3] = (S - 1) * page + 3
    cl[3] = min(C, 8, ln[3])
    ln[4], cl[4] = 0, 1
    bt[5, 1] = P + 3
    bt[6, rng.integers(0, M)] = -1
    k = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, C, Hq, D)).astype(np.float32)
    return q, k, v, bt, ln, cl


def append_case(C, Hq, Hkv, D, seed, page=4, P=16):
    """Inputs of the fused KV append + attention (``paged_attention(...,
    append=...)``) at a small size, three rows: q [3, C, Hq, D], arena k/v
    [P, page, Hkv, D], k_new/v_new [3, C, Hkv, D] (float32), block tables
    [3, 4], TOTAL lengths and chunk lengths (int32), write_ok [3] (bool).
    Row 0 appends C tokens from position 6 on (at C = 4 the chunk straddles
    pages 1 and 2); row 1 is denied (write_ok False) and finishes
    mid-chunk; row 2's chunk falls on a page id >= P (read as page P - 1,
    never written) and, at C = 4, on a -1 page.  Table pages are distinct
    and none is P - 1, so no row reads a slot another row writes."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(P - 1)
    bt = np.array([[pages[0], pages[1], pages[2], -1],
                   [pages[3], pages[4], pages[5], pages[6]],
                   [pages[7], P + 2, -1, pages[8]]], np.int32)
    old = np.array([6, 9, 7], np.int32)
    cl = np.array([C, min(C, 3), C], np.int32)
    ok = np.array([True, False, True])
    k, v = (rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kn, vn = (rng.standard_normal((3, C, Hkv, D)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((3, C, Hq, D)).astype(np.float32)
    return q, k, v, kn, vn, bt, old + cl, cl, ok


def append_edge_case(S, page, C, Hq, Hkv, D, seed, B=8):
    """:func:`split_edge_case` with the fused append's inputs: q, k, v
    (one page more), k_new, v_new [B, C, Hkv, D] (float32), block tables,
    TOTAL lengths, chunk lengths and write_ok [B] (bool).  The tables are
    redrawn so that no page is mapped twice and none maps the arena's last
    page, which row 5 reads through its entry past the arena: no row reads
    a slot another row writes.  Row 4 (length 0) appends nothing; row 5's
    chunk sits on that entry (the append masked, the read clamped); row 6's
    chunk ends on a -1 page; row 7 is denied (write_ok False)."""
    q, k, v, bt, ln, cl = split_edge_case(S, page, C, Hq, Hkv, D, seed, B)
    rng = np.random.default_rng(seed + 1)
    P, M = k.shape[0], bt.shape[1]
    live = (bt >= 0) & (bt < P)
    bt = np.where(live, -1, bt)
    bt[live] = rng.permutation(P)[: int(live.sum())]
    bt[bt >= P] = P + 1 + 3  # still past the arena of P + 1 pages
    k, v = (np.concatenate([a, rng.standard_normal(a[:1].shape)
                            .astype(np.float32)]) for a in (k, v))
    cl[4] = 0
    ln[5] = 2 * page - 1
    cl[5] = min(C, page - 1)
    bt[6, (int(ln[6]) - 1) // page] = -1
    ok = np.ones(B, bool)
    ok[7] = False
    kn, vn = (rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
              for _ in range(2))
    return q, k, v, kn, vn, bt, ln, cl, ok
