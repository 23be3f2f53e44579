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
