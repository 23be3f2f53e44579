"""The split-KV paged-attention kernel's edge cases, as numpy arrays.

One generator for every place that holds the split design to the plain
version: the CPU emulation in ``tests/test_torch_paged_attention.py``, the
``cuda``-marked tests in ``tests/test_torch_cuda.py`` and
``tests/test_torch_cuda_afmoe.py`` and the kernel phase of
``chip_smoke.py``; and the check all of them hold the kernel's output to
(:func:`live_error`, which :func:`assert_live_close` asserts on): the
plain version's on live query slots, exact zeros on the padded ones.
Imports numpy only.
"""

import numpy as np


def _host(x, dtype):
    """A numpy array of ``x``: an array, or a torch tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        x = (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x, dtype)


#: The limit of :func:`live_share` on a bf16 kernel-1 output whose plain
#: version's inputs are unit normal.  Rounding P and the output to bf16
#: leaves about one ulp at a row's largest values: at most 2^-7 of a value
#: some 4-5.5 times the row's RMS, so 3-4% of it.  2e-2 absolute is about
#: that RMS itself (sqrt(e / keys): 0.02 at 7k keys), so it lets a dropped
#: page or a window edge a page off through; this does not.
LIVE_RMS_SHARE = 0.1


def live_slots(chunk_lens, C):
    """[B, C] bool: query slot c of row b is live when c < chunk_lens[b]."""
    return np.arange(C)[None, :] < _host(chunk_lens, np.int64)[:, None]


def live_error(got, want, chunk_lens, rtol=0.0):
    """Kernel 1's output ``got`` [B, C, H, D] against ``want`` (the plain
    version's): (the largest of |got - want| - ``rtol`` · |want| over the
    live query slots, NaN where either is NaN there; the number of padded
    slots' elements that are not exactly zero; the root mean square of
    ``want`` over the live slots, the scale of what is compared)."""
    got, want = _host(got, np.float32), _host(want, np.float32)
    live = live_slots(chunk_lens, got.shape[1])
    g, w = got[live], want[live]
    d = np.abs(g - w) - rtol * np.abs(w)
    rms = float(np.sqrt(np.mean(np.square(w)))) if w.size else 0.0
    return float(d.max(initial=0.0)), int(np.count_nonzero(got[~live])), rms


def live_share(got, want, chunk_lens):
    """The largest, over the rows b of ``got`` [B, C, H, D], of row b's
    :func:`live_error` as a share of its live RMS: the limit follows each
    row's scale (a row over N unit-normal keys has an RMS of about
    sqrt(e / N)).  NaN where a live slot is NaN; a row with no live slot
    counts 0."""
    got, want = _host(got, np.float32), _host(want, np.float32)
    cl = _host(chunk_lens, np.int64)
    shares = [0.0]
    for b in range(got.shape[0]):
        err, _, rms = live_error(got[b:b + 1], want[b:b + 1], cl[b:b + 1])
        shares.append(err / rms if rms else (0.0 if err == 0 else np.inf))
    return float(np.max(shares))


def assert_live_close(got, want, chunk_lens, atol, rtol=0.0):
    """Assert kernel 1's contract on ``got`` [B, C, H, D]: every live query
    slot within ``atol`` (+ ``rtol`` · |want|) of ``want``, NaN nowhere
    equal to anything, and every padded slot (c >= chunk_lens[b]) exactly
    zero.  Each element is checked once, by one of the two."""
    err, stray, rms = live_error(got, want, chunk_lens, rtol)
    assert stray == 0, f"{stray} elements of padded query slots are not zero"
    assert err <= atol, (f"live slots differ by up to {err} beyond rtol "
                         f"{rtol} (atol {atol}; live RMS {rms:.3g})")


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
