"""The port's attention, KV-append and accept-scan against the JAX package.

On the CPU the port's kernels run their plain PyTorch versions; those are
held to the JAX oracles (``kernels/ref.py``) and to the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them.  Tolerance: 2e-5
abs/rel in float32 (summation order only); the KV append is bit-exact.
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``; the CUDA attention kernel's split-and-merge
algorithm — its split rule (``row_splits``), stage size (``stage_tokens``)
and live query slots — is emulated here in plain torch
(``_split_emulation``) and held to the same oracles on the live slots,
padded slots exactly zero (``split_cases.assert_live_close``), over a
KV-head arena and over a one-head (multi-query) arena.  The fused append (``paged_attention(...,
append=...)``) is held to the JAX serving step's scatter followed by the
Pallas kernel: the arena exactly, the output to 1e-5 in float32.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_append import kv_append_pallas
from repro.kernels.ops import speculative_accept as jax_accept
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.ref import (paged_attention_chunked_ref,
                               paged_attention_ref)
from repro_torch.kernels import ops
from repro_torch.kernels.kv_append import kv_append_plain
from repro_torch.kernels.paged_attention import (MAX_SPLITS, row_splits,
                                                 split_pages, stage_tokens)
from repro_torch.kernels.ref import speculative_accept_ref
from split_cases import append_case, assert_live_close, split_edge_case

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _case(P, page, Hkv, D, Hq, B, maxp, C, seed, holes=False):
    """Ragged lengths, chunks straddling pages, rows finishing mid-chunk
    (chunk_lens < C), optional interior −1 holes."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, C, Hq, D)).astype(np.float32)
    bt = np.full((B, maxp), -1, np.int32)
    perm = rng.permutation(P)
    used = 0
    lens, cls = [], []
    for b in range(B):
        n = int(rng.integers(1, maxp + 1))
        bt[b, :n] = perm[used:used + n]
        used += n
        if holes and n > 2:
            bt[b, int(rng.integers(0, n - 1))] = -1
        ln = int(rng.integers(1, n * page + 1))
        lens.append(ln)
        cls.append(int(rng.integers(1, min(C, ln) + 1)))
    return q, k, v, bt, np.asarray(lens, np.int32), np.asarray(cls, np.int32)


def _port(q, k, v, bt, ln, cl=None, ppcb=1):
    T = torch.from_numpy
    return ops.paged_attention(
        T(q), {"k": T(k), "v": T(v)}, T(bt), T(ln),
        pages_per_compute_block=ppcb,
        chunk_lens=None if cl is None else T(cl)).numpy()


@pytest.mark.parametrize("C", [1, 8, 16])
@pytest.mark.parametrize("ppcb", [1, 2, 4])
def test_chunked_matches_ref_and_pallas_sweep(C, ppcb):
    """C ∈ {1,8,16} × ppcb ∈ {1,2,4}: GQA, ragged lengths, page straddles,
    mid-chunk finishes, −1 holes, max_pages % ppcb != 0 (6 % 4)."""
    q, k, v, bt, ln, cl = _case(32, 4, 2, 16, 4, 3, 6, C, seed=C * 10 + ppcb,
                                holes=True)
    J = jnp.asarray
    ref = paged_attention_chunked_ref(J(q), J(k), J(v), J(bt), J(ln), J(cl))
    pallas = paged_attention_pallas(
        J(q), J(k), J(v), J(bt), J(ln), page_size=4, n_kv_heads=2,
        pages_per_compute_block=ppcb, interpret=True, chunk_lens=J(cl))
    mine = _port(q, k, v, bt, ln, cl, ppcb)
    np.testing.assert_allclose(mine, np.asarray(ref), **TOL)
    np.testing.assert_allclose(mine, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("case", [(16, 8, 2, 16, 4, 3, 4), (8, 4, 1, 32, 8, 2, 3),
                                  (32, 16, 4, 64, 4, 1, 2),
                                  (16, 8, 2, 128, 16, 2, 4)],
                         ids=["gqa", "mqa", "mha", "d128"])
def test_decode_form_matches_decode_ref(case):
    """3-D q on the CPU is the reference's decode oracle, including its
    rule that −1 entries read as page 0 unmasked."""
    P, page, Hkv, D, Hq, B, maxp = case
    q, k, v, bt, ln, _ = _case(P, page, Hkv, D, Hq, B, maxp, 1, seed=P + D)
    bt[0, -1] = -1  # inside the gather, masked only by length
    J = jnp.asarray
    ref = paged_attention_ref(J(q[:, 0]), J(k), J(v), J(bt), J(ln))
    np.testing.assert_allclose(_port(q[:, 0], k, v, bt, ln), np.asarray(ref),
                               **TOL)


def test_rows_of_length_zero_give_zeros():
    q, k, v, bt, ln, cl = _case(8, 4, 2, 16, 4, 2, 3, 4, seed=3)
    ln[1], cl[1] = 0, 1
    out = _port(q, k, v, bt, ln, cl)
    assert np.all(out[1] == 0) and np.all(np.isfinite(out))
    J = jnp.asarray
    ref = paged_attention_chunked_ref(J(q), J(k), J(v), J(bt), J(ln), J(cl))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_plain_matches_pallas_at_c1(dtype):
    """C=1, every row live: the plain append equals ``kv_append_pallas``
    (a row whose page is −1 is skipped by both)."""
    P, page, Hkv, D = 8, 4, 2, 8
    rng = np.random.default_rng(0)
    bt = np.array([[2, 5, -1, -1], [1, -1, -1, -1], [-1, -1, -1, -1]], np.int32)
    ln = np.array([5, 2, 0], np.int32)
    kn = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    jd = getattr(jnp, dtype)
    kv = {"k": jnp.zeros((P, page, Hkv, D), jd),
          "v": jnp.zeros((P, page, Hkv, D), jd)}
    want = kv_append_pallas(kv, jnp.asarray(bt), jnp.asarray(ln),
                            jnp.asarray(kn, jd), jnp.asarray(vn, jd),
                            page_size=page, interpret=True)
    td = getattr(torch, dtype)
    arena = [torch.zeros((P, page, Hkv, D), dtype=td) for _ in range(2)]
    kv_append_plain(*arena, torch.from_numpy(kn)[:, None].to(td),
                    torch.from_numpy(vn)[:, None].to(td), torch.from_numpy(bt),
                    torch.from_numpy(ln), torch.ones(3, dtype=torch.int32),
                    torch.ones(3, dtype=torch.bool))
    for name, t in zip("kv", arena):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[name], np.float32))


def test_kv_append_plain_matches_chunk_core_scatter():
    """C>1: the plain append is the JAX serving step's masked scatter
    (``paged_decode.py`` _chunk_core): j >= n_new, −1 pages, page slots past
    M and write_ok=False rows are all skipped."""
    P, page, Hkv, D, B, C, M = 12, 4, 2, 8, 4, 6, 3
    rng = np.random.default_rng(1)
    bt = rng.permutation(P)[: B * M].reshape(B, M).astype(np.int32)
    bt[1, 1] = -1
    ln = np.array([1, 2, 9, 3], np.int32)  # row 2 runs past M * page
    n_new = np.array([6, 5, 4, 2], np.int32)
    ok = np.array([True, True, True, False])
    kn = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    base = rng.standard_normal((2, P, page, Hkv, D)).astype(np.float32)
    # the reference's scatter, written out as in _chunk_core
    pos = ln[:, None] + np.arange(C)[None]
    pos_page, slot = pos // page, pos % page
    pages = np.take_along_axis(bt, np.minimum(pos_page, M - 1), axis=1)
    wvalid = (np.arange(C)[None] < n_new[:, None]) & (pages >= 0) \
        & (pos_page < M) & ok[:, None]
    pidx = jnp.asarray(np.where(wvalid, pages, P))
    want = [jnp.asarray(base[i]).at[pidx, jnp.asarray(slot)].set(
        jnp.asarray(new), mode="drop") for i, new in enumerate((kn, vn))]
    arena = [torch.from_numpy(base[i].copy()) for i in range(2)]
    kv_append_plain(*arena, torch.from_numpy(kn), torch.from_numpy(vn),
                    torch.from_numpy(bt), torch.from_numpy(ln),
                    torch.from_numpy(n_new), torch.from_numpy(ok))
    for w, t in zip(want, arena):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def _jax_scatter(arena, new, bt, old, n_new, ok):
    """The JAX serving step's masked KV write (``repro.serving.paged_decode
    ._chunk_core``), written out: dropped where j >= n_new, the page is −1
    or past the arena, the page slot is past M, or write_ok is False."""
    P, page = arena.shape[:2]
    B, C = new.shape[:2]
    M = bt.shape[1]
    pos = old[:, None] + np.arange(C)[None]
    pos_page = pos // page
    pages = np.take_along_axis(bt, np.minimum(pos_page, M - 1), axis=1)
    wvalid = (np.arange(C)[None] < n_new[:, None]) & (pages >= 0) \
        & (pos_page < M) & ok[:, None]
    pidx = jnp.asarray(np.where(wvalid, pages, P))
    return jnp.asarray(arena).at[pidx, jnp.asarray(pos % page)].set(
        jnp.asarray(new), mode="drop")


@pytest.mark.parametrize("C", [1, 4])
def test_fused_append_matches_jax_append_then_pallas(C):
    """``paged_attention(..., append=...)`` on the CPU against the JAX
    step's scatter followed by ``paged_attention_pallas`` in interpret mode
    (and the chunked oracle): a straddling chunk, a denied row finishing
    mid-chunk, a page id past the arena and a −1 page (``append_case``)."""
    q, k, v, kn, vn, bt, ln, cl, ok = append_case(C, 4, 2, 16, seed=C)
    old = ln - cl
    jk, jv = (_jax_scatter(a, n, bt, old, cl, ok) for a, n in ((k, kn),
                                                               (v, vn)))
    J = jnp.asarray
    pallas = paged_attention_pallas(
        J(q), jk, jv, J(bt), J(ln), page_size=4, n_kv_heads=2,
        interpret=True, chunk_lens=J(cl))
    ref = paged_attention_chunked_ref(J(q), jk, jv, J(bt), J(ln), J(cl))
    T = torch.from_numpy
    arena = {"k": T(k.copy()), "v": T(v.copy())}
    out = ops.paged_attention(T(q), arena, T(bt), T(ln), chunk_lens=T(cl),
                              append=(T(kn), T(vn), T(ok))).numpy()
    np.testing.assert_array_equal(arena["k"].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(arena["v"].numpy(), np.asarray(jv))
    assert not np.array_equal(arena["k"].numpy(), k)  # row 0 wrote
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)


def test_fused_append_rejects_the_decode_form():
    q, k, v, kn, vn, bt, ln, cl, ok = (torch.from_numpy(a) for a in
                                       append_case(1, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="chunk form"):
        ops.paged_attention(q[:, 0], {"k": k, "v": v}, bt, ln,
                            append=(kn, vn, ok))


def test_speculative_accept_matches_reference():
    rng = np.random.default_rng(0)
    for i in range(30):  # three shapes: one compile each on the JAX side
        B, C = 6, (1, 4, 8)[i % 3]
        tgt = rng.integers(0, 3, (B, C)).astype(np.int32)
        chunk = rng.integers(0, 3, (B, C)).astype(np.int32)
        dl = rng.integers(0, C, (B,)).astype(np.int32)
        got = ops.speculative_accept(torch.from_numpy(tgt),
                                     torch.from_numpy(chunk),
                                     torch.from_numpy(dl)).numpy()
        np.testing.assert_array_equal(got, speculative_accept_ref(tgt, chunk,
                                                                  dl))
        if C > 1:
            np.testing.assert_array_equal(got, np.asarray(jax_accept(
                jnp.asarray(tgt), jnp.asarray(chunk), jnp.asarray(dl))))


# ---------------------------------------------------------------------------
# the CUDA kernel's split-KV algorithm (kernels/csrc/paged_attention.cu),
# emulated in plain torch: per-row page partition by the port's split rule,
# per-split online softmax over stages of the kernel's stage size with the
# kernel's guards, the merge of the partials in split order


def _split_emulation(q, k, v, bt, ln, cl, splits=None,
                     kv_dtype=torch.bfloat16):
    """[B, C, Hq, D] float32, computed one (row, KV head) at a time as the
    kernel's blocks do: a row of n = min(ceil(len/page), M) pages has S =
    ``row_splits(n, D, page, splits)`` splits, split s taking pages
    [s*n//S, (s+1)*n//S), each walked in stages of ``stage_tokens(D,
    kv_dtype)`` tokens; a split of -1 pages gives m = −inf, l = 0 and is
    skipped by the merge.  Only a row's live query slots (c < cl) are
    computed; the padded ones stay zero.  Products are elementwise sums, so a query row's
    bits never depend on how many rows share the call (a matmul's blocking
    may)."""
    q, k, v = (torch.as_tensor(a, dtype=torch.float32) for a in (q, k, v))
    bt = torch.as_tensor(bt).long()
    B, C, Hq, D = q.shape
    P, page, Hkv, _ = k.shape
    G, M = Hq // Hkv, bt.shape[1]
    tile = stage_tokens(D, kv_dtype)
    out = torch.zeros(B, C, Hq, D)
    for b in range(B):
        L, CL = int(ln[b]), int(cl[b])
        n = min(-(-L // page), M) if L > 0 else 0
        S = row_splits(n, D, page, splits)
        if CL <= 0:
            continue  # no live slot
        lim = torch.tensor([min(L - CL + c + 1, L) for c in range(CL)]
                           ).repeat_interleave(G)  # slot qi = c * G + g
        NQ = CL * G  # the live slots
        for h in range(Hkv):
            qh = q[b, :CL, h * G:(h + 1) * G].reshape(NQ, D)
            parts = []
            for s in range(S):
                t0, t1 = s * n // S * page, min((s + 1) * n // S * page, L)
                m = torch.full((NQ,), -math.inf)
                l = torch.zeros(NQ)
                acc = torch.zeros(NQ, D)
                for a in range(t0, t1, tile):
                    ts = torch.arange(a, min(a + tile, t1))
                    pid = bt[b, ts // page]
                    mapped = pid >= 0
                    pid = pid.clamp(0, P - 1)
                    kt = k[pid, ts % page, h]
                    vt = torch.where(mapped[:, None], v[pid, ts % page, h], 0.)
                    live = mapped[None, :] & (ts[None, :] < lim[:, None])
                    dots = (qh[:, None, :] * kt[None]).sum(-1)
                    sc = torch.where(live, dots / math.sqrt(D), -math.inf)
                    m_new = torch.maximum(m, sc.amax(1))
                    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.)
                    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                        0.)
                    p = torch.where(live, torch.exp(sc - m_safe[:, None]), 0.)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + (p[:, :, None] * vt[None]
                                                  ).sum(1)
                    m = m_new
                parts.append((m, l, acc))
            m_tot = torch.stack([m for m, _, _ in parts]).amax(0)
            m_safe = torch.where(torch.isfinite(m_tot), m_tot, 0.)
            l = torch.zeros(NQ)
            acc = torch.zeros(NQ, D)
            for m_s, l_s, a_s in parts:  # in split order
                keep = torch.isfinite(m_s)
                f = torch.where(keep, torch.exp(m_s - m_safe), 0.)
                l = l + torch.where(keep, l_s * f, 0.)
                acc = acc + torch.where(keep[:, None], a_s * f[:, None], 0.)
            out[b, :CL, h * G:(h + 1) * G] = (
                acc / l.clamp(min=1e-30)[:, None]).reshape(CL, G, D)
    return out


@functools.cache
def _edge_refs(S, C, Hq=4, Hkv=2, D=16, B=8):
    """An edge case (page 4; GQA 4:2 at D 16 unless given) with the JAX
    package's chunked oracle and its Pallas kernel in interpret mode on
    it, computed once per case."""
    case = split_edge_case(S, 4, C, Hq, Hkv, D, seed=S * 10 + C, B=B)
    J = jnp.asarray
    q, k, v, bt, ln, cl = map(J, case)
    ref = paged_attention_chunked_ref(q, k, v, bt, ln, cl)
    pallas = paged_attention_pallas(q, k, v, bt, ln, page_size=4,
                                    n_kv_heads=Hkv, interpret=True,
                                    chunk_lens=cl)
    return case, np.asarray(ref), np.asarray(pallas)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 8])
def test_split_emulation_matches_plain_ref_and_pallas(S, C):
    """The kernel's split-and-merge, at every split count, on rows that end
    before, inside and across split boundaries, equals the plain version,
    the JAX chunked oracle and the interpret-mode Pallas kernel on every
    live query slot, and gives zeros on the padded ones."""
    case, ref, pallas = _edge_refs(S, C)
    mine = _split_emulation(*case, S).numpy()
    assert np.all(mine[4] == 0)  # the row of length 0
    for want in (_port(*case), ref, pallas):
        assert_live_close(mine, want, case[5], **TOL)


@pytest.mark.parametrize("S", [1, 2, 4, 8, None], ids=["S1", "S2", "S4", "S8",
                                                       "rule"])
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("Hq,D,kv_dtype", [(8, 256, torch.bfloat16),
                                           (8, 256, torch.float32),
                                           (12, 128, torch.bfloat16)],
                         ids=["d256_g8", "d256_g8_f32", "d128_g12"])
def test_split_rule_over_a_one_head_arena(S, C, Hq, D, kv_dtype):
    """Multi-query shapes, one KV head, 7 rows of page 4: paligemma's head
    dim 256 with its 8 query heads, and head dim 128 with 12 query heads
    (a reduced stand-in for granite-20b's 48).  The split rule's partition
    (forced to S splits, and the rule's own: 16 pages a split at D 256,
    32 at D 128) walked in the kernel's stages (64 tokens; 32 for a float32
    arena at D 256) equals the plain version, the JAX chunked oracle and
    the interpret-mode Pallas kernel on the live query slots, padded
    slots zero."""
    case, ref, pallas = _edge_refs(S or 8, C, Hq, 1, D, B=7)
    mine = _split_emulation(*case, S, kv_dtype).numpy()
    assert np.all(mine[4] == 0)  # the row of length 0
    for want in (_port(*case), ref, pallas):
        assert_live_close(mine, want, case[5], **TOL)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_split_emulation_heads_do_not_depend_on_hkv_or_shards(S):
    """A head's output is bitwise the same from the whole arena (Hkv=4),
    from 2 shards of 2 heads and from 4 shards of 1: the partition reads
    only the row's page count and S.  Over a one-head arena (multi-query)
    the shards are copies, each on its slab of the 8 query heads (G = 8,
    4, 2): each head's output is bitwise that of the whole launch too."""
    q, k, v, bt, ln, cl = split_edge_case(S, 4, 8, 8, 4, 16, seed=S)
    full = _split_emulation(q, k, v, bt, ln, cl, S)
    for tp in (2, 4):
        hq, hk = 8 // tp, 4 // tp
        outs = [_split_emulation(q[:, :, i * hq:(i + 1) * hq],
                                 k[:, :, i * hk:(i + 1) * hk],
                                 v[:, :, i * hk:(i + 1) * hk], bt, ln, cl, S)
                for i in range(tp)]
        assert torch.equal(torch.cat(outs, dim=2), full)
    q, k, v, bt, ln, cl = split_edge_case(S, 4, 8, 8, 1, 16, seed=S + 50)
    full = _split_emulation(q, k, v, bt, ln, cl, S)
    for tp in (2, 4):
        hq = 8 // tp
        outs = [_split_emulation(q[:, :, i * hq:(i + 1) * hq], k.copy(),
                                 v.copy(), bt, ln, cl, S) for i in range(tp)]
        assert torch.equal(torch.cat(outs, dim=2), full)


@pytest.mark.parametrize("D,per", [(16, 64), (32, 32), (64, 16), (128, 8),
                                   (256, 4)])
def test_row_splits_read_only_pages_head_dim_and_page_size(D, per):
    """The split rule at 16-token pages: ``split_pages`` pages a split (32
    KB of bf16 K a KV head), at most ``MAX_SPLITS``, one split for a row of
    no pages; a forced count is capped by the row's pages.  paligemma-3b's
    rows of 80-272 tokens (5-17 pages) get 2-5 splits at D 256, olmo-1b's
    1-3 at D 128."""
    assert split_pages(D, 16) == per
    for n in range(0, 600):
        S = row_splits(n, D, 16)
        assert S == (1 if n == 0 else min(MAX_SPLITS, -(-n // per)))
        assert all(n == 0 or s * n // S < (s + 1) * n // S for s in range(S))
        for forced in (1, 2, 4, 8):
            assert row_splits(n, D, 16, forced) == (min(forced, n) if n else 1)
    if D == 256:
        assert [row_splits(n, D, 16) for n in (5, 8, 9, 17)] == [2, 2, 3, 5]
    if D == 128:
        assert [row_splits(n, D, 16) for n in (5, 8, 9, 17)] == [1, 1, 2, 3]
    assert stage_tokens(D, torch.bfloat16) == 64
    assert stage_tokens(D, torch.float32) == (32 if D == 256 else 64)
