"""The port's attention, KV-append and accept-scan against the JAX package.

On the CPU the port's kernels run their plain PyTorch versions; those are
held to the JAX oracles (``kernels/ref.py``) and to the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them.  Tolerance: 2e-5
abs/rel in float32 (summation order only); the KV append is bit-exact.
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

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
from repro_torch.kernels.ref import speculative_accept_ref

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
