"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with that
reason elsewhere; the file imports no jax, so it runs on a machine that
has only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerance: float32 1e-4 abs (summation order); bfloat16 2e-2 abs (outputs
may round to a neighbouring bf16 value); the KV append is bit-exact, and
the fused append + attention launch is bitwise the two-launch pair.
Kernel 1 computes only each row's live query slots (its header note,
point 8): held to the plain version there, its padded slots (c >=
chunk_lens) to exact zeros (``split_cases.assert_live_close``).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.kv_append import kv_append_plain
from split_cases import (append_edge_case, assert_live_close,
                         split_edge_case)

torch.set_num_threads(1)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,ppcb", [(1, 1), (8, 2), (16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_matches_plain(cuda, C, ppcb, dtype):
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    q, k, v, bt, ln, cl = _case(32, 4, 2, 64, 8, 4, 6, C, seed=C, holes=True)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, bt, ln, cl)]
    args[:3] = [a.to(td) for a in args[:3]]
    got = paged_attention_cuda(*args, pages_per_compute_block=ppcb)
    want = paged_attention_plain(*args)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert_live_close(got, want, args[5], atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("C,Hq,Hkv", [(1, 4, 4), (16, 4, 4), (16, 8, 2)],
                         ids=["decode", "chunk", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_attention_split_edges(cuda, S, C, Hq, Hkv, dtype):
    """The split-KV kernel at every split count against the plain version
    on rows that end inside, before and across split boundaries."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(cuda) for a in
            split_edge_case(S, 16, C, Hq, Hkv, 128, seed=S * 7 + C)]
    args[:3] = [a.to(td) for a in args[:3]]
    got = paged_attention_cuda(*args, _splits=S)
    want = paged_attention_plain(*args)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert_live_close(got, want, args[5], atol=tol)
    assert bool((got[4] == 0).all())  # the row of length 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_heads_are_bitwise_the_same_at_every_shard_count(cuda, dtype):
    """Each head's output of one launch over the whole arena equals, bit
    for bit, that of the per-shard launches over head slabs (TP=2 and 4)."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    td = getattr(torch, dtype)
    q, k, v, bt, ln, cl = [torch.from_numpy(a).to(cuda) for a in
                           split_edge_case(4, 16, 16, 16, 8, 128, seed=5)]
    q, k, v = (a.to(td) for a in (q, k, v))
    full = paged_attention_cuda(q, k, v, bt, ln, cl)
    for tp in (2, 4):
        outs = [paged_attention_cuda(*(t.contiguous() for t in sl), bt, ln, cl)
                for sl in zip(*(a.chunk(tp, dim=2) for a in (q, k, v)))]
        assert torch.equal(torch.cat(outs, dim=2), full)


@pytest.mark.cuda
def test_cuda_kv_append_is_bit_exact(cuda):
    from repro_torch.kernels.kv_append import kv_append_cuda
    rng = np.random.default_rng(2)
    P, page, Hkv, D, B, C, M = 16, 4, 2, 64, 4, 6, 4
    bt = torch.from_numpy(rng.permutation(P)[: B * M].reshape(B, M)
                          .astype(np.int32)).to(cuda)
    ln = torch.tensor([1, 2, 13, 3], dtype=torch.int32, device=cuda)
    n_new = torch.tensor([6, 5, 4, 2], dtype=torch.int32, device=cuda)
    ok = torch.tensor([True, True, True, False], device=cuda)
    kn = torch.randn((B, C, Hkv, D), device=cuda).bfloat16()
    vn = torch.randn((B, C, Hkv, D), device=cuda).bfloat16()
    a = [torch.randn((P, page, Hkv, D), device=cuda).bfloat16()
         for _ in range(2)]
    b = [t.clone() for t in a]
    kv_append_cuda(*a, kn, vn, bt, ln, n_new, ok)
    kv_append_plain(*b, kn, vn, bt, ln, n_new, ok)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("C,Hq,Hkv", [(1, 4, 4), (16, 4, 4), (16, 32, 4)],
                         ids=["decode", "chunk", "gqa_two_query_groups"])
@pytest.mark.parametrize("qd,kd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16")])
def test_cuda_fused_append_is_the_two_launch_pair(cuda, S, C, Hq, Hkv, qd,
                                                  kd):
    """One fused launch equals kv_append_cuda + paged_attention_cuda bit for
    bit, in arena and output, on the split edge cases with denied rows, −1
    pages and a page id past the arena (``append_edge_case``; at C=16 GQA
    8:1 has C * G = 128 query slots, two query groups of which one
    writes); its arena is bit-exact against the plain version."""
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(S, 16, C, Hq, Hkv, 64, seed=S * 3 + C + Hq)]
    q = q.to(getattr(torch, qd))
    k, v, kn, vn = (a.to(getattr(torch, kd)) for a in (k, v, kn, vn))
    pair, mine, plain = ([k.clone(), v.clone()] for _ in range(3))
    kv_append_cuda(*pair, kn, vn, bt, ln - cl, cl, ok)
    want = paged_attention_cuda(q, *pair, bt, ln, cl, _splits=S)
    got = paged_attention_append_cuda(q, *mine, kn, vn, bt, ln, cl, ok,
                                      _splits=S)
    ref = paged_attention_append_plain(q, *plain, kn, vn, bt, ln, cl, ok)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(mine, pair))
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    assert not torch.equal(mine[0], k)
    tol = 2e-2 if "bfloat16" in (qd, kd) else 1e-4
    assert_live_close(got, ref, cl, atol=tol)


@pytest.mark.cuda
def test_cuda_fused_append_rejects_bad_inputs(cuda):
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda)
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(1, 16, 4, 4, 4, 64, seed=0)]
    k, v = k.bfloat16(), v.bfloat16()
    good = (kn.bfloat16(), vn.bfloat16())
    args = lambda kn, vn: (q.bfloat16(), k, v, kn, vn, bt, ln, cl, ok)
    with pytest.raises(ValueError, match="arena's dtype"):
        paged_attention_append_cuda(*args(kn, good[1]))  # float32 k_new
    strided = torch.empty(kn.shape[:-1] + (128,), dtype=torch.bfloat16,
                          device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_append_cuda(*args(strided, good[1]))
    with pytest.raises(ValueError, match="CUDA tensor|different devices"):
        paged_attention_append_cuda(*args(good[0].cpu(), good[1]))
    with pytest.raises(ValueError, match="bool"):
        paged_attention_append_cuda(*args(*good)[:-1], ok.int())
    paged_attention_append_cuda(*args(*good))  # and the good call launches


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q, k, v, bt, ln, cl = _case(8, 4, 2, 16, 4, 2, 3, 2, seed=0)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, bt, ln, cl)]
    with pytest.raises(ValueError):
        paged_attention_cuda(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError):
        paged_attention_cuda(args[0].cpu(), *args[1:])


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda):
    """The reduced olmo-1b engine on the card (kernels) generates the same
    tokens as on the CPU (plain versions) from the same float32 weights,
    and the clock mirror holds on both."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 14, 5)]
    out = []
    for dev in ("cpu", cuda):
        eng = PagedServingEngine(cfg, params, num_pages=10, page_size=4,
                                 max_batch=3, prefill_chunk=8, device=dev)
        reqs = [eng.submit(p, 6) for p in prompts]
        st = eng.run()
        assert st.warnings_fired == int(eng.pool.clock.cpu())
        out.append(([r.generated for r in reqs], st.steps, st.preemptions))
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("C,ppcb,Hq,Hkv,dtype", [(1, 1, 8, 4, "float32"),
                                                 (16, 4, 16, 8, "bfloat16")])
def test_cuda_sharded_attention_matches_plain(cuda, C, ppcb, Hq, Hkv, dtype):
    """Two shards on one card: one launch of the kernel per shard on its KV
    head slab, joined, against the plain version over the whole arena."""
    from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                     paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    q, k, v, bt, ln, cl = _case(32, 4, Hkv, 64, Hq, 4, 6, C, seed=C + Hq,
                                holes=True)
    td = getattr(torch, dtype)
    q, k, v, bt, ln, cl = [torch.from_numpy(a).to(cuda)
                           for a in (q, k, v, bt, ln, cl)]
    q, k, v = (a.to(td) for a in (q, k, v))
    slabs = [[t.contiguous() for t in a.chunk(2, dim=2)] for a in (q, k, v)]
    mesh = make_serving_mesh(2, [cuda, cuda])
    before = paged_attention_sharded.launches
    outs = paged_attention_sharded(*slabs, bt, ln, cl, mesh=mesh,
                                   n_kv_heads=Hkv,
                                   pages_per_compute_block=ppcb)
    assert paged_attention_sharded.launches - before == 2
    want = paged_attention_plain(q, k, v, bt, ln, cl)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert_live_close(torch.cat(outs, dim=2), want, cl, atol=tol)


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_tensors_device(cuda):
    """Both kernels on cuda:1 while cuda:0 is current: each wrapper launches
    in its tensors' device context."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the launch device must differ from the "
                    "current one")
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    dev = torch.device("cuda:1")
    q, k, v, bt, ln, cl = _case(16, 4, 2, 64, 4, 3, 4, 4, seed=11)
    args = [torch.from_numpy(a).to(dev) for a in (q, k, v, bt, ln, cl)]
    with torch.cuda.device(0):
        got = paged_attention_cuda(*args)
        torch.cuda.synchronize(dev)
        assert_live_close(got, paged_attention_plain(*args), args[5],
                          atol=1e-4)
        kn = torch.randn((3, 4, 2, 64), device=dev)
        pages = [args[1].clone(), args[2].clone()]
        ref = [p.clone() for p in pages]
        ok = torch.ones(3, dtype=torch.bool, device=dev)
        kv_append_cuda(*pages, kn, kn, args[3], args[4], args[5], ok)
        kv_append_plain(*ref, kn, kn, args[3], args[4], args[5], ok)
        torch.cuda.synchronize(dev)
        assert all(torch.equal(a, b) for a, b in zip(pages, ref))


@pytest.mark.cuda
def test_cuda_tp2_engine_matches_tp1(cuda):
    """The reduced olmo-1b engine at tensor_parallel=2 with both shards on
    one card generates the tokens of the TP=1 engine (float32 weights)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 14, 5)]
    out = []
    for kw in (dict(device=cuda), dict(tensor_parallel=2,
                                       devices=[cuda, cuda])):
        eng = PagedServingEngine(cfg, params, num_pages=10, page_size=4,
                                 max_batch=3, prefill_chunk=8, **kw)
        reqs = [eng.submit(p, 6) for p in prompts]
        st = eng.run()
        assert st.warnings_fired == int(eng.pool.clock.cpu())
        out.append(([r.generated for r in reqs], st.steps, st.preemptions))
    assert out[0] == out[1]


@pytest.mark.cuda
def test_cuda_fleet_threads_match_cpu_fleet(cuda):
    """Two replicas on one card driven by two threads (``run()``) generate
    the CPU fleet's tokens from the same float32 weights, with the kernel
    launches of every replica step counted (none lost across threads) and
    the clock mirror per replica."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.paged_attention import paged_attention_append_cuda
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import DataParallelEngine
    from repro_torch.serving.runner import ModelRunner

    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 14, 8)]
    out = []
    for dev in ("cpu", cuda):
        fleet = DataParallelEngine(cfg, params, replicas=2,
                                   devices=[dev, dev], num_pages=16,
                                   page_size=4, max_batch=3, prefill_chunk=8)
        reqs = [fleet.submit(p, 6) for p in prompts]
        before = paged_attention_append_cuda.launches
        dry = ModelRunner.dry_steps
        st = fleet.run()
        if dev == cuda:
            # each step's graph replay, and each capture's dry step
            assert paged_attention_append_cuda.launches - before == \
                cfg.n_layers * (st.steps + ModelRunner.dry_steps - dry)
            assert all(e.runner.step_graphs for e in fleet.replicas)
        for e in fleet.replicas:
            assert e.stats.warnings_fired == int(e.pool.clock.cpu())
        out.append(([r.generated for r in reqs], st.steps, st.preemptions))
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("C,Hq", [(1, 8), (16, 8), (1, 4), (16, 4)],
                         ids=["decode_g8", "chunk_g8", "decode_g4", "chunk_g4"])
@pytest.mark.parametrize("qd,kd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16")])
def test_cuda_mqa_head_dim_256(cuda, S, C, Hq, qd, kd):
    """Multi-query attention at head dim 256 (paligemma's decoder: one KV
    head, 8 query heads at TP=1 and 4 per shard at TP=2; at C=16 with 8
    query heads, 128 query slots in two groups of 64): kernel 1 against
    its plain version on the split edge cases, and the fused append bitwise
    the two-launch pair, arena bit-exact against the plain version."""
    _mqa_case(cuda, S, C, Hq, 256, qd, kd, seed=S * 5 + C + Hq)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [None, 2])
@pytest.mark.parametrize("C,Hq", [(1, 48), (16, 48), (1, 24), (16, 24)],
                         ids=["decode_g48", "chunk_g48", "decode_g24",
                              "chunk_g24"])
@pytest.mark.parametrize("qd,kd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16")])
def test_cuda_mqa_granite_head_dim_128(cuda, S, C, Hq, qd, kd):
    """granite-20b's multi-query shape: 48 query heads on one KV head of
    128 (24 a shard at TP=2; at C=16, 768 or 384 query slots in groups of
    64), at the split rule's own count and forced to 2: kernel 1 against
    its plain version on the split edge cases, the fused append bitwise the
    two-launch pair, arena bit-exact against the plain version."""
    _mqa_case(cuda, S, C, Hq, 128, qd, kd, seed=(S or 0) * 5 + C + Hq)


def _mqa_case(cuda, S, C, Hq, D, qd, kd, seed):
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda, paged_attention_plain)
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(S or 2, 16, C, Hq, 1, D, seed=seed)]
    q = q.to(getattr(torch, qd))
    k, v, kn, vn = (a.to(getattr(torch, kd)) for a in (k, v, kn, vn))
    tol = 2e-2 if "bfloat16" in (qd, kd) else 1e-4
    if qd == kd:
        got = paged_attention_cuda(q, k, v, bt, ln, cl, _splits=S)
        want = paged_attention_plain(q, k, v, bt, ln, cl)
        assert_live_close(got, want, cl, atol=tol)
    pair, mine, plain = ([k.clone(), v.clone()] for _ in range(3))
    kv_append_cuda(*pair, kn, vn, bt, ln - cl, cl, ok)
    want = paged_attention_cuda(q, *pair, bt, ln, cl, _splits=S)
    got = paged_attention_append_cuda(q, *mine, kn, vn, bt, ln, cl, ok,
                                      _splits=S)
    ref = paged_attention_append_plain(q, *plain, kn, vn, bt, ln, cl, ok)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(mine, pair))
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    assert_live_close(got, ref, cl, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sharded_attention_over_a_replicated_mqa_arena(cuda, C, dtype):
    """Two shards on one card over a replicated one-head arena at head dim
    256: each shard's launch reads its 4 query heads over its own whole
    copy (appending the same new K/V to it); the joined output equals one
    launch over 8 query heads bit for bit, and both copies equal that
    launch's arena."""
    _replicated_case(cuda, C, 8, 256, dtype, seed=40 + C)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sharded_attention_over_a_replicated_granite_arena(cuda, C,
                                                                dtype):
    """The same over granite-20b's one KV head of 128: 48 query heads, 24 a
    shard (at C=16, 12 query groups of 64 against each shard's 6)."""
    _replicated_case(cuda, C, 48, 128, dtype, seed=60 + C)


def _replicated_case(cuda, C, Hq, D, dtype, seed):
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_plain,
        paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(2, 16, C, Hq, 1, D, seed=seed)]
    td = getattr(torch, dtype)
    q, k, v, kn, vn = (a.to(td) for a in (q, k, v, kn, vn))
    mesh = make_serving_mesh(2, [cuda, cuda])
    qs = [t.contiguous() for t in q.chunk(2, dim=2)]
    copies = [(k.clone(), v.clone()) for _ in range(2)]
    full = [k.clone(), v.clone()]
    want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
    before = paged_attention_sharded.launches
    outs = paged_attention_sharded(
        qs, [c[0] for c in copies], [c[1] for c in copies], bt, ln, cl,
        mesh=mesh, n_kv_heads=2, append=([kn, kn], [vn, vn], ok))
    assert paged_attention_sharded.launches - before == 2
    assert torch.equal(torch.cat(outs, dim=2), want)
    for kc, vc in copies:
        assert torch.equal(kc, full[0]) and torch.equal(vc, full[1])
    plain = paged_attention_plain(q, *full, bt, ln, cl)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert_live_close(want, plain, cl, atol=tol)


@pytest.mark.cuda
def test_cuda_moe_tp2_engine_matches_tp1(cuda):
    """Reduced olmoe-1b-7b and paligemma-3b engines at tensor_parallel=2
    with both shards on one card generate the TP=1 engine's tokens
    (float32 weights), and paligemma's two arena copies stay bitwise
    equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    for arch in ("olmoe-1b-7b", "paligemma-3b"):
        cfg = reduced(get_config(arch))
        params = init_decoder_lm(cfg, seed=4, dtype=torch.float32,
                                 device="cpu")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.integers(3, 14, 5)]
        out = []
        for kw in (dict(device=cuda), dict(tensor_parallel=2,
                                           devices=[cuda, cuda])):
            eng = PagedServingEngine(cfg, params, num_pages=10, page_size=4,
                                     max_batch=3, prefill_chunk=8, **kw)
            reqs = [eng.submit(p, 6) for p in prompts]
            st = eng.run()
            assert st.warnings_fired == int(eng.pool.clock.cpu())
            out.append(([r.generated for r in reqs], st.steps,
                        st.preemptions))
        assert out[0] == out[1], arch
        if cfg.n_kv_heads == 1:
            assert eng.kv_manager.kv_replicated
            assert all(torch.equal(eng.kv[0][n], eng.kv[1][n])
                       for n in ("k", "v"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny",
                                  "recurrentgemma-9b", "mamba2-780m"])
def test_cuda_build_model_prefill_decode_matches_cpu(cuda, arch):
    """One prefill and four greedy decode steps of each family's non-paged
    model (reduced, float32), card against CPU: logits within 1e-3,
    tokens equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(seed=3, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        p = params.placed(dev)
        cache, logits = model.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, 32)
        rows = [logits[:, -1].cpu()]
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((2,), 20, dtype=torch.int32, device=dev)
        for _ in range(4):
            logits, cache = model.decode_step(p, cache, {"token": tok,
                                                         "pos": pos})
            rows.append(logits.cpu())
            tok, pos = logits.argmax(-1).to(torch.int32), pos + 1
        out[str(dev)] = torch.stack(rows)
    cpu, card = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(card, cpu, atol=1e-3, rtol=1e-3)
    assert torch.equal(card.argmax(-1), cpu.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """One ``make_train_step`` step of the reduced model on the card and
    on the CPU from the same float32 weights and batch (float32 both, TF32
    off by default): the metrics within 1e-4 abs/rel, the moments within
    1e-7 + 1e-3|x|, and each parameter's update within 1e-5 where the
    CPU's first moment is above 1e-7 (its gradient above 1e-6, far above
    the summation-order error, so the update's sign agrees) and within
    2 lr elsewhere (AdamW's first step is about lr times the gradient's
    sign, which a near-zero gradient may flip)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    lr = 1e-3
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    runs = []
    for dev in ("cpu", cuda):
        # the same seeded CPU draw each time (the step updates in place)
        params = model.init(seed=3, dtype=torch.float32, device="cpu")
        params = params.placed(dev).requires_grad_(True)
        before = {n: p.detach().cpu().clone()
                  for n, p in params.named_parameters()}
        step = make_train_step(model, AdamWConfig(lr=lr, warmup_steps=1))
        params, state, met = step(params, adamw_init(params), {
            "tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)})
        runs.append(({k: float(v) for k, v in met.items()},
                     {n: p.detach().cpu() - before[n]
                      for n, p in params.named_parameters()},
                     {part: {n: t.cpu() for n, t in state[part].items()}
                      for part in ("m", "v")}))
    (cm, cu, cs), (gm, gu, gs) = runs
    for k in cm:
        np.testing.assert_allclose(gm[k], cm[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    for n in cu:
        for part in ("m", "v"):
            np.testing.assert_allclose(gs[part][n].numpy(),
                                       cs[part][n].numpy(), atol=1e-7,
                                       rtol=1e-3, err_msg=f"{part} {n}")
        d = (gu[n] - cu[n]).abs()
        big = cs["m"][n].abs() > 1e-7
        assert bool((d[big] <= 1e-5).all()), n
        assert bool((d <= 2 * lr).all()), n


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_sharded_attention_on_kv_head_slabs(cuda, C, fused):
    """Hq=8, Hkv=2 over 4 shards on one card (``sharding/rules.py::
    kv_heads``): shards 0-1 on a one-head copy of KV head 0, 2-3 of head
    1, each launch on its 2 query heads (with the fused append into its
    own copy).  Every copy equals its head of one launch over the whole
    arena; the joined output equals that launch's bit for bit (the
    kernel's key order reads no head count: at C=16 the shard tiles 32
    query slots against the whole launch's 64, and sums alike), and the
    plain version within bf16's tolerance."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(2, 16, C, 8, 2, 128, seed=50 + C)]
    q, k, v, kn, vn = (a.to(torch.bfloat16) for a in (q, k, v, kn, vn))
    mesh = make_serving_mesh(4, [cuda] * 4)
    heads = [0, 0, 1, 1]

    def slabs(t):
        return [t[:, :, h:h + 1].contiguous() for h in heads]
    qs = [t.contiguous() for t in q.chunk(4, dim=2)]
    full = [k.clone(), v.clone()]
    copies = [slabs(k), slabs(v)]
    before = paged_attention_sharded.launches
    if fused:
        want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
        outs = paged_attention_sharded(qs, *copies, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=4,
                                       append=(slabs(kn), slabs(vn), ok))
    else:
        want = paged_attention_cuda(q, *full, bt, ln, cl)
        outs = paged_attention_sharded(qs, *copies, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=4)
    assert paged_attention_sharded.launches - before == 4
    assert torch.equal(torch.cat(outs, dim=2), want)
    for c, f in zip(copies, full):
        for s, h in enumerate(heads):
            assert torch.equal(c[s], f[:, :, h:h + 1])
    plain = paged_attention_plain(q, *full, bt, ln, cl)
    assert_live_close(want, plain, cl, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_sharded_attention_on_straddling_slabs(cuda, C, fused):
    """Hq=6, Hkv=3 over 2 shards on one card (``sharding/rules.py::
    query_window``): shard 0 on KV heads 0-1, shard 1 on 1-2, each launch
    on its 3 query heads padded with zero heads to 4 (at offsets 0 and 1),
    with the fused append into its own copy.  The joined output equals
    one launch over the whole arena bit for bit, every copy its heads of
    that launch's arena, and the plain version within bf16's tolerance."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.paged_decode import pad_window, window_heads
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(2, 16, C, 6, 3, 128, seed=60 + C)]
    q, k, v, kn, vn = (a.to(torch.bfloat16) for a in (q, k, v, kn, vn))
    mesh = make_serving_mesh(2, [cuda] * 2)
    heads = [(0, 2), (1, 3)]
    windows = [(0, 4), (1, 4)]

    def slabs(t):
        return [t[:, :, a:b].contiguous() for a, b in heads]
    qs = [pad_window(t.contiguous(), w)
          for t, w in zip(q.chunk(2, dim=2), windows)]
    full = [k.clone(), v.clone()]
    copies = [slabs(k), slabs(v)]
    before = paged_attention_cuda.launches
    if fused:
        want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
        before = paged_attention_cuda.launches
        outs = paged_attention_sharded(qs, *copies, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=4,
                                       append=(slabs(kn), slabs(vn), ok))
    else:
        want = paged_attention_cuda(q, *full, bt, ln, cl)
        before = paged_attention_cuda.launches
        outs = paged_attention_sharded(qs, *copies, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=4)
    assert paged_attention_cuda.launches - before == 2
    outs = [window_heads(o, w, 3) for o, w in zip(outs, windows)]
    assert torch.equal(torch.cat(outs, dim=2), want)
    for c, f in zip(copies, full):
        for s, (a, b) in enumerate(heads):
            assert torch.equal(c[s], f[:, :, a:b])
    plain = paged_attention_plain(q, *full, bt, ln, cl)
    assert_live_close(want, plain, cl, atol=2e-2)


@pytest.mark.cuda
def test_cuda_straddling_tp2_engine_matches_cpu(cuda):
    """Reduced olmo-1b with Hq=6, Hkv=3 at tensor_parallel=2, both shards
    on one card (through its step graphs), generates the tokens of the
    same engine on the CPU from float32 weights; the joined arena agrees
    within the bf16 arena's rounding, and the head both shards hold is
    bitwise the same in both copies."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), n_heads=6,
                              n_kv_heads=3)
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 14, 5)]
    out = []
    for dev in ("cpu", cuda):
        eng = PagedServingEngine(cfg, params, tensor_parallel=2,
                                 devices=[dev, dev], num_pages=16,
                                 page_size=4, max_batch=3, prefill_chunk=8)
        reqs = [eng.submit(p, 6) for p in prompts]
        st = eng.run()
        assert st.warnings_fired == int(eng.pool.clock.cpu())
        for n in ("k", "v"):
            assert torch.equal(eng.kv[0][n][:, :, :, 1],
                               eng.kv[1][n][:, :, :, 0])
        out.append(([r.generated for r in reqs],
                    {n: t.float().cpu() for n, t in
                     eng.kv_manager.gather_kv().items()}))
    assert out[0][0] == out[1][0]
    for n in ("k", "v"):
        torch.testing.assert_close(out[1][1][n], out[0][1][n], atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_cuda_expert_parallel_engine_matches_cpu(cuda, monkeypatch):
    """Reduced olmoe-1b-7b at tensor_parallel=2 under
    ``REPRO_MOE_SHARD=ep`` (4 whole experts a shard), both shards on one
    card, generates the CPU engine's tokens under the same layout (float32
    weights), with the same steps and preemptions."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = reduced(get_config("olmoe-1b-7b"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 14, 5)]
    out = []
    for dev in (cuda, "cpu"):
        monkeypatch.setenv("REPRO_MOE_SHARD", "ep")
        eng = PagedServingEngine(cfg, params, num_pages=10, page_size=4,
                                 max_batch=3, prefill_chunk=8,
                                 tensor_parallel=2, devices=[dev, dev])
        monkeypatch.delenv("REPRO_MOE_SHARD")
        assert eng.params[0].blocks[0].moe["w_gate"].shape[0] == \
            cfg.n_experts // 2
        reqs = [eng.submit(p, 6) for p in prompts]
        st = eng.run()
        assert st.warnings_fired == int(eng.pool.clock.cpu())
        out.append(([r.generated for r in reqs], st.steps, st.preemptions))
    assert out[0] == out[1]


@pytest.mark.cuda
def test_cuda_sharded_step_at_world_size_one(cuda):
    """``launch/steps.py::sharded`` on the card: a (1, 1) mesh over NCCL
    (one rank: a card cannot hold two), reduced olmo-1b in float32 with
    TF32 off; the loss and every gradient equal the unsharded step's
    within 1e-4 abs/rel (the CPU tests' tolerance on their 8-rank
    worlds)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.launch.steps import sharded, step_specs
    from repro_torch.models import build_model
    from torch_world import free_port

    cfg = reduced(get_config("olmo-1b"))
    model = build_model(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), device=cuda,
                                     generator=torch.Generator(
                                         device=cuda).manual_seed(1))}

    def loss_grads(params, batch):
        loss, _ = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rank=0, world_size=1, device_type="cuda",
                     port=free_port())
    try:
        want, want_g = loss_grads(
            model.init(0, torch.float32, cuda).requires_grad_(True), batch)
        mesh = make_device_mesh((1, 1), device_type="cuda")
        params = model.init(0, torch.float32, cuda).requires_grad_(True)
        ins, _ = step_specs(cfg, "train", mesh, params, batch)
        got, got_g = sharded(loss_grads, mesh, (ins[0], ins[2]),
                             (None, None))(params, batch)
        tol = dict(atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got.to_local(), want, **tol)
        for n, g in want_g.items():
            torch.testing.assert_close(got_g[n].to_local(), g, **tol,
                                       msg=lambda m: f"{n}: {m}")
    finally:
        dist.destroy_process_group()
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _graph_engine(cuda, case, graphs, **extra):
    """A reduced engine of :data:`GRAPH_CASES` ``case``, stepping through
    captured graphs or eagerly."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    c = GRAPH_CASES[case]
    cfg = reduced(get_config(c.get("arch", "olmo-1b")))
    params = init_decoder_lm(cfg, seed=4, dtype=getattr(torch, c["dtype"]),
                             device="cpu")
    where = (dict(tensor_parallel=2, devices=[cuda, cuda])
             if c.get("tp") else dict(device=cuda))
    eng = PagedServingEngine(cfg, params, **where, **{**c["kw"], **extra})
    assert eng.runner.graphs  # the card's default
    eng.runner.graphs = graphs
    return cfg, eng


def _engine_state(eng):
    """Everything a step writes, cloned: the per-slot arrays, the pool's
    tensors and every shard's arena."""
    from repro_torch.core.pagepool import PagePool

    kvm = eng.kv_manager
    out = {"block_tables": kvm._bt, "snapshot": kvm._snap,
           "lengths": kvm._len, "last_tok": kvm._last}
    out.update({f"pool.{f}": t for f, t in zip(PagePool._fields, eng.pool)})
    kvs = eng.kv if isinstance(eng.kv, list) else [eng.kv]
    out.update({f"kv{s}.{n}": kv[n] for s, kv in enumerate(kvs)
                for n in ("k", "v")})
    return {k: v.clone() for k, v in out.items()}


_PAGED = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=8)
#: reduced engines the captured step is held against the eager one on
GRAPH_CASES = {
    "float32": dict(dtype="float32", kw=_PAGED),
    "bfloat16": dict(dtype="bfloat16", kw=_PAGED),
    "tp2": dict(dtype="float32", tp=True, kw=_PAGED),
    "moe": dict(dtype="float32", arch="olmoe-1b-7b", kw=_PAGED),
    "mqa_tp2": dict(dtype="bfloat16", arch="paligemma-3b", tp=True,
                    kw=_PAGED),
    "tight_pool": dict(dtype="float32", kw=dict(
        num_pages=8, page_size=4, max_batch=3, prefill_chunk=8)),
    "speculative": dict(dtype="float32", kw=dict(
        num_pages=32, page_size=4, max_batch=3, speculative_k=4)),
    "prefix_cache": dict(dtype="float32", kw=dict(
        _PAGED, num_pages=24, prefix_cache=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_cuda_graph_engine_matches_eager(cuda, case):
    """The engine stepping through captured CUDA graphs against the same
    engine stepping eagerly: tokens, counters, block tables, snapshots,
    lengths, last tokens, the pool and the arena bitwise equal, every
    step a replay, and each replay's recorded fused launches layers x
    shards."""
    import dataclasses

    from repro_torch.kernels.paged_attention import paged_attention_append_cuda

    runs = []
    for graphs in (False, True):
        cfg, eng = _graph_engine(cuda, case, graphs)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.integers(3, 14, 5)]
        if case == "prefix_cache":
            prompts = [prompts[0], prompts[0], prompts[0] + prompts[1]]
        reqs = [eng.submit(p, 8) for p in prompts]
        st = eng.run()
        assert all(r.state == "finished" for r in reqs)
        assert st.warnings_fired == int(eng.pool.clock.cpu())
        runs.append(([r.generated for r in reqs],
                     {f.name: getattr(st, f.name)
                      for f in dataclasses.fields(st)
                      if f.type in ("int", int)},
                     _engine_state(eng)))
    (tok0, st0, state0), (tok1, st1, state1) = runs
    assert tok1 == tok0 and st1 == st0
    for k in state0:
        assert torch.equal(state0[k], state1[k]), k
    graphs = eng.runner.step_graphs.values()
    assert sum(g.replays for g in graphs) == st1["steps"] > 0
    shards = 2 if GRAPH_CASES[case].get("tp") else 1
    assert all(g.launches[paged_attention_append_cuda]
               == cfg.n_layers * shards for g in graphs)
    if case == "speculative":
        assert any(k[1] for k in eng.runner.step_graphs)


@pytest.mark.cuda
def test_cuda_sampled_graph_engine_repeats_itself(cuda):
    """A sampling engine on graphs (the runner's generator registered with
    each graph) draws the same tokens in two runs from one seed."""
    out = []
    for _ in range(2):
        cfg, eng = _graph_engine(cuda, "float32", True, greedy=False,
                                 temperature=0.8, seed=3)
        rng = np.random.default_rng(4)
        reqs = [eng.submit(rng.integers(0, cfg.vocab, int(n)).tolist(), 8)
                for n in rng.integers(3, 14, 5)]
        eng.run()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]
    assert len({t for g in out[0] for t in g}) > 1


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda, monkeypatch):
    """A step that cannot be captured (here a host read inside it) raises
    from the engine; nothing falls back to the eager step."""
    from repro_torch.serving import runner as runner_mod

    step = runner_mod.fused_decode_step

    def reads_back(*a, **kw):
        out = step(*a, **kw)
        out[6].sum().item()  # a device->host read: forbidden in a capture
        return out
    monkeypatch.setattr(runner_mod, "fused_decode_step", reads_back)
    cfg, eng = _graph_engine(cuda, "float32", True)
    eng.submit(list(range(1, 6)), 4)
    with pytest.raises(RuntimeError):
        eng.run()
    assert not eng.runner.step_graphs and eng.stats.steps == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_capture_stream_tickets_lie_outside_the_graph_pool(cuda):
    """Kernel 1's split-merge tickets of the runner's graphs (the
    runner's own buffer) are reserved before capture, in ordinary device
    memory, not in the pool the runner's graphs share; and they read zero
    after the replays."""
    import importlib

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    # 1024 pages of 4 tokens at head dim 16: rows split 4 ways, so every
    # launch merges through the tickets
    cfg, eng = _graph_engine(cuda, "float32", True, num_pages=1024)
    assert pa.row_splits(1024, cfg.head_dim, 4) > 1
    rng = np.random.default_rng(4)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, int(n)).tolist(), 8)
            for n in rng.integers(3, 14, 5)]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    runner = eng.runner
    assert len(runner.step_graphs) >= 2
    buf = runner._tickets
    assert buf is not None
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(buf).cpu()) == 0
    seg = [s for s in torch.cuda.memory_snapshot()
           if s["address"] <= buf.data_ptr() < s["address"] + s["total_size"]]
    assert len(seg) == 1
    assert tuple(seg[0]["segment_pool_id"]) != tuple(runner._mempool)
    assert any(tuple(s["segment_pool_id"]) == tuple(runner._mempool)
               for s in torch.cuda.memory_snapshot())


#: reduced non-paged models whose captured decode step is held against the
#: eager one on the card
DECODE_GRAPH_ARCHS = ["olmo-1b", "olmoe-1b-7b", "whisper-tiny",
                      "recurrentgemma-9b", "mamba2-780m"]


def _prefilled(cuda, arch, seed=3, dtype=torch.float32):
    """A reduced ``build_model`` on the card, seeded ``dtype`` weights and
    a prefill of 2 rows of 20 tokens into 32 slots: (model, weights,
    cache, the next tokens)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(seed=3, dtype=dtype, device=cuda)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)).to(cuda)}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(cuda)
    cache, logits = model.prefill(params, batch, 32)
    return model, params, cache, logits[:, -1].argmax(-1).to(torch.int32)


@contextlib.contextmanager
def _no_host_reads():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DECODE_GRAPH_ARCHS)
def test_cuda_graph_decode_step_matches_eager(cuda, arch):
    """``graph_decode_step`` against the eager ``decode_step`` from one
    prefill (its cache cloned), float32, 6 greedy steps: logits, tokens
    and every cache leaf bitwise; one key, every call a replay of it, and
    no kernel of the repository recorded."""
    from repro_torch.models import graph_decode_step

    model, params, cache, tok = _prefilled(cuda, arch)
    gcache = {k: v.clone() for k, v in cache.items()}
    step = graph_decode_step(model)
    gtok = tok.clone()
    pos = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    for i in range(6):
        logits, cache = model.decode_step(params, cache,
                                          {"token": tok, "pos": pos})
        glogits, gcache = step(params, gcache, {"token": gtok, "pos": pos})
        assert torch.equal(glogits, logits), i
        tok = logits.argmax(-1).to(torch.int32)
        gtok = glogits.argmax(-1).to(torch.int32)
        pos = pos + 1
    assert set(gcache) == set(cache)
    for k in cache:
        assert torch.equal(gcache[k], cache[k]), k
    (g,) = step.graphs.values()
    assert g.replays == 6 and not g.launches


@pytest.mark.cuda
def test_cuda_graph_decode_replay_reads_nothing_back(cuda):
    """No call makes a device->host transfer (sync debug mode "error"):
    the capturing one (its warm-up step and the recording), replays of
    the returned cache, and a second prefill's cache copied into the
    static buffers."""
    from repro_torch.models import graph_decode_step

    model, params, cache, tok = _prefilled(cuda, "olmo-1b",
                                           dtype=torch.bfloat16)
    _, _, other, tok2 = _prefilled(cuda, "olmo-1b", seed=4,
                                   dtype=torch.bfloat16)
    want, _ = model.decode_step(params, {k: v.clone() for k, v in
                                         other.items()},
                                {"token": tok2, "pos": torch.full(
                                    (2,), 20, dtype=torch.int32,
                                    device=cuda)})
    step = graph_decode_step(model)
    pos = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    with _no_host_reads():
        logits, cache = step(params, cache, {"token": tok, "pos": pos})
        for _ in range(3):
            pos = pos + 1
            logits, cache = step(params, cache, {
                "token": logits.argmax(-1).to(torch.int32), "pos": pos})
        got, _ = step(params, other, {"token": tok2, "pos": torch.full(
            (2,), 20, dtype=torch.int32, device=cuda)})
    assert torch.equal(got, want)
    (g,) = step.graphs.values()
    assert g.replays == 5


@pytest.mark.cuda
def test_cuda_graph_decode_failed_capture_raises(cuda):
    """A decode step that cannot be captured (here a host read inside it)
    raises; nothing falls back to the eager step and no key is kept."""
    import dataclasses

    from repro_torch.models import graph_decode_step

    model, params, cache, tok = _prefilled(cuda, "olmo-1b")

    def reads_back(p, c, b):
        out = model.decode_step(p, c, b)
        out[0].sum().item()  # a device->host read: forbidden in a capture
        return out
    step = graph_decode_step(dataclasses.replace(model,
                                                 decode_step=reads_back))
    with pytest.raises(RuntimeError):
        step(params, cache, {"token": tok, "pos": torch.full(
            (2,), 20, dtype=torch.int32, device=cuda)})
    assert not step.graphs
    torch.cuda.synchronize()
