"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with that
reason elsewhere; the file imports no jax, so it runs on a machine that
has only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerance: float32 1e-4 abs (summation order); bfloat16 2e-2 abs (outputs
may round to a neighbouring bf16 value); the KV append is bit-exact, and
the fused append + attention launch is bitwise the two-launch pair.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kv_append import kv_append_plain
from split_cases import append_edge_case, split_edge_case

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
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


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
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
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
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


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
    torch.testing.assert_close(torch.cat(outs, dim=2).float(), want.float(),
                               atol=tol, rtol=0)


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
        torch.testing.assert_close(got, paged_attention_plain(*args),
                                   atol=1e-4, rtol=0)
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
        st = fleet.run()
        if dev == cuda:
            assert paged_attention_append_cuda.launches - before == \
                cfg.n_layers * st.steps
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
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda, paged_attention_plain)
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(S, 16, C, Hq, 1, 256, seed=S * 5 + C + Hq)]
    q = q.to(getattr(torch, qd))
    k, v, kn, vn = (a.to(getattr(torch, kd)) for a in (k, v, kn, vn))
    tol = 2e-2 if "bfloat16" in (qd, kd) else 1e-4
    if qd == kd:
        got = paged_attention_cuda(q, k, v, bt, ln, cl, _splits=S)
        want = paged_attention_plain(q, k, v, bt, ln, cl)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
    pair, mine, plain = ([k.clone(), v.clone()] for _ in range(3))
    kv_append_cuda(*pair, kn, vn, bt, ln - cl, cl, ok)
    want = paged_attention_cuda(q, *pair, bt, ln, cl, _splits=S)
    got = paged_attention_append_cuda(q, *mine, kn, vn, bt, ln, cl, ok,
                                      _splits=S)
    ref = paged_attention_append_plain(q, *plain, kn, vn, bt, ln, cl, ok)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(mine, pair))
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sharded_attention_over_a_replicated_mqa_arena(cuda, C, dtype):
    """Two shards on one card over a replicated one-head arena at head dim
    256: each shard's launch reads its 4 query heads over its own whole
    copy (appending the same new K/V to it); the joined output equals one
    launch over 8 query heads bit for bit, and both copies equal that
    launch's arena."""
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_plain,
        paged_attention_sharded)
    from repro_torch.launch.mesh import make_serving_mesh
    q, k, v, kn, vn, bt, ln, cl, ok = [
        torch.from_numpy(a).to(cuda) for a in
        append_edge_case(2, 16, C, 8, 1, 256, seed=40 + C)]
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
    torch.testing.assert_close(want.float(), plain.float(), atol=tol, rtol=0)


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
