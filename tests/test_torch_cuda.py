"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with that
reason elsewhere; the file imports no jax, so it runs on a machine that
has only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerance: float32 1e-4 abs (summation order); bfloat16 2e-2 abs (outputs
may round to a neighbouring bf16 value); the KV append is bit-exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kv_append import kv_append_plain

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
