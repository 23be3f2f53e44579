"""The sliding window of kernel 1 and the token-major expert layer, on the
card, at trinity-mini's widths.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with that
reason elsewhere; the file imports no jax: ``python -m pytest
tests/test_torch_cuda_afmoe.py -m cuda``.

- Kernel 1 with a window (32 query heads on 4 KV heads of 128, W = 2048,
  rows of 1k to 17k tokens, C = 1 and C = 32, plain and with the fused
  append) against its plain version with the same window: bfloat16 2e-2
  abs, as ``test_torch_cuda.py`` holds the kernel (outputs may round to a
  neighbouring bf16 value); the appended arena bit-exact.  Every page
  wholly before the chunk's first window start holds NaN: a launch that
  read one would give NaN (a masked key's probability is 0, and 0 · NaN
  is NaN in the P·V product).  A window longer than every row is the
  launch without one, bit for bit.
- Kernel 1 at trinity-mini's mixed [64, 32] step (32 query heads on 4 KV
  heads of 128, W = 0 and 2048, rows of 1k to 17k tokens, half decoding
  one token and the rest ragged chunks up to 32): the live query slots
  within 2e-2 of the plain version and each row's within a tenth of its
  live RMS (``split_cases.LIVE_RMS_SHARE``: 2e-2 is about the RMS of a
  row of 7k keys), every padded slot exactly zero (the kernel's header
  note, point 8), and per-shard launches over head slabs bitwise the
  whole launch.
- The token-major expert layer against the capacity-bounded layout at
  capacity S·k (the former serving layout), at E = 128 (trinity-mini's
  sigmoid router with selection bias and shared expert) and E = 64
  (olmoe-1b-7b's softmax router), bf16: within 2e-2 relative (each
  product's bf16 output rounding; the same assignments, the same gates),
  dead tokens 0, and a captured graph's replay bitwise the eager call.
"""

import numpy as np
import pytest
import torch

from split_cases import LIVE_RMS_SHARE, assert_live_close, live_share

torch.set_num_threads(1)

HQ, HKV, D, PAGE, W = 32, 4, 128, 16, 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _window_case(C, lens, seed):
    """An arena holding rows of ``lens`` tokens (the chunk's C among them)
    on shuffled pages, and the pages wholly before each row's first
    window start (len − cl + 1 − W)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    maxp = -(-max(lens) // PAGE)
    P = sum(-(-n // PAGE) for n in lens) + 3
    perm = rng.permutation(P)
    bt = np.full((B, maxp), -1, np.int32)
    dead = []
    used = 0
    for b, n in enumerate(lens):
        k = -(-n // PAGE)
        bt[b, :k] = perm[used:used + k]
        used += k
        lo = n - C + 1 - W
        dead += bt[b, :max(lo, 0) // PAGE].tolist()
    k = rng.standard_normal((P, PAGE, HKV, D)).astype(np.float32)
    v = rng.standard_normal((P, PAGE, HKV, D)).astype(np.float32)
    q = rng.standard_normal((B, C, HQ, D)).astype(np.float32)
    new = rng.standard_normal((2, B, C, HKV, D)).astype(np.float32)
    return (q, k, v, bt, np.asarray(lens, np.int32),
            np.full((B,), C, np.int32), new, dead)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 32])
@pytest.mark.parametrize("append", [False, True], ids=["attend", "append"])
def test_cuda_window_matches_plain_and_skips_dead_pages(cuda, C, append):
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda, paged_attention_plain)
    q, k, v, bt, ln, cl, new, dead = _window_case(
        C, [1000, 2100, 4097, 9000, 17000], seed=C + 7 * append)
    assert dead
    bf = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(bf) for a in (q, k, v))
    tbt, tln, tcl = (torch.from_numpy(a) for a in (bt, ln, cl))
    kn, vn = (torch.from_numpy(a).to(bf) for a in new)
    ok = torch.ones(len(ln), dtype=torch.bool)
    # the kernel's arena: every dead page NaN
    gk, gv = tk.clone(), tv.clone()
    gk[dead] = float("nan")
    gv[dead] = float("nan")
    gk, gv = gk.to(cuda), gv.to(cuda)
    dev = [t.to(cuda) for t in (tq, tbt, tln, tcl)]
    if append:
        want = paged_attention_append_plain(tq, tk, tv, kn, vn, tbt, tln,
                                            tcl, ok, window=W)
        got = paged_attention_append_cuda(
            dev[0], gk, gv, kn.to(cuda), vn.to(cuda), *dev[1:],
            ok.to(cuda), window=W)
        live = [p for p in range(tk.shape[0]) if p not in set(dead)]
        assert torch.equal(gk[live].cpu(), tk[live])
        assert torch.equal(gv[live].cpu(), tv[live])
    else:
        want = paged_attention_plain(tq, tk, tv, tbt, tln, tcl, window=W)
        got = paged_attention_cuda(dev[0], gk, gv, *dev[1:], window=W)
    got = got.cpu().float()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), atol=2e-2)
    # the window really cut: without it the output is another one
    full = paged_attention_plain(tq, tk, tv, tbt, tln, tcl)
    assert not torch.allclose(full.float(), want.float(), atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 32])
def test_cuda_window_longer_than_every_row_is_no_window(cuda, C):
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q, k, v, bt, ln, cl, _, _ = _window_case(C, [700, 1500, 3000], seed=3)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v)]
    args = [a.to(torch.bfloat16) for a in args] + [
        torch.from_numpy(a).to(cuda) for a in (bt, ln, cl)]
    a = paged_attention_cuda(*args)
    b = paged_attention_cuda(*args, window=4096)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _mixed_step(W, seed, cuda):
    """Kernel 1's inputs in trinity-mini's mixed [64, 32] step: 64 rows of
    1k-17k tokens on shuffled pages, the even rows decoding (chunk length
    1), the odd ones prefilling ragged chunks of 2-32 (row 1 a whole
    one); bf16, on the card."""
    B, C = 64, 32
    rng = np.random.default_rng(seed)
    lens = rng.integers(1000, 17001, B)
    cl = np.where(np.arange(B) % 2 == 0, 1, rng.integers(2, C + 1, B))
    cl[1] = C
    pages = -(-lens // PAGE)
    P = int(pages.sum()) + 3
    perm = rng.permutation(P)
    bt = np.full((B, int(pages.max())), -1, np.int32)
    for b, (n, at) in enumerate(zip(pages, np.cumsum(pages) - pages)):
        bt[b, :n] = perm[at:at + n]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for shape in ((B, C, HQ, D), (P, PAGE, HKV, D),
                             (P, PAGE, HKV, D)))
    ints = [torch.as_tensor(a.astype(np.int32), device=cuda)
            for a in (bt, lens, cl)]
    return [q, k, v] + ints


@pytest.mark.cuda
@pytest.mark.parametrize("W", [0, W])
def test_cuda_mixed_step_computes_only_live_slots(cuda, W):
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    q, k, v, bt, ln, cl = _mixed_step(W, seed=33 + W, cuda=cuda)
    got = paged_attention_cuda(q, k, v, bt, ln, cl, window=W)
    # the plain version 8 rows at a time (a row's output reads only it)
    want = torch.cat([paged_attention_plain(
        q[i:i + 8], k, v, bt[i:i + 8], ln[i:i + 8], cl[i:i + 8], window=W)
        for i in range(0, q.shape[0], 8)])
    assert_live_close(got, want, cl, atol=2e-2)
    assert live_share(got, want, cl) <= LIVE_RMS_SHARE
    for tp in (2, 4):
        outs = [paged_attention_cuda(*(t.contiguous() for t in sl), bt, ln,
                                     cl, window=W)
                for sl in zip(*(a.chunk(tp, dim=2) for a in (q, k, v)))]
        assert torch.equal(torch.cat(outs, dim=2), got)


def _moe_case(arch, B, S, seed, cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe

    cfg = get_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = init_moe(cfg, gen, dtype=torch.bfloat16, device=cuda)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    return cfg, p, x


def _padded(cfg, x, p):
    """The capacity-bounded layout at capacity S·k: the former serving
    path's function, routed by the same router."""
    from repro_torch.models import moe

    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe.moe_capacity(cfg, S, dropless=True)
    _, gate, expert = moe._route(cfg, x, p["w_router"], p.get("router_bias"))
    _, _, pos, local, keep = moe._slots(cfg, expert, C, E, 0)
    out = moe._experts(moe._dispatch(x, local, pos, keep, E, C, k), p)
    y = moe._combine(out, local, pos, keep, gate, C)
    return y + moe._shared(x, p) if "ws_gate" in p else y


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["trinity-mini", "olmoe-1b-7b"])
def test_cuda_token_major_matches_padded(cuda, arch):
    from repro_torch.models import moe

    cfg, p, x = _moe_case(arch, 8, 32, seed=11, cuda=cuda)
    tm, _ = moe._moe_group_token_major(cfg, x, p)
    pad = _padded(cfg, x, p)
    scale = pad.float().abs().max().item()
    torch.testing.assert_close(tm.float(), pad.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    # the serving path's call takes this layout
    assert moe.token_major(x, True)
    assert torch.equal(moe.moe_apply(cfg, x, p, dropless=True)[0], tm)


@pytest.mark.cuda
def test_cuda_token_major_dead_tokens_and_graph_replay(cuda):
    from repro_torch.models import moe

    cfg, p, x = _moe_case("trinity-mini", 64, 32, seed=5, cuda=cuda)
    # a generator of its own: a failed capture earlier in the session
    # (test_torch_cuda.py's failed-capture tests) leaves the default CUDA
    # generator refusing draws outside a capture
    gen = torch.Generator(device=cuda).manual_seed(6)
    live = (torch.arange(32, device=cuda)[None, :]
            < torch.randint(1, 33, (64, 1), device=cuda, generator=gen))
    eager, _ = moe._moe_group_token_major(cfg, x, p, live=live)
    alone, _ = moe._moe_group_token_major(cfg, x, p)
    assert (eager[~live] == 0).all()
    torch.testing.assert_close(eager[live].float(), alone[live].float(),
                               rtol=2e-2, atol=2e-2 * alone.float().abs()
                               .max().item())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe._moe_group_token_major(cfg, x, p, live=live)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _ = moe._moe_group_token_major(cfg, x, p, live=live)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_trinity_tiny_engine_matches_cpu(cuda):
    """The tiny trinity-mini engine on the card generates the CPU engine's
    tokens (float32 weights; the card's expert layer then takes the
    capacity-bounded layout, its attention the windowed kernel)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = reduced(get_config("trinity-mini"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 500, n).tolist() for n in (13, 29, 7, 21)]
    out = []
    for dev in ("cpu", cuda):
        eng = PagedServingEngine(cfg, params, num_pages=96, page_size=4,
                                 max_batch=4, prefill_chunk=4,
                                 max_pages_per_seq=16, device=dev)
        reqs = [eng.submit(p, 12) for p in prompts]
        eng.run()
        out.append([r.generated for r in reqs])
    assert out[0] == out[1]

