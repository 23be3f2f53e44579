"""trinity-mini (family ``afmoe``) on the CPU: the paged serving path against
the benchmark's plain float32 reference, the sliding window of kernel 1's
plain version, and the token-major expert layer.

The tiny preset (``configs.reduced``: 5 layers, three sliding and one
full attention layer then a sliding one, the first layer dense, 8 experts
top-2 with a selection bias and a shared expert) serves with a window of 8
over pages of 4 tokens, so every window crosses pages.  Weights: the
benchmark family's own seeded draw (``bench/families/afmoe.py``), in
float32, which the program and the reference both read.

Tolerances, each with its reason:

- paged logits against the reference: 2e-5 abs, float32 on both sides
  with logits of order 1; only the order of summation differs (blocked
  attention, grouped expert products, the split of a prompt into chunks);
- the windowed plain kernel against dense masked attention: 1e-5 abs,
  float32 softmax over the same keys in another order;
- the token-major expert layer against the capacity-bounded one: 1e-5
  abs in float32 (the same assignments and gates; the products summed in
  another order).
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import PORT_ARCH_IDS, get_config, reduced
from repro_torch.kernels.ops import paged_attention
from repro_torch.models import moe
from repro_torch.models.transformer import DecoderLM, unembed
from repro_torch.serving import PagedServingEngine
from repro_torch.serving.paged_decode import (_chunk_core, kv_storage_init,
                                              paged_decode_step)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PAGE, WINDOW = 4, 8


def _family():
    from bench.cells import load_family

    return load_family(REPO, "afmoe")


def _tiny_raw() -> dict:
    """The benchmark's trinity-mini configuration file at the tiny
    preset's sizes."""
    raw = json.loads((REPO / "bench" / "configs" / "trinity-mini.json")
                     .read_text())
    tiny = reduced(get_config("trinity-mini"))
    raw.update(name="tiny-afmoe", hidden_size=tiny.d_model,
               num_attention_heads=tiny.n_heads,
               num_key_value_heads=tiny.n_kv_heads, head_dim=tiny.head_dim,
               intermediate_size=tiny.dense_ff,
               moe_intermediate_size=tiny.d_ff, num_experts=tiny.n_experts,
               num_experts_per_tok=tiny.top_k,
               num_dense_layers=tiny.dense_layers,
               num_hidden_layers=tiny.n_layers,
               sliding_window=tiny.attn_window, vocab_size=tiny.vocab,
               layer_types=list(tiny.layer_types),
               assumed={"init_std": 0.08, "norm_scale_std": 0.1,
                        "router_bias_std": 0.02})
    return raw


@pytest.fixture(scope="module")
def tiny():
    """(family, spec, program config, float32 weights)."""
    fam = _family()
    spec = fam.spec(_tiny_raw())
    return fam, spec, fam.program_config(spec), fam.weights(
        spec, 2**31 + 17, "cpu", dtype=torch.float32)


def test_the_tiny_preset_keeps_every_kind_of_layer():
    full = get_config("trinity-mini")
    assert "trinity-mini" in PORT_ARCH_IDS
    tiny = reduced(full)
    assert tiny.attn_window == WINDOW and WINDOW > PAGE
    assert {tiny.window_at(l) > 0 for l in range(tiny.n_layers)} == {
        True, False}
    assert [tiny.rope_at(l) for l in range(tiny.n_layers)] == [
        t == "sliding_attention" for t in tiny.layer_types]
    assert {tiny.moe_at(l) for l in range(tiny.n_layers)} == {True, False}
    cut = {"n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
           "d_ff", "vocab", "vocab_padded", "n_experts", "top_k",
           "layer_types", "attn_window", "dense_layers", "dense_ff",
           "shared_ff", "attn_chunk", "loss_chunk", "max_seq", "rnn_width"}
    for f in dataclasses.fields(full):
        if f.name not in cut:
            assert getattr(tiny, f.name) == getattr(full, f.name), f.name


def test_the_family_config_is_the_registered_one(tiny):
    """The benchmark's program config of the published sizes is the port's
    own ``trinity-mini``, field for field."""
    fam = tiny[0]
    raw = json.loads((REPO / "bench" / "configs" / "trinity-mini.json")
                     .read_text())
    assert fam.program_config(fam.spec(raw)) == get_config("trinity-mini")


def _paged_logits(cfg, model, seq, prompt_len, chunk=4):
    """Logits at every position of ``seq`` from the paged step: the prompt
    in chunks of ``chunk`` (``_chunk_core``), then one decode step a token
    (``paged_decode_step``), through a KV arena on shuffled pages."""
    n_pages = -(-len(seq) // PAGE)
    kv = kv_storage_init(cfg, n_pages + 3, PAGE, dtype=torch.float32,
                         device="cpu")
    perm = torch.randperm(n_pages + 3, generator=torch.Generator()
                          .manual_seed(1))[:n_pages]
    bt = perm.to(torch.int32)[None, :]
    out = []
    toks = torch.tensor(seq)[None, :]
    for j in range(0, prompt_len, chunk):
        n = min(chunk, prompt_len - j)
        piece = torch.zeros((1, chunk), dtype=torch.int64)
        piece[0, :n] = toks[0, j:j + n]
        x, kv = _chunk_core(model, kv, bt, torch.tensor([j], dtype=torch.int32),
                            piece, torch.tensor([n]), cfg=cfg)
        out.append(unembed(cfg, model, x)[0, :n].float())
    for j in range(prompt_len, len(seq)):
        logits, kv = paged_decode_step(
            model, kv, bt, torch.tensor([j], dtype=torch.int32),
            toks[:, j], cfg=cfg)
        out.append(logits)
    return torch.cat(out)


def test_paged_prefill_then_decode_matches_the_reference(tiny):
    fam, spec, cfg, params = tiny
    model = DecoderLM(cfg, params)
    rng = np.random.default_rng(3)
    seq = rng.integers(2, spec.vocab - 1, 27).tolist()
    got = _paged_logits(cfg, model, seq, prompt_len=19)
    want = fam.forward_logits(spec, params, seq)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    # the window matters: attending every key gives other logits
    wide = dataclasses.replace(spec, window=10**6)
    assert not torch.allclose(fam.forward_logits(wide, params, seq), want,
                              atol=1e-3)


def test_the_engine_serves_the_reference_argmax(tiny):
    """Prefill then decode through ``PagedServingEngine`` (chunks of 4,
    several rows at once): every served token is the reference's argmax
    at its position, teacher-forced, or lies within 0.02 of it: the
    engine's KV arena is bf16 whatever the weights' dtype, and K and V
    rounded to bf16 move these logits by up to ~5e-3 (a near tie then
    flips); nearly every token is the argmax itself."""
    fam, spec, cfg, params = tiny
    eng = PagedServingEngine(cfg, params, num_pages=64, page_size=PAGE,
                             max_batch=3, prefill_chunk=4,
                             max_pages_per_seq=16, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, spec.vocab - 1, n).tolist()
               for n in (13, 22, 9)]
    reqs = [eng.submit(p, 11) for p in prompts]
    eng.run()
    off = 0
    for p, r in zip(prompts, reqs):
        assert r.state == "finished" and len(r.generated) == 11
        ref = fam.forward_logits(spec, params, p + r.generated[:-1])
        rows = ref[len(p) - 1:]
        picked = rows.gather(1, torch.tensor(r.generated)[:, None])[:, 0]
        gaps = rows.max(1).values - picked
        assert gaps.max() <= 0.02
        off += int((gaps > 0).sum())
    assert off <= 2


@pytest.mark.parametrize("num_pages", [64, 12])
def test_window_dead_pages_and_rows_are_counted(tiny, num_pages):
    """``engine.step``'s counters: the KV ones over the rows live after the
    step; ``rows``, the rows the step advanced.  At 12 pages the two rows
    outgrow the pool, so some step holds a row it does not advance, and a
    row the step advanced may then be preempted for the starved one (its
    committed length falls back to 0)."""
    fam, spec, cfg, params = tiny
    eng = PagedServingEngine(cfg, params, num_pages=num_pages,
                             page_size=PAGE, max_batch=3, prefill_chunk=4,
                             max_pages_per_seq=16, device="cpu")
    rng = np.random.default_rng(6)
    reqs = [eng.submit(rng.integers(2, 500, n).tolist(), 6)
            for n in (17, 30)]
    seen, grew, held, preempted = [], [], [], []
    while any(r.state != "finished" for r in reqs):
        eng.scheduler.admit()
        held.append(sum(r is not None for r in eng.kv_manager.slots))
        before = [r.committed for r in reqs]
        p0 = eng.stats.preemptions
        eng.step()
        grew.append(sum(r.committed > b for r, b in zip(reqs, before)))
        preempted.append(eng.stats.preemptions - p0)
        live = [r.committed for r in eng.kv_manager.slots if r is not None]
        seen.append(live)
        eng.scheduler.maintain()
    steps = [r for r in eng.tracer.records if r.name == "engine.step"]
    assert len(steps) == len(seen)
    for s, live in zip(steps, seen):
        assert s.get("pages_in_use") == sum(-(-n // PAGE) for n in live)
        assert s.get("window_dead_pages") == sum(
            max(0, n - WINDOW) // PAGE for n in live)
    assert max(s.get("window_dead_pages") for s in steps) > 0
    rows = [s.get("rows") for s in steps]
    assert all(g <= r <= g + p for r, g, p in zip(rows, grew, preempted))
    assert rows[0] == 2
    assert any(r < h for r, h in zip(rows, held)) == (num_pages == 12)
    assert (rows == grew) == (num_pages == 64)


def test_the_engine_refuses_afmoe_under_a_mesh():
    cfg = reduced(get_config("trinity-mini"))
    with pytest.raises(NotImplementedError, match="one device"):
        _chunk_core(None, None, None, torch.zeros(1, dtype=torch.int32),
                    torch.zeros((1, 1), dtype=torch.int64),
                    torch.ones(1), cfg=cfg, mesh=object())


def _dense_window_attention(q, k, v, lengths, chunk_lens, window):
    """Plain masked attention per row over contiguous K/V [B, S, Hkv, D]:
    query j of row b at position len − cl + j sees key i ≤ its position
    (capped at len) with position − i < window."""
    B, C, Hq, D = q.shape
    Hkv = k.shape[2]
    out = torch.zeros_like(q)
    for b in range(B):
        n, cl = int(lengths[b]), int(chunk_lens[b])
        for j in range(C):
            pos = min(n - cl + j, n - 1)
            keys = [i for i in range(n) if i <= pos and pos - i < window]
            for h in range(Hq):
                g = h // (Hq // Hkv)
                s = torch.stack([q[b, j, h] @ k[b, i, g] for i in keys])
                p = torch.softmax(s / math.sqrt(D), 0)
                out[b, j, h] = sum(pi * v[b, i, g] for pi, i in zip(p, keys))
    return out


@pytest.mark.parametrize("C", [1, 5])
def test_the_windowed_plain_kernel_matches_masked_attention(C):
    rng = np.random.default_rng(C)
    B, Hq, Hkv, D, P = 3, 4, 2, 8, 40
    lengths = torch.tensor([C + 3, 19, 33], dtype=torch.int32)
    chunk_lens = torch.tensor([C, C, max(1, C - 2)], dtype=torch.int32)
    maxp = -(-33 // PAGE)
    bt = torch.full((B, maxp), -1, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(P)).to(torch.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // PAGE)
        bt[b, :n] = perm[used:used + n]
        used += n
    k = torch.from_numpy(rng.standard_normal((P, PAGE, Hkv, D))).float()
    v = torch.from_numpy(rng.standard_normal((P, PAGE, Hkv, D))).float()
    q = torch.from_numpy(rng.standard_normal((B, C, Hq, D))).float()
    got = paged_attention(q, {"k": k, "v": v}, bt, lengths,
                          chunk_lens=chunk_lens, window=WINDOW)
    rows = [(-(-int(n) // PAGE)) for n in lengths]
    S = max(rows) * PAGE
    kc, vc = (torch.stack([
        torch.nn.functional.pad(x[bt[b, :rows[b]].long()].reshape(
            -1, Hkv, D), (0, 0, 0, 0, 0, S - rows[b] * PAGE))
        for b in range(B)]) for x in (k, v))
    want = _dense_window_attention(q, kc, vc, lengths, chunk_lens, WINDOW)
    live = torch.arange(C)[None, :] < chunk_lens[:, None]
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               atol=1e-5)
    if C == 1:  # the decode form takes the window too
        dec = paged_attention(q[:, 0], {"k": k, "v": v}, bt, lengths,
                              window=WINDOW)
        np.testing.assert_allclose(dec.numpy(), want[:, 0].numpy(),
                                   atol=1e-5)
    assert not torch.allclose(
        paged_attention(q, {"k": k, "v": v}, bt, lengths,
                        chunk_lens=chunk_lens)[live], got[live], atol=1e-3)


def _padded(cfg, x, p):
    """The capacity-bounded layout at capacity S·k (no assignment
    dropped), with the shared expert added once."""
    B, S, _ = x.shape
    C = moe.moe_capacity(cfg, S, dropless=True)
    _, gate, expert = moe._route(cfg, x, p["w_router"], p.get("router_bias"))
    _, _, pos, local, keep = moe._slots(cfg, expert, C, cfg.n_experts, 0)
    out = moe._experts(moe._dispatch(x, local, pos, keep, cfg.n_experts, C,
                                     cfg.top_k), p)
    y = moe._combine(out, local, pos, keep, gate, C)
    return y + moe._shared(x, p) if "ws_gate" in p else y


def _moe_cfg(score, bias, shared):
    base = reduced(get_config("trinity-mini"))
    return dataclasses.replace(base, router_score=score, router_bias=bias,
                               shared_ff=32 if shared else 0,
                               route_scale=2.826 if score == "sigmoid"
                               else 1.0)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_token_major_matches_the_padded_layout(score, bias):
    cfg = _moe_cfg(score, bias, shared=score == "sigmoid")
    gen = torch.Generator().manual_seed(7)
    p = moe.init_moe(cfg, gen, dtype=torch.float32)
    x = torch.randn((3, 11, cfg.d_model), generator=gen)
    tm, aux = moe._moe_group_token_major(cfg, x, p)
    np.testing.assert_allclose(tm.numpy(), _padded(cfg, x, p).numpy(),
                               atol=1e-5)
    # the aux loss counts the same assignments as the padded layout's
    _, pad_aux = moe._moe_group(cfg, x, p, dropless=False)
    torch.testing.assert_close(aux, pad_aux, atol=1e-6, rtol=1e-6)
    assert moe.token_major(x, True) and not moe.token_major(x, False)
    assert torch.equal(moe.moe_apply(cfg, x, p, dropless=True)[0], tm)
    if bias:
        # choosing by s + b is not choosing by s
        _, _, by_bias = moe._route(cfg, x, p["w_router"], p["router_bias"])
        _, _, by_score = moe._route(cfg, x, p["w_router"])
        assert not torch.equal(by_bias, by_score)


def test_dead_tokens_give_zero_and_leave_the_live_ones_alone():
    cfg = _moe_cfg("sigmoid", True, shared=True)
    gen = torch.Generator().manual_seed(8)
    p = moe.init_moe(cfg, gen, dtype=torch.float32)
    x = torch.randn((4, 6, cfg.d_model), generator=gen)
    live = torch.rand((4, 6), generator=gen) < 0.5
    y, _ = moe._moe_group_token_major(cfg, x, p, live=live)
    whole, _ = moe._moe_group_token_major(cfg, x, p)
    assert (y[~live] == 0).all()
    np.testing.assert_allclose(y[live].numpy(), whole[live].numpy(),
                               atol=1e-6)


def test_the_shared_expert_is_counted_once():
    """Its swiglu is added once a token: in one group, over two groups of
    ``MOE_SEQ_CHUNK`` tokens, and over expert-parallel partials (the
    ``expert0 = 0`` call alone adds it)."""
    cfg = _moe_cfg("sigmoid", True, shared=True)
    gen = torch.Generator().manual_seed(9)
    p = moe.init_moe(cfg, gen, dtype=torch.float32)
    routed = {k: v for k, v in p.items() if not k.startswith("ws_")}
    for S in (5, 2 * moe.MOE_SEQ_CHUNK):
        x = torch.randn((1, S, cfg.d_model), generator=gen)
        y = moe.moe_apply(cfg, x, p, dropless=True)[0]
        alone = moe.moe_apply(cfg, x, routed, dropless=True)[0]
        np.testing.assert_allclose((y - alone).numpy(),
                                   moe._shared(x, p).numpy(), atol=1e-5)
    half = cfg.n_experts // 2
    parts = [moe.moe_apply(cfg, x, {**p, **{k: p[k][e0:e0 + half] for k in
                                            ("w_gate", "w_up", "w_down")}},
                           dropless=True, expert0=e0)[0]
             for e0 in (0, half)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), y.numpy(),
                               atol=1e-5)
