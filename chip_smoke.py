#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never the JAX package) on the card, in phases
that each raise on failure; nothing is caught, so a failed phase ends the
run with a nonzero exit and no result line.

1. Environment: the card's name and power limit, torch and CUDA versions;
   build every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once); where the toolkit has ``cuobjdump``, check
   that exactly the bf16 x bf16 paged-attention instantiations issue
   tensor-core (HMMA) instructions and that all load through cp.async.
2. Kernels: each kernel against its plain PyTorch version on the card over
   a sweep of cases, with the tolerance stated beside it (kernel 1 also
   over the split design's edge cases at split counts 1, 2, 4 and 8), then
   timed at the serving path's shapes beside its bound, its plain version
   and a library yardstick: call time (``ms``: CUDA events over 20
   back-to-back calls, which the host sets for short kernels) and device
   time (``device_ms``: torch.profiler's kernel time per call, L2 flushed
   before each call by a 256 MB write; ``library_device_ms`` counts every
   device op of the yardstick's call).  Kernel 1 is also timed on long
   rows (8 rows of 3072-4096 tokens) and at each split count.  Kernel 3
   (``paged_attention_sharded``) is kernel 1 launched once per shard on
   ``TP`` head slabs of one card; it is held against the plain version over
   the joined arena, and each head bit for bit against one launch over the
   whole arena, with and without the fused append.  The fused launch
   (``paged_attention_append_cuda``: kernel 2's append inside kernel 1's
   launch, the serving path's one launch per layer) is held bit for bit,
   arena and output, against ``kv_append_cuda`` + ``paged_attention_cuda``
   on a copy, its arena bit-exact and its output within kernel 1's
   tolerance against the plain version, over kernel 1's sweep, the split
   edge cases, long rows, GQA with two query groups, denied rows, -1 pages
   and page ids past the arena; then timed as kernel 1 is, beside the pair.
   Multi-query at head dim 256 (paligemma-3b's decoder: one KV head, 8
   query heads, 4 a shard): kernel 1 and the fused launch over the split
   edge cases (bf16, float32, float32 q over a bf16 arena) and at the
   serving shapes, timed there; kernel 3 over a replicated arena (two
   copies, each shard appending the same K/V to its own) bit for bit one
   launch over all query heads, timed.
3. Parity: reduced olmo-1b and olmoe-1b-7b engines on the card against the
   same engines on the CPU (plain versions), float32 weights: generated
   tokens must agree.  Reduced whisper-tiny, recurrentgemma-9b and
   mamba2-780m through ``build_model`` (a 40-token prefill, 8 greedy
   steps), card against CPU on the same float32 weights: logits within
   1e-3, tokens equal.
4. Engines: full-width olmo-1b, olmoe-1b-7b (MoE: 64 experts top-8, the
   dropless expert layer in the fused step, each expert's hidden axis
   split at TP=2) and paligemma-3b (its text decoder: one KV head of 256,
   the arena replicated at TP=2) served through ``PagedServingEngine``,
   each at TP=1 and at ``tensor_parallel=TP`` with every shard on this
   card (``devices=["cuda:0"] * TP``), with seeded float32 weights and then
   the same weights in bf16 (the main path).  In each run every request
   must finish, the clock mirror must equal the pool's clock, the fused
   launch must run once per layer per shard per step and
   ``kv_append_cuda`` never, and a steady step must make exactly one
   device->host transfer; over a replicated arena the shards' copies must
   be bitwise equal after the run, each the whole arena's bytes.  Across
   runs: in float32, TP=2 must equal TP=1 in tokens, and in the K/V of
   every position written within 2e-2 + 2e-2|x| (olmo-1b and paligemma;
   for olmoe wherever no router flip reaches: both float32 runs record
   every token's top-k expert set and the router's k-th minus (k+1)-th
   probability; every K/V element beyond the tolerance must lie
   downstream of a flip, and a flip no other flip reaches must be a near
   tie, its gap below 1e-4);
   in bf16, TP=2's K/V must stay
   as close to float32's as TP=1's do (mean abs difference within 1.25x),
   over the prompt positions and, apart, over the generated positions
   where both still feed the model float32's tokens; the tokens TP=2
   shares with TP=1 are printed.
5. Fleet: full-width olmo-1b (the engine phase's configuration, 16
   requests unless stated) served by ``DataParallelEngine`` with both
   replicas on this card.  Each path has its launch counts set to 0 just
   before it and held just after: the fused launch once per layer, shard
   and engine step, the standalone append never.  (a) bf16, the main path:
   in ``step()`` mode every step's launches per replica and exactly one
   read per replica in a steady step (sync debug mode); then threaded
   ``run()`` (the same tokens) and one engine on the same requests, both
   timed; the clock mirror per replica.  (b) Failover: a warmed fleet with
   ``auto_revive`` whose replica 0 is killed mid-decode; in float32 the
   stitched tokens must equal one engine's, with one failure, one revival
   and every request of the killed replica migrated; in bf16 the equal
   tokens are printed.  (c) bf16 under ``ChaosConfig`` (denials, spurious
   invalidations, delayed frees, unmap-under-reader): in ``step()`` mode
   one read per replica per steady step; then on 64 pages a replica with
   a kill, timed against the same fleet fault-free: 0 lost,
   every fault kind fired, the clock mirror per replica once the frees
   the chaos layer still defers are applied and the clock ticks of its
   spontaneous releases added.  (d) float32 2 replicas x
   ``tensor_parallel=2`` (four shards on this card): tokens equal one
   TP=2 engine's (those equal to TP=1's are printed), 2 x 16 shard
   launches per replica step.  (e) A bursty two-class trace
   at 0.6x the requests/s one engine sustained in (a), replayed open-loop
   through ``launch/serve.py::_replay_trace``: 0 lost, TTFT percentiles
   per class.  (f) The CLI's ``main`` at its reduced size: ``--replicas
   2``, ``--classes --stream``, ``--trace``.
6. Models (g): the non-paged path, ``build_model`` on the card at full
   width and depth for olmo-1b (512-token prompts), mamba2-780m (1000, no
   multiple of its SSD chunk), recurrentgemma-9b (2560: past its 2048
   window, misaligned with it, the chunked RG-LRU branch) and
   whisper-tiny (1500 seeded frames, 64 tokens), B=4, seeded weights in
   float32 then bf16 (the main dtype), each followed by 64 greedy decode
   steps.  Held in float32: finite logits and states, ``len``, the
   decoded logits against teacher forcing over the same tokens within
   3e-2 abs+rel (5e-2 for the ring-windowed recurrentgemma), as the
   reference's tests allow.  Held in both dtypes: every steady
   ``decode_step`` (the third on) makes no device->host transfer (sync
   debug mode "error"), and no kernel of the repository launches (counts
   set to 0 before, read after).  Printed: prefill ms (cold and warm),
   decode ms/step, tokens/s and peak memory; bf16's greedy tokens equal
   to float32's, and olmo-1b bf16's equal to the paged engine's on the
   same prompts and weights (its arena is bf16: the equal prefix).

The second-to-last line is the ``kernels`` JSON (kernel 1, kernel 2, the
sharded kernel 3 and the fused launch; launches from the olmoe-1b-7b bf16
TP=1 run for kernels 1 and 2 and the fused launch, from its bf16 TP=2 run
for kernel 3 — paligemma's are in its own log lines; kernel 1 counts
its launches with and without the append, kernel 2 is off the serving path
and counts 0); the last line is ``{"ok": true, "device": {...}}``.  Exits
nonzero without CUDA.  ``--profile`` adds a torch.profiler breakdown of
steady full-width decode steps (olmo-1b at TP=1 and TP=2, olmoe-1b-7b at
TP=1 with its expert layer alone at the step's shapes, paligemma-3b at
TP=2) after the fleet phase, and the device time of the fleet's drain
beside the fleet phase's wall times.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per data sheet
PA_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
KA_SRC = "src/repro_torch/kernels/csrc/kv_append.cu"
PA_TPU = "src/repro/kernels/paged_attention.py:156"
KA_TPU = "src/repro/kernels/kv_append.py:46"
PS_TPU = "src/repro/kernels/paged_attention.py:218"
TP = 2  # shards of the tensor-parallel checks, all on this card


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Call time: mean time of one call of ``fn`` in ms over ``iters``
    back-to-back calls (CUDA events around the loop), which the host's
    enqueue time sets when a call's device work is shorter."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def device_ms(fn, match=None, iters=20):
    """Device time: mean device time of one call of ``fn`` in ms, from
    torch.profiler's kernel records, each call after a 256 MB write that
    leaves the 50 MB L2 cold (as each layer's arena slab is in the engine).
    Counts the kernels whose name holds ``match``, or with ``match=None``
    every device op of the call; never the flush's.  A trace with no such
    device time (the profiler has returned one on the H100, for 20 calls
    that launched 40 of the kernels it looked for) is logged and taken
    again, three traces at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 * 2**20, dtype=torch.uint8,
                                  device="cuda"))
    flush = _FLUSH[0]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        total = 0.0
        seen = []
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
            if dev > 0 and str(ev.device_type).endswith("CUDA"):
                seen.append(ev.key[:40])
                if "bitwise_not" not in ev.key and (match is None
                                                    or match in ev.key):
                    total += dev
        if total > 0:
            return total / 1e3 / iters
        log(f"device_ms: trace {attempt} of 3 holds no device time for "
            f"{match}; its device ops: {seen}")
    check(False, f"the profiler recorded no device time for {match}")


# ---------------------------------------------------------------------------
# phase 2: kernels


def attention_case(B, C, Hq, Hkv, D, page, P, M, dtype, seed, lens=None):
    """Random paged-attention inputs: ragged lengths, chunks straddling
    pages, rows finishing mid-chunk, -1 holes, one row of length 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kp = torch.randn((P, page, Hkv, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((B, C, Hq, D), generator=g, device="cuda").to(dtype)
    bt = np.full((B, M), -1, np.int32)
    perm = rng.permutation(P)
    used = 0
    ln = np.zeros(B, np.int32)
    cl = np.ones(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, M + 1)) if lens is None else \
            -(-int(lens[b]) // page)
        bt[b, :n] = perm[used:used + n] if used + n <= P else \
            rng.integers(0, P, n)
        used += n
        ln[b] = rng.integers(1, n * page + 1) if lens is None else lens[b]
        cl[b] = rng.integers(1, min(C, max(int(ln[b]), 1)) + 1)
        if lens is None and n > 2 and b % 3 == 1:
            bt[b, rng.integers(0, n - 1)] = -1  # an interior unmapped page
    if lens is None:
        ln[-1], cl[-1] = 0, 1  # a row of length 0 gives zeros
    T = lambda a: torch.as_tensor(a, device="cuda")
    return q, kp, vp, T(bt), T(ln), T(cl)


def attention_work(q, kp, bt, ln, cl):
    """(bytes, ops) this call must move and do, from this run's data: q read
    and out written once, each live mapped K/V token read once, the block
    table entries and lengths read; 4*D ops per live (query, key) pair."""
    import numpy as np

    B, C, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    el = kp.element_size()
    bt_h, ln_h, cl_h = (t.cpu().numpy() for t in (bt, ln, cl))
    kv_tokens = pairs = bt_reads = 0
    for b in range(B):
        n = min(-(-int(ln_h[b]) // page), bt_h.shape[1])
        bt_reads += n
        mapped = np.repeat(bt_h[b, :n] >= 0, page)[: ln_h[b]]
        kv_tokens += int(mapped.sum())
        for c in range(C):
            lim = min(int(ln_h[b]) - int(cl_h[b]) + c + 1, int(ln_h[b]))
            pairs += int(mapped[:max(lim, 0)].sum())
    byts = (2 * q.numel() * q.element_size() + 2 * kv_tokens * Hkv * D * el
            + 4 * (bt_reads + 2 * B))
    ops = 4 * D * pairs * (Hq // Hkv) * Hkv
    return byts, ops


def bound_ms(byts, ops, dtype_name):
    return max(byts / H100_BYTES_PER_S, ops / PEAK_OPS[dtype_name]) * 1e3, \
        "bytes" if byts / H100_BYTES_PER_S >= ops / PEAK_OPS[dtype_name] \
        else "operations"


def sdpa_yardstick(q, kp, vp, bt, ln, cl):
    """One gather plus ``scaled_dot_product_attention`` computing the same
    function (timed only; the port never calls it).  The gather keeps only
    the block-table columns this run's longest row reaches."""
    import torch
    import torch.nn.functional as F

    B, C, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    n = min(-(-int(ln.max().item()) // page), bt.shape[1])
    bt_n = bt[:, :n].long()
    S = n * page
    pos = torch.arange(S, device="cuda")
    qpos = (ln - cl)[:, None].long() + torch.arange(C, device="cuda")[None]
    lim = torch.minimum(qpos + 1, ln[:, None].long())
    mapped = (bt_n >= 0).repeat_interleave(page, dim=1)
    mask = (pos[None, None] < lim[:, :, None]) & mapped[:, None]  # [B,C,S]
    qh = q.transpose(1, 2)  # [B, Hq, C, D]

    def call():
        idx = bt_n.clamp(min=0)
        k = kp[idx].reshape(B, S, Hkv, D).transpose(1, 2)
        v = vp[idx].reshape(B, S, Hkv, D).transpose(1, 2)
        gqa = {} if Hq == Hkv else {"enable_gqa": True}
        return F.scaled_dot_product_attention(qh, k, v,
                                              attn_mask=mask[:, None], **gqa)
    return call


def append_case(lens):
    """Kernel 2's inputs at the serving path's shapes: one new bf16 token
    for each of 8 rows of ``lens`` tokens into a zeroed 512-page arena of
    16 heads of 128.  Returns (arena k, arena v), k_new, v_new, block
    tables, lengths, n_new, write_ok."""
    import numpy as np
    import torch

    B, C, Hkv, D, page, P, M = 8, 1, 16, 128, 16, 512, 512
    bt = torch.as_tensor(np.random.default_rng(8).permutation(P)[: B * 32]
                         .reshape(B, 32).astype(np.int32), device="cuda")
    bt = torch.cat([bt, torch.full((B, M - 32), -1, dtype=torch.int32,
                                   device="cuda")], 1)
    ln = torch.as_tensor(lens.astype(np.int32), device="cuda")
    n_new = torch.ones(B, dtype=torch.int32, device="cuda")
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    kn, vn = (torch.randn((B, C, Hkv, D), generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    arena = [torch.zeros((P, page, Hkv, D), dtype=torch.bfloat16,
                         device="cuda") for _ in range(2)]
    return arena, kn, vn, bt, ln, n_new, ok


def attention_row(case, label, plain_iters=5):
    """Kernel 1 on ``case`` against its plain version, timed beside its
    bound and the gather + SDPA yardstick, in call time and device time;
    then its device time at each split count of the sweep that chose
    ``SPLITS``.  Logs and returns the row."""
    import torch

    from repro_torch.kernels.paged_attention import (SPLITS,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)

    err = (paged_attention_cuda(*case).float()
           - paged_attention_plain(*case).float()).abs().max().item()
    byts, ops = attention_work(case[0], case[1], *case[3:])
    b_ms, by = bound_ms(byts, ops, "bfloat16")
    yard = sdpa_yardstick(*case)
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: paged_attention_cuda(*case)),
        device_ms=device_ms(lambda: paged_attention_cuda(*case),
                            "paged_attention_kernel"),
        plain_ms=time_ms(lambda: paged_attention_plain(*case),
                         iters=plain_iters),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(yard),
        library_device_ms=device_ms(yard))
    row["bound_share"] = b_ms / row["device_ms"]
    sweep = {S: device_ms(lambda: paged_attention_cuda(*case, _splits=S),
                          "paged_attention_kernel") for S in (1, 2, 4, 8)}
    torch.cuda.synchronize()
    log(f"{label}: " + json.dumps(row))
    log(f"{label}: device ms by split count " + json.dumps(sweep)
        + f" (SPLITS = {SPLITS}); {byts / 1e6:.1f} MB moved")
    return row


def kernel_phase(results):
    import numpy as np
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda, kv_append_plain
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)

    # -- kernel 1: correctness sweep -----------------------------------------
    # tolerance: float32 differs from the plain version only by summation
    # order (1e-4 abs on outputs of order 1); bfloat16 outputs may round to
    # neighbouring bf16 values (one ulp is 2^-7 relative: 2e-2 abs)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = 0.0
    n_cases = 0
    sweep = []
    for dtype in (torch.bfloat16, torch.float32):
        for C in (1, 16):
            for ppcb in (1, 2, 4):
                sweep.append((8, C, 16, 16, 128, 16, 512, 24, dtype, ppcb))
        sweep.append((8, 16, 32, 8, 128, 16, 256, 20, dtype, 2))  # GQA 4:1
        sweep.append((5, 16, 16, 16, 128, 16, 64, 7, dtype, 4))  # M % 4 != 0
    for i, (B, C, Hq, Hkv, D, page, P, M, dtype, ppcb) in enumerate(sweep):
        q, kp, vp, bt, ln, cl = attention_case(B, C, Hq, Hkv, D, page, P, M,
                                               dtype, seed=100 + i)
        got = paged_attention_cuda(q, kp, vp, bt, ln, cl, ppcb)
        want = paged_attention_plain(q, kp, vp, bt, ln, cl)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= tol[dtype],
              f"paged_attention case {i} {sweep[i]}: max err {err}")
        check(bool((got[-1] == 0).all()) or int(ln[-1]) > 0,
              "a row of length 0 must give zeros")
        worst = max(worst, err) if dtype == torch.bfloat16 else worst
        n_cases += 1
    log(f"paged_attention: {n_cases} cases match the plain version "
        f"(bf16 tol 2e-2, f32 tol 1e-4); worst bf16 err {worst:.3g}")

    # -- kernel 1: the split design's edge cases, at every split count -------
    # (the cases of the tests, ``tests/split_cases.py``, at page 16, D 128)
    sys.path.insert(0, str(ROOT / "tests"))
    from split_cases import split_edge_case

    n_cases = 0
    for S in (1, 2, 4, 8):
        for C, Hq, Hkv in ((1, 16, 16), (16, 16, 16), (16, 32, 8)):
            arrays = [torch.as_tensor(a, device="cuda") for a in
                      split_edge_case(S, 16, C, Hq, Hkv, 128,
                                      seed=400 + 10 * S + C)]
            for dtype in (torch.bfloat16, torch.float32):
                case = [a.to(dtype) for a in arrays[:3]] + arrays[3:]
                got = paged_attention_cuda(*case, _splits=S)
                want = paged_attention_plain(*case)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                check(math.isfinite(err) and err <= tol[dtype],
                      f"paged_attention split edge S={S} C={C} Hq={Hq} "
                      f"Hkv={Hkv} {dtype}: max err {err}")
                check(bool((got[4] == 0).all()), "a row of length 0 must "
                      "give zeros")
                n_cases += 1
    log(f"paged_attention: {n_cases} split edge cases (S in 1, 2, 4, 8; "
        f"1-token row, row shorter than S pages, a split of -1 pages, a "
        f"horizon across a split boundary, length 0, a clamped page id) "
        f"match the plain version")

    # -- kernel 1 timed at the serving path's shapes ---------------------------
    # full olmo-1b engine: B=8 rows, block table width 512 (= num_pages),
    # 16 heads of 128, bf16 arena of 512 pages of 16 tokens; lengths as in
    # the engine phase mid-decode (prompt 64..256 plus 16 generated)
    lens = np.random.default_rng(7).integers(64, 257, 8) + 16
    rows = {}
    for C in (1, 16):
        case = attention_case(8, C, 16, 16, 128, 16, 512, 512, torch.bfloat16,
                              seed=7, lens=lens)
        case[5].fill_(C)
        rows[C] = attention_row(case, f"paged_attention C={C}")
    # the same kernel on long rows, where bytes dominate: 8 rows of
    # 3072..4096 tokens over a 2048-page arena (~0.24 GB a launch)
    long_lens = np.random.default_rng(9).integers(3072, 4097, 8)
    case = attention_case(8, 1, 16, 16, 128, 16, 2048, 512, torch.bfloat16,
                          seed=9, lens=long_lens)
    case[5].fill_(1)
    attention_row(case, "paged_attention long rows C=1", plain_iters=2)
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda", source=PA_SRC, replaces=PA_TPU,
        **rows[1])
    results["paged_attention_c16"] = rows[16]

    sharded_kernel(results, lens)

    # -- kernel 2: bit-exact sweep ---------------------------------------------
    # Hkv=16 is the TP=1 arena; Hkv=8 with a table of 512 pages is the
    # per-shard slab the TP=2 engine hands the kernel (2048-byte rows)
    cases = [(1, torch.bfloat16, 16, 12), (16, torch.bfloat16, 16, 12),
             (16, torch.float32, 16, 12), (1, torch.float32, 16, 12),
             (1, torch.bfloat16, 8, 512), (16, torch.bfloat16, 8, 512)]
    for i, (C, dtype, Hkv, M) in enumerate(cases):
        B, D, page, P = 8, 128, 16, 512
        rng = np.random.default_rng(200 + i)
        bt = np.full((B, M), -1, np.int32)
        bt[:, :10] = rng.permutation(P)[: B * 10].reshape(B, 10)
        bt[2, 3] = -1  # an unmapped page inside a chunk
        ln = rng.integers(0, 9 * page, B).astype(np.int32)
        ln[5] = M * page - 3  # tokens past the table width are skipped
        n_new = rng.integers(1, C + 1, B).astype(np.int32)
        ok = rng.random(B) > 0.2
        T = lambda a: torch.as_tensor(a, device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(i)
        kn = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
        vn = torch.randn((B, C, Hkv, D), generator=g, device="cuda").to(dtype)
        arena = [torch.randn((P, page, Hkv, D), generator=g,
                             device="cuda").to(dtype) for _ in range(2)]
        mine = [a.clone() for a in arena]
        kv_append_cuda(*mine, kn, vn, T(bt), T(ln), T(n_new), T(ok))
        kv_append_plain(*arena, kn, vn, T(bt), T(ln), T(n_new), T(ok))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(mine, arena)),
              f"kv_append case {i} {cases[i]}: not bit-exact")
    log(f"kv_append: {len(cases)} cases bit-exact against the plain version "
        f"(Hkv 16 and the TP={TP} slab's 8)")

    # -- kernel 2 timed at the serving path's shapes ---------------------------
    B, C, Hkv, D = 8, 1, 16, 128
    mine, kn, vn, bt, ln, n_new, ok = append_case(lens)
    arena = [a.clone() for a in mine]
    kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)
    kv_append_plain(*arena, kn, vn, bt, ln, n_new, ok)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(mine, arena))
    check(err == 0, f"kv_append at the serving shapes: max err {err}")
    pos = ln.long()
    page = mine[0].shape[1]
    pidx = bt.long().gather(1, (pos // page)[:, None])[:, 0]
    sidx = pos % page

    def library():
        arena[0].index_put_((pidx, sidx), kn[:, 0])
        arena[1].index_put_((pidx, sidx), vn[:, 0])

    def mine_call():
        kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)
    row_bytes = Hkv * D * 2
    byts = 2 * 2 * B * C * row_bytes + 4 * 3 * B
    b_ms, by = bound_ms(byts, 0, "bfloat16")
    results["kv_append"] = dict(
        name="kv_append", route="cuda", source=KA_SRC, replaces=KA_TPU,
        max_abs_err=err, ms=time_ms(mine_call),
        device_ms=device_ms(mine_call, "kv_append_kernel"),
        plain_ms=time_ms(lambda: kv_append_plain(*arena, kn, vn, bt, ln,
                                                 n_new, ok)),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
        library_device_ms=device_ms(library))
    log("kv_append C=1: " + json.dumps(
        {k: v for k, v in results["kv_append"].items()
         if k not in ("name", "route", "source", "replaces")}))

    fused_kernel(results, lens)
    mqa_kernel(results, lens)


def append_inputs(case, seed, deny=1):
    """The fused append's k_new, v_new [B, C, Hkv, D] (the arena's dtype)
    and write_ok [B] (row ``deny`` False, None for none) for an
    :func:`attention_case`; its row of length 0 gets chunk length 0 (rows
    need ``chunk_lens <= lengths``)."""
    import torch

    q, kp, vp, bt, ln, cl = case
    B, C = q.shape[:2]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kn, vn = (torch.randn((B, C) + tuple(kp.shape[2:]), generator=g,
                          device="cuda").to(kp.dtype) for _ in range(2))
    cl.masked_fill_(ln == 0, 0)
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    if deny is not None:
        ok[deny] = False
    return kn, vn, ok


def fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok, label, S=None):
    """The fused launch on copies of the arena against ``kv_append_cuda`` +
    ``paged_attention_cuda`` (bitwise, arena and output) and against the
    plain version (arena bit-exact, output within kernel 1's tolerance).
    Returns the max abs error against the plain version."""
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)

    pair, mine, plain = ([kp.clone(), vp.clone()] for _ in range(3))
    kv_append_cuda(*pair, kn, vn, bt, ln - cl, cl, ok)
    want = paged_attention_cuda(q, *pair, bt, ln, cl, _splits=S)
    got = paged_attention_append_cuda(q, *mine, kn, vn, bt, ln, cl, ok,
                                      _splits=S)
    ref = paged_attention_append_plain(q, *plain, kn, vn, bt, ln, cl, ok)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(mine, pair)),
        f"{label}: the fused launch differs from kv_append_cuda + "
        f"paged_attention_cuda")
    check(all(torch.equal(a, b) for a, b in zip(mine, plain)),
          f"{label}: the fused launch's arena is not bit-exact against the "
          f"plain version")
    check(not ok.any() or not torch.equal(mine[0], kp),
          f"{label}: the fused launch wrote nothing")
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2e-2 if torch.bfloat16 in (q.dtype, kp.dtype) else 1e-4
    check(math.isfinite(err) and err <= tol,
          f"{label}: max err {err} against the plain version (tol {tol})")
    return err


def fused_row(case, label, seed):
    """The fused launch on ``case`` (every row appending its chunk) checked
    by :func:`fused_check`, then timed beside its bound, its plain
    version, the library yardstick (``index_put_`` of the new K/V, then
    the gather + SDPA call) and the two-launch pair.  Logs and returns the
    row."""
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)

    q, kp, vp, bt, ln, cl = case
    C = q.shape[1]
    kn, vn, ok = append_inputs(case, seed=seed, deny=None)
    err = fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok, f"{label} timed case")
    old = ln - cl
    byts, ops = attention_work(q, kp, bt, ln, cl)
    # the append's reads are kernel 1's reads of those positions; its
    # writes and write_ok come on top
    byts += 2 * kn.numel() * kn.element_size() + q.shape[0]
    b_ms, by = bound_ms(byts, ops, "bfloat16")
    page = kp.shape[1]
    pos = old.long()[:, None] + torch.arange(C, device="cuda")[None]
    pidx = bt.long().gather(1, pos // page)
    sidx = pos % page
    yard = sdpa_yardstick(q, kp, vp, bt, ln, cl)

    def library():
        kp.index_put_((pidx, sidx), kn)
        vp.index_put_((pidx, sidx), vn)
        return yard()

    def mine():
        paged_attention_append_cuda(q, kp, vp, kn, vn, bt, ln, cl, ok)

    def pair():
        kv_append_cuda(kp, vp, kn, vn, bt, old, cl, ok)
        paged_attention_cuda(q, kp, vp, bt, ln, cl)
    row = dict(
        max_abs_err=err, ms=time_ms(mine),
        device_ms=device_ms(mine, "paged_attention_kernel"),
        plain_ms=time_ms(lambda: paged_attention_append_plain(
            q, kp, vp, kn, vn, bt, ln, cl, ok), iters=5),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
        library_device_ms=device_ms(library),
        pair_ms=time_ms(pair), pair_device_ms=device_ms(pair))
    row["bound_share"] = b_ms / row["device_ms"]
    log(f"{label}: " + json.dumps(row))
    return row


def fused_kernel(results, lens):
    """Kernel 2 fused into kernel 1's launch: bitwise against the
    two-launch pair over kernel 1's cases, then timed at the serving
    path's shapes beside the pair, the plain version and the library."""
    import numpy as np
    import torch

    from split_cases import append_edge_case

    bf16, f32 = torch.bfloat16, torch.float32
    n_cases = 0
    worst = 0.0
    # kernel 1's sweep shapes, a GQA 8:1 case with two query groups of 64
    # (C * G = 128), and float32 q over the bf16 arena (float32 weights)
    for qd, kd in ((bf16, bf16), (f32, f32), (f32, bf16)):
        for i, (B, C, Hq, Hkv, M, P) in enumerate((
                (8, 1, 16, 16, 24, 512), (8, 16, 16, 16, 24, 512),
                (8, 16, 32, 8, 20, 256), (8, 16, 64, 8, 20, 256),
                (5, 16, 16, 16, 7, 64))):
            case = attention_case(B, C, Hq, Hkv, 128, 16, P, M, kd,
                                  seed=500 + i)
            kn, vn, ok = append_inputs(case, seed=i)
            q, kp, vp, bt, ln, cl = case
            err = fused_check(q.to(qd), kp, vp, kn, vn, bt, ln, cl, ok,
                              f"fused case {i} {qd} q, {kd} arena")
            worst = max(worst, err) if qd == bf16 else worst
            n_cases += 1
    for S in (1, 2, 4, 8):
        for C, Hq, Hkv in ((1, 16, 16), (16, 16, 16), (16, 32, 8),
                           (16, 64, 8)):
            arrays = [torch.as_tensor(a, device="cuda") for a in
                      append_edge_case(S, 16, C, Hq, Hkv, 128,
                                       seed=600 + 10 * S + C + Hq)]
            for dtype in (bf16, f32):
                case = [a.to(dtype) for a in arrays[:5]] + arrays[5:]
                fused_check(*case, f"fused split edge S={S} C={C} Hq={Hq} "
                            f"Hkv={Hkv} {dtype}", S=S)
                n_cases += 1
    long_lens = np.random.default_rng(9).integers(3072, 4097, 8)
    case = attention_case(8, 1, 16, 16, 128, 16, 2048, 512, bf16, seed=9,
                          lens=long_lens)
    case[5].fill_(1)
    kn, vn, ok = append_inputs(case, seed=9)
    fused_check(*case[:3], kn, vn, *case[3:], ok, "fused long rows")
    n_cases += 1
    log(f"paged_attention_append: {n_cases} cases (kernel 1's sweep, GQA "
        f"with two query groups, float32 q over a bf16 arena, split edge "
        f"cases at S in 1, 2, 4, 8, long rows; denied rows, -1 pages, page "
        f"ids past the arena) bitwise equal to kv_append_cuda + "
        f"paged_attention_cuda in arena and output, arena bit-exact against "
        f"the plain version; worst bf16 output err {worst:.3g} (tol 2e-2)")

    # -- timed at the serving path's shapes (kernel 1's cases, one new
    # token per row at C=1 and a 16-token chunk at C=16, every row live)
    rows = {}
    for C in (1, 16):
        case = attention_case(8, C, 16, 16, 128, 16, 512, 512, bf16, seed=7,
                              lens=lens)
        case[5].fill_(C)
        rows[C] = fused_row(case, f"paged_attention_append C={C}", seed=7)
    results["paged_attention_append"] = dict(
        name="paged_attention_append", route="cuda", source=PA_SRC,
        replaces=KA_TPU, **rows[1])
    results["paged_attention_append_c16"] = rows[16]


def sharded_kernel(results, lens):
    """Kernel 3: kernel 1 launched once per shard on the shard's KV-head
    slab, against the plain version over the joined arena, then timed at
    the serving path's shapes split over ``TP`` shards."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded,
        paged_attention_sharded_plain)
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(TP, ["cuda:0"] * TP)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # as kernel 1's

    def split(a):  # [.., H, D] -> TP contiguous head slabs
        return [t.contiguous() for t in a.chunk(TP, dim=2)]

    def run(q, kp, vp, bt, ln, cl):
        before = paged_attention_sharded.launches
        outs = paged_attention_sharded(split(q), split(kp), split(vp), bt, ln,
                                       cl, mesh=mesh, n_kv_heads=kp.shape[2])
        check(paged_attention_sharded.launches - before == TP,
              f"paged_attention_sharded made "
              f"{paged_attention_sharded.launches - before} launches, want "
              f"{TP}")
        got = torch.cat(outs, dim=2)
        want = paged_attention_plain(q, kp, vp, bt, ln, cl)
        # the split partition reads only each row's page count and SPLITS:
        # every head of one launch over the whole arena, bit for bit
        check(torch.equal(got, paged_attention_cuda(q, kp, vp, bt, ln, cl)),
              f"{q.dtype}: per-shard launches differ from the full launch")
        torch.cuda.synchronize()
        return (got.float() - want.float()).abs().max().item()

    def run_append(case, seed):
        """The fused append per shard against one fused launch over the
        whole arena: every head's output and arena slab bit for bit."""
        q, kp, vp, bt, ln, cl = case
        kn, vn, ok = append_inputs(case, seed)
        full = [kp.clone(), vp.clone()]
        want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
        ks, vs = split(kp), split(vp)
        outs = paged_attention_sharded(split(q), ks, vs, bt, ln, cl, mesh=mesh,
                                       n_kv_heads=kp.shape[2],
                                       append=(split(kn), split(vn), ok))
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(outs, dim=2), want)
              and torch.equal(torch.cat(ks, dim=2), full[0])
              and torch.equal(torch.cat(vs, dim=2), full[1]),
              f"{q.dtype}: per-shard fused launches differ from the full "
              f"fused launch")

    sweep = [(8, C, 16, 16, 128, 16, 512, 512, torch.bfloat16, lens)
             for C in (1, 16)]
    sweep += [(8, 16, 16, 16, 128, 16, 512, 512, torch.float32, lens),
              (8, 1, 16, 16, 128, 16, 512, 512, torch.float32, lens),
              (8, 16, 32, 8, 128, 16, 256, 20, torch.bfloat16, None)]
    for i, (B, C, Hq, Hkv, D, page, P, M, dtype, ln_) in enumerate(sweep):
        case = attention_case(B, C, Hq, Hkv, D, page, P, M, dtype,
                              seed=300 + i, lens=ln_)
        err = run(*case)
        check(math.isfinite(err) and err <= tol[dtype],
              f"paged_attention_sharded case {i}: max err {err}")
        run_append(case, seed=300 + i)
    log(f"paged_attention_sharded: {len(sweep)} cases over {TP} shards match "
        f"the plain version over the joined arena (bf16 tol 2e-2, f32 tol "
        f"1e-4) and the full-arena launch bit for bit (bf16 and f32), {TP} "
        f"launches per call; with the fused append, each shard's output and "
        f"arena slab equal the full fused launch's bit for bit")

    rows = {}
    for C in (1, 16):
        q, kp, vp, bt, ln, cl = attention_case(8, C, 16, 16, 128, 16, 512,
                                               512, torch.bfloat16, seed=7,
                                               lens=lens)
        cl.fill_(C)
        err = run(q, kp, vp, bt, ln, cl)
        qs, ks, vs = split(q), split(kp), split(vp)
        byts = ops = 0
        for qq, kk in zip(qs, ks):  # each shard's launch reads its inputs
            b_, o_ = attention_work(qq, kk, bt, ln, cl)
            byts, ops = byts + b_, ops + o_
        b_ms, by = bound_ms(byts, ops, "bfloat16")
        yard = [sdpa_yardstick(qq, kk, vv, bt, ln, cl)
                for qq, kk, vv in zip(qs, ks, vs)]

        def mine():
            paged_attention_sharded(qs, ks, vs, bt, ln, cl, mesh=mesh,
                                    n_kv_heads=16)

        def library():
            for f in yard:
                f()
        rows[C] = dict(
            max_abs_err=err, ms=time_ms(mine),
            device_ms=device_ms(mine, "paged_attention_kernel"),
            plain_ms=time_ms(lambda: paged_attention_sharded_plain(
                qs, ks, vs, bt, ln, cl, mesh=mesh, n_kv_heads=16), iters=5),
            bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
            library_device_ms=device_ms(library))
        rows[C]["bound_share"] = b_ms / rows[C]["device_ms"]
        log(f"paged_attention_sharded C={C}, {TP} shards: "
            + json.dumps(rows[C]))
        if C == 16:  # C=1's call time again, after C=16: the order's part
            rows[1]["ms_after_c16"] = time_ms(c1_call)
            log(f"paged_attention_sharded C=1, {TP} shards, call ms timed "
                f"again after C=16: {rows[1]['ms_after_c16']:.4g} (first "
                f"{rows[1]['ms']:.4g})")
        else:
            c1_call = mine
    results["paged_attention_sharded"] = dict(
        name="paged_attention_sharded", route="cuda", source=PA_SRC,
        replaces=PS_TPU, **rows[1])
    results["paged_attention_sharded_c16"] = rows[16]


def mqa_kernel(results, lens):
    """Kernels 1 and 3 and the fused launch at multi-query shapes: head dim
    256 and one KV head (paligemma-3b's decoder: 8 query heads at TP=1, 4
    per shard at TP=2, the arena replicated).  Checked against the plain
    versions on the split edge cases and at the serving shapes, then timed
    there (bf16 pages, C = 1 and 16); kernel 3 as two shard launches over
    two copies of the arena, each appending the same new K/V, bit for bit
    one launch over all 8 query heads."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_plain, paged_attention_sharded,
        paged_attention_sharded_plain)
    from repro_torch.launch.mesh import make_serving_mesh
    from split_cases import append_edge_case

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {f32: 1e-4, bf16: 2e-2}
    n_cases = 0
    for S in (1, 2):
        for C in (1, 16):
            for Hq in (8, 4):
                arrays = [torch.as_tensor(a, device="cuda") for a in
                          append_edge_case(S, 16, C, Hq, 1, 256,
                                           seed=700 + 10 * S + C + Hq)]
                for qd, kd in ((bf16, bf16), (f32, f32), (f32, bf16)):
                    q = arrays[0].to(qd)
                    k, v, kn, vn = (a.to(kd) for a in arrays[1:5])
                    bt, ln, cl, ok = arrays[5:]
                    label = f"mqa D=256 S={S} C={C} Hq={Hq} {qd} q, {kd} arena"
                    if qd == kd:
                        got = paged_attention_cuda(q, k, v, bt, ln, cl,
                                                   _splits=S)
                        want = paged_attention_plain(q, k, v, bt, ln, cl)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        check(math.isfinite(err) and err <= tol[kd],
                              f"{label}: max err {err}")
                    fused_check(q, k, v, kn, vn, bt, ln, cl, ok, label, S=S)
                    n_cases += 1
    log(f"mqa: {n_cases} head-dim-256 one-KV-head cases (split edge cases at "
        f"S = 1, 2; C = 1, 16; 8 and 4 query heads; bf16, float32 and "
        f"float32 q over a bf16 arena) match the plain versions; the fused "
        f"launch bitwise the two-launch pair")

    mesh = make_serving_mesh(TP, ["cuda:0"] * TP)
    for C in (1, 16):
        for Hq in (8, 4):
            case = attention_case(8, C, Hq, 1, 256, 16, 512, 512, bf16,
                                  seed=11, lens=lens)
            case[5].fill_(C)
            label = f"mqa D=256 Hq={Hq}"
            results[f"mqa_attention_c{C}_hq{Hq}"] = attention_row(
                case, f"paged_attention {label} C={C}")
            results[f"mqa_append_c{C}_hq{Hq}"] = fused_row(
                [a.clone() for a in case],
                f"paged_attention_append {label} C={C}", seed=11)

        # kernel 3 over the replicated arena: 8 query heads, 4 a shard
        q, kp, vp, bt, ln, cl = attention_case(8, C, 8, 1, 256, 16, 512, 512,
                                               bf16, seed=12, lens=lens)
        cl.fill_(C)
        kn, vn, ok = append_inputs((q, kp, vp, bt, ln, cl), seed=12,
                                   deny=None)
        qs = [t.contiguous() for t in q.chunk(TP, dim=2)]
        full = [kp.clone(), vp.clone()]
        want = paged_attention_append_cuda(q, *full, kn, vn, bt, ln, cl, ok)
        copies = [[kp.clone(), vp.clone()] for _ in range(TP)]
        before = paged_attention_sharded.launches
        outs = paged_attention_sharded(
            qs, [c[0] for c in copies], [c[1] for c in copies], bt, ln, cl,
            mesh=mesh, n_kv_heads=TP, append=([kn] * TP, [vn] * TP, ok))
        torch.cuda.synchronize()
        check(paged_attention_sharded.launches - before == TP,
              "mqa kernel 3: one launch per shard")
        check(torch.equal(torch.cat(outs, dim=2), want)
              and all(torch.equal(c[0], full[0]) and torch.equal(c[1], full[1])
                      for c in copies),
              f"mqa kernel 3 C={C}: per-shard launches over the replicated "
              f"arena differ from one launch over all query heads")
        err = (torch.cat(outs, dim=2).float() - paged_attention_plain(
            q, *full, bt, ln, cl).float()).abs().max().item()
        check(err <= tol[bf16], f"mqa kernel 3 C={C}: max err {err}")
        # timed over the two distinct copies: each launch streams its own
        # arena from memory, as the bound counts it
        ks, vs = [c[0] for c in copies], [c[1] for c in copies]
        byts = ops = 0
        for qq, kk in zip(qs, ks):  # each shard's launch reads its inputs
            b_, o_ = attention_work(qq, kk, bt, ln, cl)
            byts, ops = byts + b_, ops + o_
        b_ms, by = bound_ms(byts, ops, "bfloat16")
        yard = [sdpa_yardstick(qq, kk, vv, bt, ln, cl)
                for qq, kk, vv in zip(qs, ks, vs)]

        def mine():
            paged_attention_sharded(qs, ks, vs, bt, ln, cl, mesh=mesh,
                                    n_kv_heads=TP)

        def library():
            for f in yard:
                f()
        row = dict(
            max_abs_err=err, ms=time_ms(mine),
            device_ms=device_ms(mine, "paged_attention_kernel"),
            plain_ms=time_ms(lambda: paged_attention_sharded_plain(
                qs, ks, vs, bt, ln, cl, mesh=mesh, n_kv_heads=TP), iters=5),
            bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
            library_device_ms=device_ms(library))
        row["bound_share"] = b_ms / row["device_ms"]
        results[f"mqa_sharded_c{C}"] = row
        log(f"paged_attention_sharded mqa D=256 C={C}, {TP} shards over a "
            f"replicated arena: " + json.dumps(row))


# ---------------------------------------------------------------------------
# phase 3: parity of the card against the CPU on a small model


def parity_phase():
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    for arch in ("olmo-1b", "olmoe-1b-7b"):
        cfg = reduced(get_config(arch))
        params = init_decoder_lm(cfg, seed=3, dtype=torch.float32,
                                 device="cpu")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.integers(3, 20, 6)]
        out = {}
        for dev in ("cpu", "cuda"):
            eng = PagedServingEngine(cfg, params, num_pages=24, page_size=4,
                                     max_batch=3, prefill_chunk=8, device=dev)
            reqs = [eng.submit(p, 8) for p in prompts]
            st = eng.run()
            check(all(r.state == "finished" for r in reqs),
                  f"{arch} {dev}: unfinished")
            check(st.warnings_fired == int(eng.pool.clock.cpu()),
                  f"{arch} {dev}: clock mirror {st.warnings_fired} != pool "
                  f"clock")
            out[dev] = ([r.generated for r in reqs], st.steps, st.preemptions)
        check(out["cpu"] == out["cuda"],
              f"card and CPU disagree on reduced {arch}: {out}")
        log(f"parity: reduced {arch}, 6 requests, card == CPU (tokens, "
            f"{out['cpu'][1]} steps, {out['cpu'][2]} preemptions)")
    # the non-paged families: build_model's prefill and 8 greedy steps
    for arch in ("whisper-tiny", "recurrentgemma-9b", "mamba2-780m"):
        cfg = reduced(get_config(arch))
        run = {dev: model_run(cfg, 40, torch.float32, dev=dev, steps=8,
                              seed=3, init_dev="cpu")
               for dev in ("cpu", "cuda")}
        err = float((run["cuda"]["logits"].cpu()
                     - run["cpu"]["logits"]).abs().max())
        check(torch.allclose(run["cuda"]["logits"].cpu(), run["cpu"]["logits"],
                             atol=1e-3, rtol=1e-3),
              f"card and CPU logits of reduced {arch} differ by {err:.3g}")
        check(torch.equal(run["cuda"]["tokens"], run["cpu"]["tokens"]),
              f"card and CPU disagree on reduced {arch}'s tokens")
        log(f"parity: reduced {arch} through build_model, prefill + 8 steps, "
            f"card == CPU (tokens; logits max abs {err:.3g}, limit 1e-3)")


# ---------------------------------------------------------------------------
# phase 4: the full-width engine


def row_kv(eng, r):
    """K and V [L, n, Hkv, D] at the ``n = r.committed`` positions request
    ``r`` has written, read from the (joined) arena through its block
    table."""
    import numpy as np
    import torch

    kvm = eng.kv_manager
    pos = np.arange(r.committed)
    page = np.asarray(kvm.row_pages(r.slot))[pos // kvm.page_size]
    idx = [torch.as_tensor(a, device=kvm.device)
           for a in (page, pos % kvm.page_size)]
    kv = kvm.gather_kv()
    return {n: kv[n][:, idx[0], idx[1]].float() for n in ("k", "v")}


def first_divergence(run, base):
    """Per request, the index of the first generated token where ``run``
    and ``base`` (results of :func:`engine_phase`) differ."""
    return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y), len(q))
            for p, q in zip(run[0], base[0])]


def kv_distance(run, base, depth):
    """How far ``run``'s K/V are from ``base``'s, at positions where both
    fed the model the same tokens: every prompt position, and generated
    positions ``j < depth[i]`` of request i.  Returns {part: (mean abs
    difference, elements beyond 2e-2 + 2e-2|x| — the reference's TP
    tolerance —, elements)} for the parts "prompt" (chunked prefill) and
    "decode" (C=1 steps), K and V together."""
    import torch

    out = {}
    for part in ("prompt", "decode"):
        diffs, bad = [], 0
        for i, plen in enumerate(run[3]):
            lo, hi = (0, plen) if part == "prompt" else (plen, plen + depth[i])
            for n in ("k", "v"):
                a, b = (x[1][i][n][:, lo:hi] for x in (run, base))
                d = (a - b).abs()
                diffs.append(d.flatten())
                bad += int((d > 2e-2 + 2e-2 * b.abs()).sum())
        d = torch.cat(diffs)
        out[part] = (d.mean().item() if d.numel() else float("nan"), bad,
                     d.numel())
        n_pos = sum(run[3]) if part == "prompt" else sum(depth)
        log(f"{run[2]}: {part} K/V against {base[2]} at {n_pos} positions: "
            f"mean abs diff {out[part][0]:.4g}, {bad} of {d.numel()} "
            f"elements beyond 2e-2 + 2e-2|x|")
    return out


@contextlib.contextmanager
def route_trace(records, slots):
    """While open, every fused step appends to ``records`` its rows'
    ``lengths`` and live chunk lengths and ``slots()`` (row -> request
    index), and every MoE router call of that step the top-k expert set
    of each (row, chunk) token, sorted, and the gap between the router's
    k-th and (k+1)-th probability.  Device tensors only: the step keeps
    its one host read."""
    import torch

    from repro_torch.models import moe
    from repro_torch.serving import paged_decode

    core, route = paged_decode._chunk_core, moe._route

    def traced_core(model, kv, block_tables, lengths, tokens, n_new, **kw):
        records.append((lengths.clone(), n_new.clone(), slots(), []))
        return core(model, kv, block_tables, lengths, tokens, n_new, **kw)

    def traced_route(cfg, x, w_router):
        probs, gate, expert = route(cfg, x, w_router)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.top_k
        records[-1][3].append((expert.sort(dim=-1).values.to(torch.int16),
                               top[..., k - 1] - top[..., k]))
        return probs, gate, expert

    paged_decode._chunk_core, moe._route = traced_core, traced_route
    try:
        yield records
    finally:
        paged_decode._chunk_core, moe._route = core, route


def routes_by_position(records, cfg, n_req, tag):
    """:func:`route_trace`'s records per request and position: (sel [n_req,
    L, n, k] int16 top-k sets, -1 where unwritten; gap [n_req, L, n]
    float32).  Under TP every shard routes (the router is replicated):
    their sets must be equal; shard 0's are kept."""
    import numpy as np
    import torch

    L, k = cfg.n_layers, cfg.top_k
    n = max(int((ln + nn).max()) for ln, nn, _, _ in records)
    sel = np.full((n_req, L, n, k), -1, np.int16)
    gap = np.full((n_req, L, n), np.nan, np.float32)
    for lengths, n_new, slots, calls in records:
        lengths, n_new = lengths.cpu().numpy(), n_new.cpu().numpy()
        shards = len(calls) // L
        check(len(calls) == shards * L, f"{tag}: {len(calls)} router calls "
              f"in a step of {L} layers")
        s_all = torch.stack([c[0] for c in calls]).cpu().numpy()
        g_all = torch.stack([c[1] for c in calls]).cpu().numpy()
        s_all = s_all.reshape(L, shards, *s_all.shape[1:])
        check((s_all == s_all[:, :1]).all(),
              f"{tag}: the shards' routers chose different experts")
        g_all = g_all.reshape(L, shards, *g_all.shape[1:])[:, 0]
        for b, i in slots.items():
            for j in range(int(n_new[b])):
                p = int(lengths[b]) + j
                sel[i, :, p], gap[i, :, p] = s_all[:, 0, b, j], g_all[:, b, j]
    return sel, gap


def routing_check(run, base):
    """Hold MoE K/V across two runs of the same tokens by their routing.
    A position's K/V at layer l follow from the hidden states of layers
    < l at it and at the positions before it, and from those tokens'
    routing: where a router's top-k set differs between the runs (a
    flip) the K/V downstream of it may differ beyond tolerance.  So the
    check: (i) every K/V element beyond 2e-2 + 2e-2|x| lies downstream of
    a flip (layer > the flip's, position >= its position, same request);
    (ii) every flip that no other flip reaches is a near tie: its k-th
    minus (k+1)-th probability is below 1e-4 in one of the runs.  It also
    prints, at each request's first position off, the flips there
    with both runs' gaps, the gaps at flips against all gaps, and the
    elements beyond tolerance at positions whose own routing agrees at
    every layer."""
    import numpy as np
    import torch

    tag = run[2]
    (sel_a, gap_a), (sel_b, gap_b) = run[4], base[4]
    beyond = cone_beyond = agree_beyond = agree_elems = n_elems = 0
    flip_gaps, root_gaps, all_gaps, firsts = [], [], [], []
    n_flips = n_agree = n_pos = 0
    for i, (ka, kb) in enumerate(zip(run[1], base[1])):
        L, n = ka["k"].shape[:2]
        bad = torch.zeros((L, n), dtype=torch.int64, device=ka["k"].device)
        for nm in ("k", "v"):
            d = (ka[nm] - kb[nm]).abs() > 2e-2 + 2e-2 * kb[nm].abs()
            bad += d.flatten(2).sum(-1)
        bad = bad.cpu().numpy()  # [L, n] elements beyond tolerance
        per = 2 * ka["k"][0, 0].numel()  # K/V elements of one (layer, pos)
        flip = (sel_a[i, :, :n] != sel_b[i, :, :n]).any(-1)  # [L, n]
        check((sel_a[i, :, :n] >= 0).all() and (sel_b[i, :, :n] >= 0).all(),
              f"{tag}: request {i}: a written position has no routing")
        # a flip at (l', p') reaches layers > l' at positions >= p'
        reach = np.logical_or.accumulate(
            np.logical_or.accumulate(flip, axis=0), axis=1)
        cone = np.zeros_like(reach)
        cone[1:] = reach[:-1]
        agree = ~flip.any(0)  # positions whose own routing agrees
        beyond += int(bad.sum())
        cone_beyond += int(bad[~cone].sum())
        agree_beyond += int(bad[:, agree].sum())
        agree_elems += int(agree.sum()) * L * per
        n_elems += L * n * per
        n_flips += int(flip.sum())
        n_agree += int(agree.sum())
        n_pos += n
        both = np.minimum(gap_a[i, :, :n], gap_b[i, :, :n])
        all_gaps.append(both.ravel())
        flip_gaps += both[flip].tolist()
        root_gaps += both[flip & ~cone].tolist()  # no flip upstream of it
        off = np.nonzero(bad.any(0))[0]
        if len(off):
            p = int(off[0])
            lb = int(np.nonzero(bad[:, p])[0][0])
            ls, ps = np.nonzero(flip[:lb, :p + 1])  # the flips reaching it
            near = sorted(zip(ps.tolist(), ls.tolist()), reverse=True)[:3]
            firsts.append((i, p, lb, [(q, l, float(gap_a[i, l, q]),
                                       float(gap_b[i, l, q]))
                                      for q, l in near]))
    all_gaps = np.concatenate(all_gaps)
    log(f"{tag}: float32 TP={TP} against TP=1: {n_flips} (layer, position) "
        f"router flips (top-k sets differ) over {n_pos} positions x "
        f"{sel_a.shape[1]} layers; {beyond} of {n_elems} K/V elements beyond "
        f"2e-2 + 2e-2|x|, {cone_beyond} of them outside every flip's "
        f"downstream")
    if flip_gaps:
        q = np.quantile(all_gaps, [0.01, 0.5])
        log(f"{tag}: k-th minus (k+1)-th router probability, the smaller "
            f"of the two runs': at flips max {max(flip_gaps):.3g}, median "
            f"{float(np.median(flip_gaps)):.3g}; at the {len(root_gaps)} "
            f"flips no other flip reaches max {max(root_gaps):.3g}; over all "
            f"(layer, position) 1% quantile {q[0]:.3g}, median {q[1]:.3g}")
    for i, p, lb, near in firsts:
        log(f"{tag}: request {i}: first K/V off at position {p}, layer {lb}; "
            f"the nearest flips reaching it (position, layer, gap TP={TP}, "
            f"gap TP=1): "
            f"{[(q, l, f'{a:.3g}', f'{b:.3g}') for q, l, a, b in near]}")
    log(f"{tag}: at the {n_agree} positions whose own routing agrees at "
        f"every layer: {agree_beyond} of {agree_elems} K/V elements beyond "
        f"tolerance")
    check(cone_beyond == 0, f"{tag} float32: {cone_beyond} K/V elements "
          f"beyond tolerance where no router flip reaches")
    # a flip no other flip reaches saw inputs equal up to rounding, so it
    # must sit at a near tie: a wrong router or expert split would flip
    # wide margins too (the median gap is ~1e-3 at olmoe's random init)
    widest = max(root_gaps, default=0.0)
    check(widest < 1e-4, f"{tag} float32: a router flip no other flip "
          f"reaches has a gap of {widest:.3g}, wider than rounding can cross")


def engine_phase(results, name, tp=1, dtype="bfloat16", arch="olmo-1b",
                 record=(), routes=False):
    """Serve the 8 requests on full-width ``arch`` with ``dtype`` weights;
    ``tp`` > 1 serves them on ``tp`` shards of this card (over replicated
    arena copies where ``tp`` does not divide the KV heads: then the copies
    must be bitwise equal after the run, each the whole arena's bytes).
    ``record`` names the ``results`` rows whose ``launches`` take this
    run's counts.  Returns (generated tokens, per request the K/V of every
    position it wrote — read just before its last step —, the phase's tag,
    prompt lengths, and with ``routes`` the MoE routing of every position:
    :func:`routes_by_position`)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_sharded)
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    gc.collect()  # an earlier phase's engine (a reference cycle) and weights
    torch.cuda.empty_cache()
    tag = ("engine" if arch == "olmo-1b" else arch) + (
        "" if tp == 1 else f" tp={tp}") + (
        "" if dtype == "bfloat16" else f" {dtype}")
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_decoder_lm(cfg, seed=0, dtype=getattr(torch, dtype),
                             device="cuda")
    where = (dict(device="cuda") if tp == 1 else
             dict(tensor_parallel=tp, devices=["cuda:0"] * tp))
    eng = PagedServingEngine(cfg, params, num_pages=512, page_size=16,
                             max_batch=8, prefill_chunk=16, **where)
    del params  # under tp the engine holds its own shard copies
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 257, 8)]
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}"
           if cfg.moe else "")
    log(f"{tag}: {arch} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"{cfg.n_kv_heads} KV heads, vocab {cfg.vocab_padded}{moe}), set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    sched = eng.scheduler
    # every kernel wrapper's count, and what one step must add to it: the
    # fused launch once per layer and shard (counted by kernel 1's wrapper
    # too, which it launches through), the standalone append never
    counters = {paged_attention_cuda: tp * cfg.n_layers,
                paged_attention_append_cuda: tp * cfg.n_layers,
                kv_append_cuda: 0,
                paged_attention_sharded: (tp if tp > 1 else 0) * cfg.n_layers}
    for fn in counters:
        fn.launches = 0
    steps = steady = transfers = 0
    kv_rows = {}
    untimed = 0.0
    records = []
    index = {id(r): i for i, r in enumerate(reqs)}
    trace = (route_trace(records, lambda: {r.slot: index[id(r)]
                                           for r in sched.running})
             if routes else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace:
        while True:
            sched.admit()
            if not sched.running and not sched.queue:
                break
            last = [r for r in sched.running if id(r) not in kv_rows
                    and len(r.generated) == r.max_new_tokens - 1]
            if last:  # reads between steps, before the rows are freed
                t1 = time.perf_counter()
                kv_rows.update((id(r), row_kv(eng, r)) for r in last)
                torch.cuda.synchronize()
                untimed += time.perf_counter() - t1
            before = {fn: fn.launches for fn in counters}
            is_steady = (not sched.queue and all(
                r.committed >= len(r.prompt)
                and len(r.generated) + 2 < r.max_new_tokens
                for r in sched.running))
            if is_steady:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        eng.step()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = [w for w in caught
                         if "called a synchronizing" in str(w.message)]
                check(len(syncs) == 1, f"{tag}: steady step {steps} made "
                      f"{len(syncs)} device->host transfers: "
                      f"{[str(w.message)[:80] for w in syncs]}")
                steady += 1
                transfers += len(syncs)
            else:
                eng.step()
            sched.maintain()
            steps += 1
            got = {fn.__name__: fn.launches - before[fn] for fn in counters}
            check(all(fn.launches - before[fn] == n
                      for fn, n in counters.items()),
                  f"{tag} step {steps}: kernel launches {got}, want "
                  f"{ {fn.__name__: n for fn, n in counters.items()} }")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - untimed
    launches = {fn.__name__: fn.launches for fn in counters}
    rows = {"paged_attention": paged_attention_cuda,
            "kv_append": kv_append_cuda,
            "paged_attention_append": paged_attention_append_cuda,
            "paged_attention_sharded": paged_attention_sharded}
    for key in record:
        results[key]["launches"] = rows[key].launches

    st = eng.stats
    gen = sum(len(r.generated) for r in reqs)
    check(all(r.state == "finished" for r in reqs),
          f"{tag}: a request did not finish")
    check(all(len(r.generated) == 32 for r in reqs), f"{tag}: short generation")
    check(all(0 <= t < cfg.vocab_padded for r in reqs for t in r.generated),
          f"{tag}: token id out of range")
    clock = int(eng.pool.clock.cpu())
    check(st.warnings_fired == clock,
          f"{tag}: clock mirror {st.warnings_fired} != pool clock {clock}")
    check(steady >= 4, f"{tag}: only {steady} steady steps were checked")
    log(f"{tag}: {len(reqs)} requests finished, {steps} steps, "
        f"{gen} generated tokens, warnings_fired == clock == {clock}, "
        f"{steady} steady steps with {transfers} device->host transfers, "
        f"launches {json.dumps(launches)}")
    log(f"{tag}: {gen / wall:.1f} generated tokens/s, "
        f"{1e3 * wall / steps:.2f} ms/step, on {name}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    if tp > 1 and eng.kv_manager.kv_replicated:
        whole = 2 * cfg.n_layers * 512 * 16 * cfg.n_kv_heads * cfg.head_dim \
            * eng.kv[0]["k"].element_size()
        per = [sum(c[n].numel() * c[n].element_size() for n in ("k", "v"))
               for c in eng.kv]
        check(all(p == whole for p in per), f"{tag}: shard arena bytes {per}, "
              f"want the whole arena's {whole} each")
        check(all(torch.equal(c[n], eng.kv[0][n]) for c in eng.kv[1:]
                  for n in ("k", "v")),
              f"{tag}: the shards' replicated arena copies differ")
        log(f"{tag}: {tp} replicated arena copies of {whole / 2**20:.1f} MiB "
            f"each (the whole arena), bitwise equal after the run")
    tokens = [list(r.generated) for r in reqs]
    check(all(id(r) in kv_rows for r in reqs),
          f"{tag}: a request's K/V was not read before its last step")
    return (tokens, [kv_rows[id(r)] for r in reqs], tag,
            [len(r.prompt) for r in reqs],
            routes_by_position(records, cfg, len(reqs), tag)
            if routes else None)


# ---------------------------------------------------------------------------
# phase 5: the serving fleet

FLEET_KW = dict(num_pages=512, page_size=16, max_batch=8, prefill_chunk=16)
CHAOS = dict(grant_denial_p=0.1, spurious_invalid_p=0.05, delayed_free_p=0.1,
             unmap_under_reader_p=0.05)
ON_CARD = ["cuda:0", "cuda:0"]  # two replicas, or two shards, on this card


def kernel_wrappers():
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_cuda,
        paged_attention_sharded)
    return (paged_attention_cuda, paged_attention_append_cuda,
            kv_append_cuda, paged_attention_sharded)


def want_launches(layers, steps, shards=1):
    """Each wrapper's launches for ``steps`` engine steps of a model of
    ``layers`` layers at ``shards`` shards: the fused launch once per
    layer and shard (kernel 1's wrapper counts it too), kernel 3 once per
    layer and shard under tensor parallelism, the standalone append
    never."""
    n = layers * shards * steps
    return dict(zip((fn.__name__ for fn in kernel_wrappers()),
                    (n, n, 0, n if shards > 1 else 0)))


def reset_launches():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches(tag, layers, steps, shards=1):
    """The counts of the path just driven (set to 0 just before it): each
    wrapper exactly :func:`want_launches`, the fused launch at least once."""
    got = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    want = want_launches(layers, steps, shards)
    check(got == want and steps > 0,
          f"{tag}: kernel launches {got}, want {want} ({steps} steps)")
    return got


def fleet_steps(fleet, tag, layers, shards=1):
    """Drive ``fleet`` to a drain in ``step()`` mode, one thread: every
    fleet step must add :func:`want_launches` for the replicas that
    stepped, and a steady step (nothing queued, every row decoding and two
    or more tokens from its end) exactly one device->host transfer per
    replica at work.  Returns (fleet steps, steady steps)."""
    import torch

    wrappers = kernel_wrappers()
    n = steady = 0
    while not fleet.drained():
        live = [e for e, a in zip(fleet.replicas, fleet.alive) if a]
        working = sum(bool(e.scheduler.running) for e in live)
        is_steady = working and all(
            not e.scheduler.queue and all(
                r.committed >= len(r.prompt)
                and len(r.generated) + 2 < r.max_new_tokens
                for r in e.scheduler.running) for e in live)
        steps = [e.stats.steps for e in live]
        before = {fn: fn.launches for fn in wrappers}
        if is_steady:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fleet.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in caught
                     if "called a synchronizing" in str(w.message)]
            check(len(syncs) == working, f"{tag}: steady fleet step {n} "
                  f"made {len(syncs)} device->host transfers for {working} "
                  f"replicas at work: "
                  f"{[str(w.message)[:80] for w in syncs]}")
            steady += 1
        else:
            fleet.step()
        stepped = [e.stats.steps - s for e, s in zip(live, steps)]
        check(set(stepped) <= {0, 1}, f"{tag}: replica steps {stepped}")
        got = {fn.__name__: fn.launches - before[fn] for fn in wrappers}
        want = want_launches(layers, sum(stepped), shards)
        check(got == want, f"{tag} fleet step {n}: kernel launches {got}, "
              f"want {want}")
        n += 1
        check(n < 5000, f"{tag}: the fleet did not drain")
    return n, steady


def mirrors_hold(tag, engines):
    """The clock mirror per replica.  Under chaos, as in the reference's
    chaos layer: the frees it still defers are applied first (the default
    policy's end-of-drain flush does not reach it), and the clock ticks of
    its spontaneous releases, made behind the KV manager, are added to the
    mirror."""
    for i, e in enumerate(engines):
        alloc = e.kv_manager.allocator
        ticks = 0
        if hasattr(alloc, "faults"):
            alloc.flush()
            ticks = alloc.unmap_clock_ticks
        clock = int(e.pool.clock.cpu())
        check(e.stats.warnings_fired + ticks == clock,
              f"{tag}: replica {i} clock mirror {e.stats.warnings_fired} + "
              f"{ticks} spontaneous releases != pool clock {clock}")


def timed(fn):
    """(fn(), its wall seconds, ending when the card is idle)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kill_after(n):
    """A step hook that raises on replica 0's ``n``-th driver iteration."""
    calls = [0]

    def hook(_eng):
        calls[0] += 1
        if calls[0] == n:
            raise RuntimeError(f"injected kill at driver iteration {n}")
    return hook


def prefix_equal(run, base):
    """Tokens of ``run`` equal to ``base``'s before each request's first
    difference, and their total."""
    same = sum(next((i for i, (x, y) in enumerate(zip(p, q)) if x != y),
                    min(len(p), len(q))) for p, q in zip(run, base))
    return same, sum(map(len, base))


def fleet_failover(cfg, params, prompts, tag, kill_at=20, **kw):
    """A warmed 2-replica fleet with ``auto_revive``: replica 0 is killed at
    its ``kill_at``-th driver iteration while it serves ``prompts`` (32 new
    tokens each).  Returns (fleet, requests, requests first routed to
    replica 0, wall seconds, every engine that served)."""
    from repro_torch.serving import DataParallelEngine, WatchdogConfig

    fleet = DataParallelEngine(
        cfg, params, replicas=2, devices=ON_CARD,
        watchdog=WatchdogConfig(auto_revive=True), **{**FLEET_KW, **kw})
    warm = [fleet.submit(p[:16], 2) for p in prompts[:2]]
    fleet.run()  # warm (first steps) before the watchdog times anything
    check(all(r.state == "finished" for r in warm), f"{tag}: warm-up")
    s0 = fleet.stats.steps
    reqs = [fleet.submit(p, 32) for p in prompts]
    victims = [r for r in reqs if r._engine is fleet.replicas[0]]
    engines = list(fleet.replicas)
    fleet.step_hooks[0] = kill_after(kill_at)
    reset_launches()
    _, wall = timed(fleet.run)
    read_launches(tag, cfg.n_layers, fleet.stats.steps - s0)
    engines.append(fleet.replicas[0])  # the revived replica
    st = fleet.stats
    check(all(r.state == "finished" for r in reqs), f"{tag}: a request was "
          f"lost ({[r.state for r in reqs]})")
    check(st.replica_failures == 1 and st.replica_revivals == 1,
          f"{tag}: {st.replica_failures} failures, {st.replica_revivals} "
          f"revivals, want 1 and 1")
    check(st.requests_migrated >= len(victims) > 0,
          f"{tag}: {st.requests_migrated} requests migrated, "
          f"{len(victims)} were on the killed replica")
    return fleet, reqs, victims, wall, engines


def fleet_phase(name):
    """Phase 5: full-width olmo-1b served by ``DataParallelEngine`` fleets
    on this card, then open-loop replay and the serving CLI (module
    docstring).  Nothing here is caught."""
    import gc

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import ChaosConfig
    from repro_torch.launch.serve import _replay_trace, main as serve_main
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                     dump_trace, synthesize_trace)

    cfg = get_config("olmo-1b")
    L = cfg.n_layers
    sixteen = fleet_requests(cfg)

    def single(params, tag, **where):
        """One engine (on this card, or as ``where`` says) serving the 16
        requests (32 new tokens each), timed."""
        eng = PagedServingEngine(cfg, params, **(where or {"device": "cuda"}),
                                 **FLEET_KW)
        reqs = [eng.submit(p, 32) for p in sixteen]
        reset_launches()
        _, wall = timed(eng.run)
        read_launches(tag, L, eng.stats.steps, eng.tensor_parallel)
        check(all(r.state == "finished" for r in reqs), f"{tag}: unfinished")
        mirrors_hold(tag, [eng])
        return [list(r.generated) for r in reqs], wall, eng.stats.steps

    # -- (a) bf16, the main path: 2 replicas on this card -------------------
    gc.collect()
    torch.cuda.empty_cache()
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    check(len({e.params.embed["tok"].data_ptr() for e in fleet.replicas})
          == 1, "fleet (a): replicas on one card must share the weights")
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (a) step()", L)
    launches = read_launches("fleet (a) step()", L, fleet.stats.steps)
    check(steady >= 4, f"fleet (a): only {steady} steady fleet steps")
    check(all(r.state == "finished" for r in reqs), "fleet (a): unfinished")
    mirrors_hold("fleet (a) step()", fleet.replicas)
    step_tokens = [list(r.generated) for r in reqs]
    log(f"fleet (a) bf16 step(): 2 replicas on one card, 16 requests, {n} "
        f"fleet steps, {steady} steady with one read per replica each, "
        f"replica steps {[e.stats.steps for e in fleet.replicas]}, "
        f"launches {json.dumps(launches)}")
    base, wall1, steps1 = single(params, "fleet (a) single engine")
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    _, wall2 = timed(fleet.run)
    run_steps = fleet.stats.steps
    launches = read_launches("fleet (a) run()", L, run_steps)
    check(all(r.state == "finished" for r in reqs), "fleet (a): unfinished")
    mirrors_hold("fleet (a) run()", fleet.replicas)
    check([list(r.generated) for r in reqs] == step_tokens,
          "fleet (a): threaded run() and step() generate different tokens")
    # the same drain from one thread in step() mode, timed: what the two
    # driver threads cost beyond it
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    reqs = [fleet.submit(p, 32) for p in sixteen]

    def drain():
        while not fleet.drained():
            fleet.step()
    reset_launches()
    _, wall3 = timed(drain)
    read_launches("fleet (a) timed step()", L, fleet.stats.steps)
    check([list(r.generated) for r in reqs] == step_tokens,
          "fleet (a): two step() drains generate different tokens")
    gen = 16 * 32
    log(f"fleet (a) bf16 run(): 2 driver threads, {run_steps} "
        f"replica steps, launches {json.dumps(launches)}; generated "
        f"tokens/s on the same 16 requests: fleet run() {gen / wall2:.1f}, "
        f"fleet step() from one thread {gen / wall3:.1f}, one engine "
        f"{gen / wall1:.1f} ({steps1} steps; run() {wall2 / wall1:.3f}x and "
        f"step() {wall3 / wall1:.3f}x its wall time), on {name}")
    same, total = prefix_equal(step_tokens, base)
    log(f"fleet (a): {same} of {total} bf16 fleet tokens equal the single "
        f"engine's before each request's first difference")
    _, reqs, victims, wall, _ = fleet_failover(
        cfg, params, sixteen, "fleet (b) bf16 failover")
    same, total = prefix_equal([r.output_tokens for r in reqs], base)
    log(f"fleet (b) bf16 failover: {len(victims)} requests on the killed "
        f"replica, {same} of {total} stitched tokens equal the single "
        f"engine's before each request's first difference (not held: bf16 "
        f"meets near ties)")

    # -- (c) bf16 chaos: step() on the roomy pool, then a kill on 64 pages --
    fault_engines = []
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               chaos=ChaosConfig(seed=1, **CHAOS), **FLEET_KW)
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (c) chaos step()", L)
    read_launches("fleet (c) chaos step()", L, fleet.stats.steps)
    check(steady >= 1, f"fleet (c): only {steady} steady fleet steps")
    check(all(r.state == "finished" for r in reqs), "fleet (c): unfinished")
    mirrors_hold("fleet (c) chaos step()", fleet.replicas)
    fault_engines += fleet.replicas
    log(f"fleet (c) chaos step(): {n} fleet steps, {steady} steady with one "
        f"read per replica each, faults "
        f"{[e.kv_manager.allocator.faults for e in fleet.replicas]}")
    # 64 pages a replica (1024 tokens for 8 rows of up to 288): ~45
    # preemptions over the 16 requests, so every fault kind fires; at 96
    # pages the pool churned only 5-10 times and a kind could fire never
    tight = dict(num_pages=64)
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **{**FLEET_KW, **tight})
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    _, wall0 = timed(fleet.run)
    read_launches("fleet (c) fault-free", L, fleet.stats.steps)
    check(all(r.state == "finished" for r in reqs), "fleet (c): unfinished")
    pre0 = fleet.stats.preemptions
    fleet, reqs, victims, wall, engines = fleet_failover(
        cfg, params, sixteen, "fleet (c) chaos + kill",
        chaos=ChaosConfig(seed=11, **CHAOS), **tight)
    mirrors_hold("fleet (c) chaos + kill", fleet.replicas)
    fault_engines += engines
    faults = {k: sum(e.kv_manager.allocator.faults[k] for e in fault_engines)
              for k in fault_engines[0].kv_manager.allocator.faults}
    check(all(v > 0 for v in faults.values()),
          f"fleet (c): a fault kind never fired: {faults}")
    gen = 16 * 32
    log(f"fleet (c) chaos + kill, 64 pages a replica, 16 requests: 0 lost, "
        f"faults {json.dumps(faults)}, {fleet.stats.preemptions} "
        f"preemptions (fault-free {pre0}), {fleet.stats.requests_migrated} "
        f"migrated; goodput {gen / wall:.1f} tokens/s against "
        f"{gen / wall0:.1f} fault-free ({wall0 / wall:.3f}x), on {name}")

    # -- (e) open-loop replay of a bursty two-class trace at ~0.6x ----------
    rate = 0.6 * 16 / wall1
    events = synthesize_trace(7, duration_s=10.0, rate_rps=rate,
                              process="bursty",
                              class_mix={"interactive": 0.7, "batch": 0.3},
                              prompt_mean=128, prompt_cap=256,
                              max_new_mean=32, max_new_cap=64)
    eng = PagedServingEngine(cfg, params, device="cuda", **FLEET_KW)
    reset_launches()
    reqs, wall = timed(lambda: _replay_trace(eng, events, cfg.vocab))
    read_launches("fleet (e) replay", L, eng.stats.steps)
    lost = sum(r.state not in ("finished", "shed", "rejected") for r in reqs)
    check(lost == 0 and len(reqs) == len(events),
          f"fleet (e): {lost} of {len(reqs)} requests lost")
    mirrors_hold("fleet (e) replay", [eng])
    log(f"fleet (e) open-loop replay: {len(events)} arrivals in 10 s at "
        f"{rate:.2f} req/s (0.6x the single engine's {16 / wall1:.2f}), "
        f"drained in {wall:.1f} s, 0 lost, on {name}")
    for cls, cs in sorted(eng.stats.class_stats.items()):
        p = cs.percentiles()
        log(f"fleet (e) class {cls}: finished {cs.finished}/{cs.submitted}, "
            f"shed {cs.shed}, rejected {cs.rejected}, TTFT p50 "
            f"{p['ttft_p50']:.4f} s, p95 {p['ttft_p95']:.4f} s, p99 "
            f"{p['ttft_p99']:.4f} s")
    del params, fleet, eng, reqs, victims, engines, fault_engines

    # -- (b) float32 failover, token-exact; (d) the float32 2D fleet --------
    gc.collect()
    torch.cuda.empty_cache()
    params = init_decoder_lm(cfg, seed=0, dtype=torch.float32, device="cuda")
    base32, _, _ = single(params, "fleet (b) float32 single engine")
    _, reqs, victims, _, _ = fleet_failover(
        cfg, params, sixteen, "fleet (b) float32 failover")
    check([r.output_tokens for r in reqs] == base32,
          f"fleet (b): float32 stitched tokens differ from one engine's "
          f"({prefix_equal([r.output_tokens for r in reqs], base32)})")
    check(all(r.migrations == 1 for r in victims),
          "fleet (b): a request of the killed replica did not migrate")
    log(f"fleet (b) float32 failover: replica 0 killed at its 20th "
        f"iteration, {len(victims)} requests migrated and re-prefilled, "
        f"1 failure, 1 revival, stitched tokens == one engine's "
        f"({sum(map(len, base32))} tokens)")
    # the 2D fleet against one TP=2 engine: the fleet layer must change no
    # token.  TP=2 against TP=1 is the engine phase's check; over these 16
    # requests float32 TP=2 can meet a near tie against TP=1 (the bf16
    # arena rounds the two reductions' K/V apart; 508 of 512 tokens equal
    # on an H100), so agreement with TP=1 is printed here, not held
    base_tp, _, _ = single(params, "fleet (d) float32 TP=2 engine",
                           tensor_parallel=2, devices=ON_CARD)
    fleet = DataParallelEngine(cfg, params, replicas=2, tensor_parallel=2,
                               devices=ON_CARD * 2, **FLEET_KW)
    del params  # each replica holds its own shard copies
    reqs = [fleet.submit(p, 32) for p in sixteen]
    reset_launches()
    n, steady = fleet_steps(fleet, "fleet (d) 2D", L, shards=2)
    launches = read_launches("fleet (d) 2D", L, fleet.stats.steps, shards=2)
    mirrors_hold("fleet (d) 2D", fleet.replicas)
    tokens = [list(r.generated) for r in reqs]
    check(tokens == base_tp, f"fleet (d): the 2D fleet's float32 tokens "
          f"differ from one TP=2 engine's "
          f"({prefix_equal(tokens, base_tp)})")
    same, total = prefix_equal(tokens, base32)
    log(f"fleet (d) float32 2 replicas x TP=2 on one card: tokens == one "
        f"TP=2 engine's ({total}); {same} of {total} equal TP=1's before "
        f"each request's first difference; {n} fleet steps ({steady} "
        f"steady, one read per replica each), 2 x 16 shard launches per "
        f"replica step, launches {json.dumps(launches)}")
    del fleet, reqs, victims
    gc.collect()
    torch.cuda.empty_cache()

    # -- (f) the serving CLI at its reduced size, on the card ---------------
    reduced_layers = reduced(cfg).n_layers
    trace = ROOT / "build" / "chip_smoke_trace.jsonl"
    trace.parent.mkdir(parents=True, exist_ok=True)
    dump_trace(synthesize_trace(3, duration_s=1.0, rate_rps=8.0,
                                class_mix={"interactive": 0.6, "batch": 0.4},
                                prompt_mean=5, max_new_mean=3, prompt_cap=8,
                                max_new_cap=4), str(trace))
    tiny = ["--num-pages", "24", "--page-size", "4", "--max-batch", "2",
            "--prompt-len", "6", "--max-new", "3"]
    for argv in (["--requests", "4", "--replicas", "2"] + tiny,
                 ["--requests", "3", "--classes", "interactive:0.7,batch:0.3",
                  "--stream"] + tiny,
                 ["--num-pages", "32", "--page-size", "4", "--max-batch", "2",
                  "--trace", str(trace)]):
        reset_launches()
        st = serve_main(argv)  # asserts zero lost itself
        read_launches(f"cli {argv[:2]}", reduced_layers, st.steps)
    log("cli: --replicas 2, --classes --stream and --trace served on the "
        "card at the reduced size, 0 lost")
    return {"one engine": wall1, "fleet run()": wall2, "fleet step()": wall3}


def fleet_requests(cfg):
    """The fleet phase's 16 prompts of 64-256 tokens."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, int(n)).tolist()
            for n in rng.integers(64, 257, 16)]


def profile_fleet(name, walls):
    """``--profile``: the device time of the bf16 fleet's drain of the 16
    requests (2 replicas on this card, ``step()`` from one thread; the
    device work of ``run()`` is the same launches), beside the unprofiled
    wall times of the fleet phase (a): the share of each the card is busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import DataParallelEngine

    cfg = get_config("olmo-1b")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
    fleet = DataParallelEngine(cfg, params, replicas=2, devices=ON_CARD,
                               **FLEET_KW)
    for p in fleet_requests(cfg):
        fleet.submit(p, 32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while not fleet.drained():
            fleet.step()
        torch.cuda.synchronize()
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")) / 1e6
    log(f"profile fleet: the 16-request drain holds {busy:.3f} s of device "
        f"time on {name}; busy " + ", ".join(
            f"{100 * busy / w:.1f}% of {k}'s {w:.2f} s"
            for k, w in walls.items()))


#: substrings of the matrix-product kernels' names (cuBLAS, cuBLASLt, CUTLASS)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def device_rows(fn, calls):
    """(device ms per call, launches per call, name) of every device op of
    ``calls`` calls of ``fn``, from one torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev / 1e3 / calls, ev.count / calls, ev.key))
    return rows


def profile_phase(name, tp=1, steps=5, arch="olmo-1b"):
    """``--profile``: a torch.profiler trace of ``steps`` steady decode steps
    of the full-width engine at ``tp`` shards (a fresh one, after the main
    path's counts were read): wall and device-busy time per step, and the
    kernels that take the device time.  For an MoE model also the expert
    layer alone at the step's shapes (decode, and a 16-token prefill
    chunk): its device time per step and its matrix products' share."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    where = (dict(device="cuda") if tp == 1 else
             dict(tensor_parallel=tp, devices=["cuda:0"] * tp))
    eng = PagedServingEngine(cfg, params, num_pages=512, page_size=16,
                             max_batch=8, prefill_chunk=16, **where)
    del params
    rng = np.random.default_rng(1)
    for n in rng.integers(64, 257, 8):
        eng.submit(rng.integers(0, cfg.vocab, int(n)).tolist(), 64)
    eng.scheduler.admit()
    while any(r.committed < len(r.prompt) for r in eng.scheduler.running):
        eng.step()
    for _ in range(3):  # warm the decode path
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # wall time without the profiler
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = device_rows(eng.step, steps)
    busy = sum(r[0] for r in rows)
    tag = f"profile {arch} tp={tp}"
    log(f"{tag}: {steps} steady decode steps on {name}: {wall:.2f} ms/step "
        f"wall (unprofiled), {busy:.2f} ms/step of device time in "
        f"{sum(r[1] for r in rows):.0f} device ops ({100 * busy / wall:.1f}% "
        f"busy)")
    attn = sum(r[0] for r in rows if "paged_attention_kernel" in r[2])
    n_attn = sum(r[1] for r in rows if "paged_attention_kernel" in r[2])
    log(f"{tag}: kernel 1 with the fused append {attn:.3f} ms/step in "
        f"{n_attn:.0f} launches, {100 * attn / busy:.1f}% of the device time")
    check(not any("kv_append_kernel" in r[2] for r in rows),
          f"{tag}: a standalone kv_append launch in the steady step")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")
    if not cfg.moe or tp != 1:
        return
    moe = eng.params.blocks[0].moe
    for C in (1, 16):
        h = torch.randn((8, C, cfg.d_model), device="cuda").to(torch.bfloat16)
        layer = device_rows(lambda: moe_apply(cfg, h, moe, dropless=True), 10)
        total = sum(r[0] for r in layer)
        gemm = sum(r[0] for r in layer
                   if any(g in r[2] for g in GEMM_NAMES))
        rows_ = 8 * cfg.n_experts * C * cfg.top_k
        flops = 2 * 3 * rows_ * cfg.d_model * cfg.d_ff
        log(f"{tag}: expert layer at C={C} (8 rows, dropless capacity "
            f"{C * cfg.top_k} a row and expert): {total:.3f} ms a layer, "
            f"{cfg.n_layers * total:.3f} ms a step"
            + (f" ({100 * cfg.n_layers * total / busy:.1f}% of the steady "
               f"step's device time)" if C == 1 else "")
            + f"; matrix products {gemm:.3f} ms ({100 * gemm / total:.1f}%), "
            f"{flops / 1e9:.1f} GFLOP of padded expert products a layer "
            f"({flops / gemm / 1e9:.1f} TFLOP/s)")
        for ms, count, key in sorted(layer, reverse=True)[:6]:
            log(f"  {ms:8.3f} ms/layer  {count:4.0f}/layer  {key[:90]}")


def sass_check():
    """What the paged-attention library compiled to: which kernel
    instantiations issue tensor-core (HMMA) and cp.async (LDGSTS)
    instructions, from ``cuobjdump -sass`` where the toolkit has it."""
    from repro_torch.kernels import build

    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        log("sass: no cuobjdump in the toolkit; not checked")
        return
    sass = subprocess.run([str(tool), "-sass", str(build._target(
        "paged_attention"))], capture_output=True, text=True,
        check=True).stdout
    funcs = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = {"HMMA": 0, "LDGSTS": 0}
        elif name is not None:
            for op in ("HMMA", "LDGSTS"):
                funcs[name][op] += f" {op}" in line
    kern = {n: c for n, c in funcs.items() if "paged_attention_kernel" in n}
    # the fused-append instantiations: kAppend = true, mangled Lb1E
    n_append = sum("Lb1E" in n or ", true>" in n for n in kern)
    check(n_append == 15 and len(kern) == 35,
          f"want 35 paged_attention_kernel instantiations, 15 of them with "
          f"the append: {len(kern)}, {n_append}")
    mma = [n for n, c in kern.items() if c["HMMA"]]
    # the bf16 x bf16 instantiations: mangled, the bf16 type named for TQ
    # and substituted for T; or demangled
    bf16 = [n for n in kern if "I13__nv_bfloat16S" in n
            or "__nv_bfloat16, __nv_bfloat16" in n]
    log(f"sass: {len(kern)} paged_attention_kernel instantiations "
        f"({n_append} with the append); HMMA in "
        f"{len(mma)} ({sum(kern[n]['HMMA'] for n in mma)} instructions), "
        f"LDGSTS in {sum(1 for c in kern.values() if c['LDGSTS'])}")
    check(sorted(mma) == sorted(bf16) and mma,
          f"tensor-core instructions must be in exactly the bf16 x bf16 "
          f"instantiations: HMMA in {mma}, bf16 x bf16 {bf16}")
    check(all(c["LDGSTS"] for c in kern.values()),
          "every instantiation must load through cp.async (LDGSTS)")


def tp_phase(results, name, arch, record=False):
    """Full-width ``arch`` served four times (float32 and bf16 weights, each
    at TP=1 and at ``tensor_parallel=TP`` on this card; module docstring,
    phase 4), then held across runs.  float32 TP=2 against TP=1: the tokens
    must be equal, and the K/V of every position written within 2e-2 +
    2e-2|x| — for MoE, wherever no router flip reaches
    (:func:`routing_check`).  bf16: TP=2's K/V must stay within 1.25x of
    TP=1's distance from float32, at the positions where both still feed
    the model float32's tokens.  With ``record`` the bf16 TP=1 run gives
    kernels 1 and 2 and the fused launch their ``launches``, the bf16 TP=2
    run kernel 3's."""
    from repro_torch.configs import get_config

    moe = get_config(arch).moe
    f32 = engine_phase(results, name, dtype="float32", arch=arch, routes=moe)
    f32_tp = engine_phase(results, name, tp=TP, dtype="float32", arch=arch,
                          routes=moe)
    one = engine_phase(results, name, arch=arch, record=(
        ("paged_attention", "kv_append", "paged_attention_append")
        if record else ()))
    tp = engine_phase(results, name, tp=TP, arch=arch, record=(
        ("paged_attention_sharded",) if record else ()))
    tag = tp[2]
    # in float32 the two reductions round ~1e-7 apart and the arena's bf16
    # rounding turns that into a K/V element one bf16 step apart now and
    # then; random weights meet near ties
    full = [kv["k"].shape[1] - plen for kv, plen in zip(f32[1], f32[3])]
    agree = first_divergence(f32_tp, f32)
    log(f"{tag}: float32 TP={TP} tokens equal TP=1's before each request's "
        f"first difference: {sum(agree)} of {sum(map(len, f32[0]))} (at "
        f"{agree})")
    check(f32_tp[0] == f32[0], f"{tag} float32: TP={TP} tokens differ from "
          f"TP=1's (equal before divergences: {agree})")
    dist = kv_distance(f32_tp, f32, full)
    if moe:
        # such a one-bf16-step difference moves a router's k-th choice
        # where its k-th and (k+1)-th probabilities nearly tie (ROADMAP C)
        routing_check(f32_tp, f32)
    else:
        check(all(b == 0 for _, b, _ in dist.values()),
              f"{tag} float32: TP={TP} K/V differ from TP=1's beyond "
              f"tolerance: {dist}")
    # in bf16 the row-parallel partials round apart, and greedy decoding
    # over random weights meets near ties, so tokens are counted, not held;
    # what is held is that TP=2 stays as close to float32 as TP=1 does, in
    # prefill and in decode, at the positions where both still feed the
    # model float32's tokens
    depth = [min(a, b, n) for a, b, n in zip(first_divergence(one, f32),
                                              first_divergence(tp, f32), full)]
    check(sum(depth) > 0, f"{tag} bf16: no generated position of TP=1 and "
          f"TP={TP} shares float32's tokens")
    d_one, d_tp = kv_distance(one, f32, depth), kv_distance(tp, f32, depth)
    same = first_divergence(tp, one)
    log(f"{tag}: {sum(same)} of {sum(map(len, one[0]))} bf16 tokens equal "
        f"TP=1's before each request's first divergence (at {same})")
    for part in ("prompt", "decode"):
        e1, e2 = d_one[part][0], d_tp[part][0]
        check(e2 <= 1.25 * e1, f"{tag}: bf16 TP={TP} {part} K/V are {e2:.4g} "
              f"from float32 against TP=1's {e1:.4g} (limit 1.25x)")
        log(f"{tag}: bf16 {part} K/V {e2:.4g} from float32 against TP=1's "
            f"{e1:.4g} ({e2 / e1:.3f}x, limit 1.25x)")


# ---------------------------------------------------------------------------
# phase 6 (g): the non-paged model path, ``build_model`` at full width

#: arch -> prompt tokens: mamba2-780m's 1000 is no multiple of its 128-token
#: SSD chunk; recurrentgemma-9b's 2560 passes its 2048-token window,
#: misaligned with it, and is a multiple of 512, so the chunked RG-LRU
#: branch runs; whisper-tiny also encodes 1500 seeded frames
MODEL_PROMPTS = {"olmo-1b": 512, "mamba2-780m": 1000,
                 "recurrentgemma-9b": 2560, "whisper-tiny": 64}
MODEL_B, MODEL_STEPS = 4, 64


def model_batch(cfg, S, dev, seed=0):
    """Seeded prompts [B, S] int32 (and whisper's frames [B, F, d]) on
    ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (MODEL_B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (MODEL_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def no_host_reads(dev):
    """On the card, any synchronising call inside raises (sync debug mode
    "error")."""
    import torch

    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def model_run(cfg, S, dtype, dev="cuda", steps=MODEL_STEPS, seed=0,
              paged=False, init_dev=None):
    """One model through ``build_model`` on ``dev``: seeded ``dtype``
    weights, a prefill of B=4 prompts of S tokens into a cache of S +
    ``steps`` slots, ``steps`` greedy decode steps (all but the first two
    under :func:`no_host_reads`), then teacher forcing over the prompts
    and the fed tokens, unembedding only the decoded positions.  Checks
    (raising): finite logits and states, ``len``, no kernel launch.
    Returns the tokens [B, steps + 1], the decoded logits [B, steps + 1,
    V] (on ``dev``), the teacher-forcing error and the times; with
    ``paged`` (a decoder LM) also the paged engine's tokens on the same
    prompts and weights.  The weights are drawn on ``init_dev`` (default
    ``dev``), so two runs with the same ``init_dev`` share them."""
    import gc

    import torch

    from repro_torch.models import build_model
    from repro_torch.models.transformer import unembed

    dev = torch.device(dev)
    gc.collect()  # an earlier run's weights and caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=seed, dtype=dtype,
                        device=init_dev or dev).placed(dev)
    batch = model_batch(cfg, S, dev, seed)
    _sync(dev)
    init_s = time.perf_counter() - t0
    reset_launches()
    times = []
    for _ in range(2):  # cold (first use at these shapes), then warm
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, batch, S + steps)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    rows = [logits[:, -1]]
    toks = [rows[0].argmax(-1).to(torch.int32)]
    pos = torch.full((MODEL_B,), S, dtype=torch.int32, device=dev)
    warm = 2
    for i in range(steps):
        if i == warm:
            _sync(dev)
            t0 = time.perf_counter()
        with no_host_reads(dev) if i >= warm else contextlib.nullcontext():
            logits, cache = model.decode_step(params, cache,
                                              {"token": toks[-1], "pos": pos})
            toks.append(logits.argmax(-1).to(torch.int32))
            pos = pos + 1
        rows.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    check(not any(launches.values()),
          f"{cfg.name}: the non-paged path launched kernels {launches}")
    dec = torch.stack(rows, dim=1)
    toks = torch.stack(toks, dim=1)
    check(bool(torch.isfinite(dec).all()), f"{cfg.name}: non-finite logits")
    for k, v in cache.items():
        check(k == "len" or bool(torch.isfinite(v).all()),
              f"{cfg.name}: non-finite cache {k}")
    check(bool((cache["len"] == S + steps).all()),
          f"{cfg.name}: len {cache['len'].tolist()}, want {S + steps}")
    del cache
    hidden, _ = model.forward(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], toks[:, :steps]], dim=1)})
    tf = unembed(cfg, params, hidden[:, S - 1:]).float()
    del hidden
    diff = (dec - tf).abs()
    out = {"tokens": toks.cpu(), "logits": dec, "init_s": init_s,
           "prefill_s": times, "decode_s": decode_s,
           "timed_steps": steps - warm, "tf_max_abs": float(diff.max()),
           # the least tol with |decode - teacher| <= tol + tol |teacher|
           "tf_tol": float((diff / (1 + tf.abs())).max()),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if dev.type == "cuda" else None)}
    if paged:
        from repro_torch.serving import PagedServingEngine

        del tf, diff
        eng = PagedServingEngine(cfg, params, num_pages=256, page_size=16,
                                 max_batch=MODEL_B, prefill_chunk=16,
                                 device=dev)
        reqs = [eng.submit(p, steps + 1) for p in batch["tokens"].tolist()]
        eng.run()
        check(all(r.state == "finished" for r in reqs),
              f"{cfg.name}: a paged request did not finish")
        out["paged_tokens"] = [list(r.generated) for r in reqs]
    return out


def models_phase(name):
    """Phase 6 (g): olmo-1b, mamba2-780m, recurrentgemma-9b and
    whisper-tiny at full width and depth through ``build_model``, float32
    then bf16 (module docstring)."""
    import torch

    from repro_torch.configs import get_config

    for arch, S in MODEL_PROMPTS.items():
        cfg = get_config(arch)
        # decode against teacher forcing: the reference's tests' bounds
        # (tests/test_models_smoke.py, tests/test_ring_cache.py)
        tol = 5e-2 if cfg.family == "hybrid" else 3e-2
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"models: {arch} {str(dtype)[6:]}"
            r = model_run(cfg, S, dtype, paged=(
                arch == "olmo-1b" and dtype == torch.bfloat16))
            del r["logits"]
            runs[dtype] = r
            n = MODEL_B * r["timed_steps"]
            log(f"{tag}: B={MODEL_B} prompt {S}, {MODEL_STEPS} greedy steps "
                f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
                f"{cfg.vocab_padded}); init {r['init_s']:.2f} s, prefill "
                f"{1e3 * r['prefill_s'][0]:.2f} ms cold, "
                f"{1e3 * r['prefill_s'][1]:.2f} ms warm, decode "
                f"{1e3 * r['decode_s'] / r['timed_steps']:.3f} ms/step, "
                f"{n / r['decode_s']:.1f} tokens/s, peak "
                f"{r['peak_gib']:.2f} GiB allocated, on {name}; decode vs "
                f"teacher forcing max abs {r['tf_max_abs']:.3g}, abs+rel "
                f"{r['tf_tol']:.3g} (limit {tol} in float32); 0 kernel "
                f"launches")
            if dtype == torch.float32:
                check(r["tf_tol"] <= tol,
                      f"{tag}: decode vs teacher forcing needs tolerance "
                      f"{r['tf_tol']:.3g} abs+rel, limit {tol}")
        bf = runs[torch.bfloat16]["tokens"].tolist()
        same, total = prefix_equal(bf, runs[torch.float32]["tokens"].tolist())
        log(f"models: {arch} bf16 greedy tokens equal to float32's before "
            f"each row's first difference: {same} of {total}")
        if "paged_tokens" in runs[torch.bfloat16]:
            same, total = prefix_equal(runs[torch.bfloat16]["paged_tokens"],
                                       bf)
            log(f"models: {arch} bf16 non-paged greedy tokens equal to the "
                f"paged engine's (bf16 arena) before each row's first "
                f"difference: {same} of {total}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels.build import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name = torch.cuda.get_device_name(0)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for src, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    sass_check()

    results = {}
    kernel_phase(results)
    parity_phase()
    tp_phase(results, name, "olmo-1b")
    # the MoE main path: its bf16 runs give the kernels line its launch
    # counts (paligemma's are in its own log lines)
    tp_phase(results, name, "olmoe-1b-7b", record=True)
    tp_phase(results, name, "paligemma-3b")
    walls = fleet_phase(name)
    models_phase(name)
    if "--profile" in sys.argv[1:]:
        profile_phase(name)
        profile_phase(name, tp=TP)
        profile_phase(name, arch="olmoe-1b-7b")
        profile_phase(name, tp=TP, arch="paligemma-3b")
        profile_fleet(name, walls)

    kernels = [results["paged_attention"], results["kv_append"],
               results["paged_attention_sharded"],
               results["paged_attention_append"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
