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
3. Parity: a reduced olmo-1b engine on the card against the same engine on
   the CPU (plain versions), float32 weights: generated tokens must agree.
4. Engines: full-width olmo-1b served through ``PagedServingEngine``, at
   TP=1 and at ``tensor_parallel=TP`` with every shard on this card
   (``devices=["cuda:0"] * TP``), with seeded float32 weights and then the
   same weights in bf16 (the main path).  In each run every request must
   finish, the clock mirror must equal the pool's clock, the fused launch
   must run once per layer per shard per step and ``kv_append_cuda`` never,
   and a steady step must make exactly one device->host transfer.  Across runs: in float32, TP=2 must
   equal TP=1 (tokens, and the K/V of every position written, within
   2e-2 + 2e-2|x|); in bf16, TP=2's K/V must stay as close to float32's as
   TP=1's do (mean abs difference within 1.25x), over the prompt positions
   and, apart, over the generated positions where both still feed the
   model float32's tokens; the tokens TP=2 shares with TP=1 are printed.

The second-to-last line is the ``kernels`` JSON (kernel 1, kernel 2, the
sharded kernel 3 and the fused launch; launches from the bf16 TP=1 run for
kernels 1 and 2 and the fused launch, from the bf16 TP=2 run for kernel 3;
kernel 1 counts its launches with and without the append, kernel 2 is off
the serving path and counts 0); the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without CUDA.
``--profile`` adds a torch.profiler breakdown of steady full-width decode
steps at TP=1 and at TP=2 after the engine runs.
"""

from __future__ import annotations

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


def fused_kernel(results, lens):
    """Kernel 2 fused into kernel 1's launch: bitwise against the
    two-launch pair over kernel 1's cases, then timed at the serving
    path's shapes beside the pair, the plain version and the library."""
    import numpy as np
    import torch

    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda, paged_attention_append_plain,
        paged_attention_cuda)
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
        q, kp, vp, bt, ln, cl = case
        kn, vn, ok = append_inputs(case, seed=7, deny=None)
        err = fused_check(q, kp, vp, kn, vn, bt, ln, cl, ok,
                          f"fused C={C} timed case")
        old = ln - cl
        B, Hkv, D = 8, 16, 128
        byts, ops = attention_work(q, kp, bt, ln, cl)
        # the append's reads are kernel 1's reads of those positions; its
        # writes and write_ok come on top
        byts += 2 * kn.numel() * kn.element_size() + B
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
        rows[C] = dict(
            max_abs_err=err, ms=time_ms(mine),
            device_ms=device_ms(mine, "paged_attention_kernel"),
            plain_ms=time_ms(lambda: paged_attention_append_plain(
                q, kp, vp, kn, vn, bt, ln, cl, ok), iters=5),
            bound_ms=b_ms, bound_by=by, library_ms=time_ms(library),
            library_device_ms=device_ms(library),
            pair_ms=time_ms(pair), pair_device_ms=device_ms(pair))
        rows[C]["bound_share"] = b_ms / rows[C]["device_ms"]
        log(f"paged_attention_append C={C}: " + json.dumps(rows[C]))
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
    results["paged_attention_sharded"] = dict(
        name="paged_attention_sharded", route="cuda", source=PA_SRC,
        replaces=PS_TPU, **rows[1])
    results["paged_attention_sharded_c16"] = rows[16]


# ---------------------------------------------------------------------------
# phase 3: parity of the card against the CPU on a small model


def parity_phase():
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=3, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(3, 20, 6)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = PagedServingEngine(cfg, params, num_pages=24, page_size=4,
                                 max_batch=3, prefill_chunk=8, device=dev)
        reqs = [eng.submit(p, 8) for p in prompts]
        st = eng.run()
        check(all(r.state == "finished" for r in reqs), f"{dev}: unfinished")
        check(st.warnings_fired == int(eng.pool.clock.cpu()),
              f"{dev}: clock mirror {st.warnings_fired} != pool clock")
        out[dev] = ([r.generated for r in reqs], st.steps, st.preemptions)
    check(out["cpu"] == out["cuda"],
          f"card and CPU disagree on the reduced model: {out}")
    log(f"parity: reduced olmo-1b, 6 requests, card == CPU (tokens, "
        f"{out['cpu'][1]} steps, {out['cpu'][2]} preemptions)")


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


def engine_phase(results, name, tp=1, dtype="bfloat16"):
    """Serve the 8 requests on full-width olmo-1b with ``dtype`` weights;
    ``tp`` > 1 serves them on ``tp`` shards of this card.  Returns
    (generated tokens, per request the K/V of every position it wrote —
    read just before its last step —, the phase's tag, prompt lengths)."""
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
    tag = ("engine" if tp == 1 else f"engine tp={tp}") + (
        "" if dtype == "bfloat16" else f" {dtype}")
    cfg = get_config("olmo-1b")
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
    log(f"{tag}: olmo-1b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_padded}), set-up {time.perf_counter() - t0:.1f} s, "
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
    t0 = time.perf_counter()
    while True:
        sched.admit()
        if not sched.running and not sched.queue:
            break
        last = [r for r in sched.running if id(r) not in kv_rows
                and len(r.generated) == r.max_new_tokens - 1]
        if last:  # reads between steps, before the rows are freed; untimed
            t1 = time.perf_counter()
            kv_rows.update((id(r), row_kv(eng, r)) for r in last)
            torch.cuda.synchronize()
            untimed += time.perf_counter() - t1
        before = {fn: fn.launches for fn in counters}
        is_steady = (not sched.queue and all(
            r.committed >= len(r.prompt)
            and len(r.generated) + 2 < r.max_new_tokens for r in sched.running))
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
        check(all(fn.launches - before[fn] == n for fn, n in counters.items()),
              f"{tag} step {steps}: kernel launches {got}, want "
              f"{ {fn.__name__: n for fn, n in counters.items()} }")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - untimed
    launches = {fn.__name__: fn.launches for fn in counters}
    if dtype == "bfloat16" and tp == 1:
        results["paged_attention"]["launches"] = paged_attention_cuda.launches
        results["kv_append"]["launches"] = kv_append_cuda.launches
        results["paged_attention_append"]["launches"] = \
            paged_attention_append_cuda.launches
    elif dtype == "bfloat16":
        results["paged_attention_sharded"]["launches"] = \
            paged_attention_sharded.launches

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
        f"{1e3 * wall / steps:.2f} ms/step, on {name}")
    tokens = [list(r.generated) for r in reqs]
    check(all(id(r) in kv_rows for r in reqs),
          f"{tag}: a request's K/V was not read before its last step")
    return (tokens, [kv_rows[id(r)] for r in reqs], tag,
            [len(r.prompt) for r in reqs])


def profile_phase(name, tp=1, steps=5):
    """``--profile``: a torch.profiler trace of ``steps`` steady decode steps
    of the full-width engine at ``tp`` shards (a fresh one, after the main
    path's counts were read): wall and device-busy time per step, and the
    kernels that take the device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = get_config("olmo-1b")
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    rows = []  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev / 1e3 / steps, ev.count / steps, ev.key))
    busy = sum(r[0] for r in rows)
    log(f"profile tp={tp}: {steps} steady decode steps on {name}: "
        f"{wall:.2f} ms/step "
        f"wall (unprofiled), {busy:.2f} ms/step of device time in "
        f"{sum(r[1] for r in rows):.0f} device ops ({100 * busy / wall:.1f}% "
        f"busy)")
    attn = sum(r[0] for r in rows if "paged_attention_kernel" in r[2])
    n_attn = sum(r[1] for r in rows if "paged_attention_kernel" in r[2])
    log(f"profile tp={tp}: kernel 1 with the fused append {attn:.3f} "
        f"ms/step in {n_attn:.0f} launches, {100 * attn / busy:.1f}% of the "
        f"device time")
    check(not any("kv_append_kernel" in r[2] for r in rows),
          f"profile tp={tp}: a standalone kv_append launch in the steady step")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")


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
    # float32 weights first: the yardstick the bf16 phases are held to
    f32 = engine_phase(results, name, dtype="float32")
    f32_tp = engine_phase(results, name, tp=TP, dtype="float32")
    one = engine_phase(results, name)  # the main path, TP=1 ...
    tp = engine_phase(results, name, tp=TP)  # ... and TP=2
    # in float32 the two reductions round ~1e-7 apart: TP=2 is TP=1, in
    # tokens and in the K/V of every position written
    full = [kv["k"].shape[1] - plen for kv, plen in zip(f32[1], f32[3])]
    dist = kv_distance(f32_tp, f32, full)
    check(f32_tp[0] == f32[0] and all(b == 0 for _, b, _ in dist.values()),
          f"float32: TP={TP} differs from TP=1 (tokens equal before "
          f"divergences: {first_divergence(f32_tp, f32)}, K/V beyond "
          f"tolerance: {dist})")
    # in bf16 the row-parallel partials round apart, and greedy decoding
    # over random weights meets near ties, so tokens are counted, not held;
    # what is held is that TP=2 stays as close to float32 as TP=1 does, in
    # prefill and in decode, at the positions where both still feed the
    # model float32's tokens
    depth = [min(a, b, n) for a, b, n in zip(first_divergence(one, f32),
                                              first_divergence(tp, f32), full)]
    check(sum(depth) > 0, "bf16: no generated position of TP=1 and TP="
          f"{TP} shares float32's tokens")
    d_one, d_tp = kv_distance(one, f32, depth), kv_distance(tp, f32, depth)
    same = first_divergence(tp, one)
    log(f"engine tp={TP}: {sum(same)} of {sum(map(len, one[0]))} bf16 "
        f"tokens equal TP=1's before each request's first divergence "
        f"(at {same})")
    for part in ("prompt", "decode"):
        e1, e2 = d_one[part][0], d_tp[part][0]
        check(e2 <= 1.25 * e1, f"bf16 TP={TP} {part} K/V are {e2:.4g} from "
              f"float32 against TP=1's {e1:.4g} (limit 1.25x)")
        log(f"engine tp={TP}: bf16 {part} K/V {e2:.4g} from float32 against "
            f"TP=1's {e1:.4g} ({e2 / e1:.3f}x, limit 1.25x)")
    del f32, f32_tp, one, tp
    if "--profile" in sys.argv[1:]:
        profile_phase(name)
        profile_phase(name, tp=TP)

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
