#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never the JAX package) on the card, in phases
that each raise on failure; nothing is caught, so a failed phase ends the
run with a nonzero exit and no result line.

1. Environment: the card's name and power limit, torch and CUDA versions;
   build every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once).
2. Kernels: each kernel against its plain PyTorch version on the card over
   a sweep of cases, with the tolerance stated beside it, then timed at the
   serving path's shapes beside its bound, its plain version and a library
   yardstick.
3. Parity: a reduced olmo-1b engine on the card against the same engine on
   the CPU (plain versions), float32 weights: generated tokens must agree.
4. Engine: full-width olmo-1b (seeded bf16 weights) served through
   ``PagedServingEngine``; every request must finish, the clock mirror must
   equal the pool's clock, both kernels must launch once per layer per
   step, and a steady step must make exactly one device->host transfer.

The second-to-last line is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without CUDA.
``--profile`` adds a torch.profiler breakdown of steady full-width decode
steps after the engine phase.
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


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` runs (CUDA events)."""
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

    # -- kernel 2: bit-exact sweep ---------------------------------------------
    for i, (C, dtype) in enumerate([(1, torch.bfloat16), (16, torch.bfloat16),
                                    (16, torch.float32), (1, torch.float32)]):
        B, Hkv, D, page, P, M = 8, 16, 128, 16, 512, 12
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
              f"kv_append case {i}: not bit-exact")
    log("kv_append: 4 cases bit-exact against the plain version")

    # -- timing at the serving path's shapes ------------------------------------
    # full olmo-1b engine: B=8 rows, block table width 512 (= num_pages),
    # 16 heads of 128, bf16 arena of 512 pages of 16 tokens; lengths as in
    # the engine phase mid-decode (prompt 64..256 plus 16 generated)
    lens = np.random.default_rng(7).integers(64, 257, 8) + 16
    rows = {}
    for C in (1, 16):
        q, kp, vp, bt, ln, cl = attention_case(8, C, 16, 16, 128, 16, 512,
                                               512, torch.bfloat16, seed=7,
                                               lens=lens)
        cl.fill_(C)
        err = (paged_attention_cuda(q, kp, vp, bt, ln, cl).float()
               - paged_attention_plain(q, kp, vp, bt, ln, cl).float()
               ).abs().max().item()
        byts, ops = attention_work(q, kp, bt, ln, cl)
        b_ms, by = bound_ms(byts, ops, "bfloat16")
        rows[C] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: paged_attention_cuda(q, kp, vp, bt, ln, cl)),
            plain_ms=time_ms(lambda: paged_attention_plain(q, kp, vp, bt, ln,
                                                           cl), iters=5),
            bound_ms=b_ms, bound_by=by,
            library_ms=time_ms(sdpa_yardstick(q, kp, vp, bt, ln, cl)))
        log(f"paged_attention C={C}: " + json.dumps(rows[C]))
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda", source=PA_SRC, replaces=PA_TPU,
        **rows[1])
    results["paged_attention_c16"] = rows[16]

    B, C, Hkv, D, page, P, M = 8, 1, 16, 128, 16, 512, 512
    bt = torch.as_tensor(np.random.default_rng(8).permutation(P)[: B * 32]
                         .reshape(B, 32).astype(np.int32), device="cuda")
    bt = torch.cat([bt, torch.full((B, M - 32), -1, dtype=torch.int32,
                                   device="cuda")], 1)
    ln = torch.as_tensor(lens.astype(np.int32), device="cuda")
    n_new = torch.ones(B, dtype=torch.int32, device="cuda")
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    kn = torch.randn((B, C, Hkv, D), device="cuda").to(torch.bfloat16)
    vn = torch.randn((B, C, Hkv, D), device="cuda").to(torch.bfloat16)
    arena = [torch.zeros((P, page, Hkv, D), dtype=torch.bfloat16,
                         device="cuda") for _ in range(2)]
    mine = [a.clone() for a in arena]
    kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)
    kv_append_plain(*arena, kn, vn, bt, ln, n_new, ok)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(mine, arena))
    pos = ln.long()
    pidx = bt.long().gather(1, (pos // page)[:, None])[:, 0]
    sidx = pos % page

    def library():
        arena[0].index_put_((pidx, sidx), kn[:, 0])
        arena[1].index_put_((pidx, sidx), vn[:, 0])
    row_bytes = Hkv * D * 2
    byts = 2 * 2 * B * C * row_bytes + 4 * 3 * B
    b_ms, by = bound_ms(byts, 0, "bfloat16")
    results["kv_append"] = dict(
        name="kv_append", route="cuda", source=KA_SRC, replaces=KA_TPU,
        max_abs_err=err,
        ms=time_ms(lambda: kv_append_cuda(*mine, kn, vn, bt, ln, n_new, ok)),
        plain_ms=time_ms(lambda: kv_append_plain(*arena, kn, vn, bt, ln,
                                                 n_new, ok)),
        bound_ms=b_ms, bound_by=by, library_ms=time_ms(library))
    log("kv_append C=1: " + json.dumps(
        {k: v for k, v in results["kv_append"].items()
         if k not in ("name", "route", "source", "replaces")}))


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


def engine_phase(results, name):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = PagedServingEngine(cfg, params, device="cuda", num_pages=512,
                             page_size=16, max_batch=8, prefill_chunk=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 257, 8)]
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    log(f"engine: olmo-1b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_padded}), set-up {time.perf_counter() - t0:.1f} s")

    sched = eng.scheduler
    paged_attention_cuda.launches = 0
    kv_append_cuda.launches = 0
    steps = steady = transfers = 0
    t0 = time.perf_counter()
    while True:
        sched.admit()
        if not sched.running and not sched.queue:
            break
        before = (paged_attention_cuda.launches, kv_append_cuda.launches)
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
            check(len(syncs) == 1, f"steady step {steps} made {len(syncs)} "
                  f"device->host transfers: "
                  f"{[str(w.message)[:80] for w in syncs]}")
            steady += 1
            transfers += len(syncs)
        else:
            eng.step()
        sched.maintain()
        steps += 1
        check(paged_attention_cuda.launches - before[0] == cfg.n_layers
              and kv_append_cuda.launches - before[1] == cfg.n_layers,
              f"step {steps}: kernels launched "
              f"{paged_attention_cuda.launches - before[0]} / "
              f"{kv_append_cuda.launches - before[1]} times, want "
              f"{cfg.n_layers} each")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results["paged_attention"]["launches"] = paged_attention_cuda.launches
    results["kv_append"]["launches"] = kv_append_cuda.launches

    st = eng.stats
    gen = sum(len(r.generated) for r in reqs)
    check(all(r.state == "finished" for r in reqs), "a request did not finish")
    check(all(len(r.generated) == 32 for r in reqs), "short generation")
    check(all(0 <= t < cfg.vocab_padded for r in reqs for t in r.generated),
          "token id out of range")
    clock = int(eng.pool.clock.cpu())
    check(st.warnings_fired == clock,
          f"clock mirror {st.warnings_fired} != pool clock {clock}")
    check(steady >= 4, f"only {steady} steady steps were checked")
    log(f"engine: {len(reqs)} requests finished, {steps} steps, "
        f"{gen} generated tokens, warnings_fired == clock == {clock}, "
        f"{steady} steady steps with {transfers} device->host transfers")
    log(f"engine: {gen / wall:.1f} generated tokens/s, "
        f"{1e3 * wall / steps:.2f} ms/step, on {name}")


def profile_phase(name, steps=5):
    """``--profile``: a torch.profiler trace of ``steps`` steady decode steps
    of the full-width engine (a fresh one, after the main path's counts were
    read): wall and device-busy time per step, and the kernels that take
    the device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine

    cfg = get_config("olmo-1b")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = PagedServingEngine(cfg, params, device="cuda", num_pages=512,
                             page_size=16, max_batch=8, prefill_chunk=16)
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
    log(f"profile: {steps} steady decode steps on {name}: {wall:.2f} ms/step "
        f"wall (unprofiled), {busy:.2f} ms/step of device time in "
        f"{sum(r[1] for r in rows):.0f} device ops ({100 * busy / wall:.1f}% "
        f"busy)")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms/step  {count:6.0f}/step  {key[:90]}")


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

    results = {}
    kernel_phase(results)
    parity_phase()
    engine_phase(results, name)
    if "--profile" in sys.argv[1:]:
        profile_phase(name)

    kernels = [results["paged_attention"], results["kv_append"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
