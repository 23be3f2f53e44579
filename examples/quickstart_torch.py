"""Quickstart over the PyTorch port (``repro_torch``): the paper's machinery
end to end, as ``examples/quickstart.py`` runs it over the JAX package.

1. Host layer: palloc + OA-VER reclamation over a real mmap arena — frees
   release physical frames while the ranges stay readable.
2. Device layer: a paged-KV serving engine on the card whose preemption
   path is optimistic reclamation with version validation, and whose
   prefix cache shares prompt KV pages across requests by refcount.
3. A tiny training run through the port's training driver.

Run on the card: PYTHONPATH=src python examples/quickstart_torch.py
On the CPU:      PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Every demo takes scale arguments so the smoke test
(tests/test_torch_examples.py) can run them near-instantly, and a
``device`` (None: the card; with no card that raises).  The serving demo
takes ``params`` — the port's parameters, e.g. the JAX demo's converted by
``repro_torch.convert.params_from_jax`` — else it draws its own seeded
ones.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import (HarrisMichaelList, LRMalloc, OAVer,
                              ReleaseStrategy)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import PagedServingEngine


def host_layer_demo(n_keys: int = 3000) -> dict:
    """Insert and delete ``n_keys`` keys; returns the reclaimer's counters."""
    print("== host layer: OA-VER over palloc, frames released to the OS ==")
    alloc = LRMalloc(num_superblocks=128, superblock_size=64 * 1024,
                     strategy=ReleaseStrategy.SHARED_REMAP)
    rec = OAVer(alloc, limbo_threshold=32)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    for k in range(1, n_keys):
        lst.insert(k, ctx)
    before = alloc.resident_bytes()
    for k in range(1, n_keys):
        lst.delete(k, ctx)
    rec.flush(ctx)
    alloc.flush_all_caches()
    after = alloc.resident_bytes()
    s = rec.stats.snapshot()
    print(f"   resident {before >> 10} KiB -> {after >> 10} KiB after reclaim")
    print(f"   warnings={s['warnings_fired']} restarts={s['reader_restarts']} "
          f"freed={s['nodes_freed']}")
    alloc.close()
    return s


def serving_demo(n_requests: int = 5, max_new: int = 8, params=None,
                 device=None) -> tuple:
    """A tight pool, then the prefix cache; returns the two engines'
    requests."""
    print("== device layer: paged serving with optimistic reclamation ==")
    dev = resolve_device(device)
    cfg = reduced(get_config("olmo-1b"))
    if params is None:
        params = build_model(cfg).init(seed=0, device=dev)
    eng = PagedServingEngine(cfg, params, num_pages=8, page_size=4,
                             max_batch=3, max_pages_per_seq=8, device=dev)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, (6,)).tolist(), max_new)
            for _ in range(n_requests)]
    stats = eng.run()
    assert all(r.state == "finished" for r in reqs)
    print(f"   {stats.tokens_committed} tokens, preemptions={stats.preemptions}, "
          f"restarts={stats.reader_restarts}, warnings={stats.warnings_fired}")

    # prefix sharing: the same system prompt across requests is served from
    # the refcounted prefix cache — prefill skipped, pages aliased
    eng2 = PagedServingEngine(cfg, params, num_pages=32, page_size=4,
                              max_batch=3, max_pages_per_seq=8,
                              prefix_cache=True, device=dev)
    system = rng.integers(0, cfg.vocab, (8,)).tolist()
    reqs2 = [eng2.submit(system + rng.integers(0, cfg.vocab, (2,)).tolist(),
                         max_new)
             for _ in range(n_requests)]
    stats2 = eng2.run()
    assert all(r.state == "finished" for r in reqs2)
    print(f"   prefix cache: hits={stats2.prefix_hits} "
          f"tokens_reused={stats2.prefix_tokens_reused} "
          f"pages_allocated={stats2.pages_allocated} "
          f"(vs {stats.pages_allocated} unshared)")
    return reqs, reqs2


def train_demo(steps: int = 40, device=None) -> dict:
    """Train reduced olmo-1b for ``steps`` steps; returns ``train``'s
    result (``history``, ``final_loss`` …)."""
    print(f"== training substrate (reduced olmo-1b, {steps} steps) ==")
    import repro_torch.launch.train as T
    args = argparse.Namespace(
        arch="olmo-1b", reduced=True, steps=steps, batch=2, seq=64, lr=3e-3,
        seed=0, log_every=10, ckpt_dir=None, ckpt_every=50, fail_at_step=None,
        grad_compression="none", device=device)
    return T.train(args)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    dev = ap.parse_args().device
    host_layer_demo()
    serving_demo(device=dev)
    train_demo(device=dev)
    print("quickstart OK")
