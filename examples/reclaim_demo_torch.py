"""Memory-release demo over the PyTorch port (``repro_torch``), as
``examples/reclaim_demo.py`` runs it over the JAX package (paper §3.2,
Fig. 3): all three release strategies side by side, with actual
resident-memory measurements from /proc, then the same story on the
device pool — the serving engine's superblock-structured KV arena shrinks
after a burst (EMPTY superblocks leave circulation, versions bumped: the
OA warning) and remaps on the next burst.

Run on the card: PYTHONPATH=src python examples/reclaim_demo_torch.py
On the CPU:      PYTHONPATH=src python examples/reclaim_demo_torch.py --device cpu
"""

import argparse
import dataclasses

from repro_torch.configs import get_config, reduced
from repro_torch.core import (LRMalloc, MichaelHashTable, OABit,
                              ReleaseStrategy)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import PagedServingEngine


def strategy_rows(n_keys: int = 20000, num_superblocks: int = 256) -> list:
    """Fill and empty a hash table under each strategy; returns rows of
    (strategy, peak KiB, after KiB, superblocks released, reads ok)."""
    rows = []
    for strategy in ReleaseStrategy:
        alloc = LRMalloc(num_superblocks=num_superblocks,
                         superblock_size=64 * 1024, strategy=strategy)
        rec = OABit(alloc, limbo_threshold=64)
        ht = MichaelHashTable(rec, 256)
        ctx = rec.thread_ctx()
        for k in range(1, n_keys):
            ht.insert(k, ctx)
        peak = alloc.resident_bytes()
        for k in range(1, n_keys):
            ht.delete(k, ctx)
        rec.flush(ctx)
        alloc.flush_all_caches()
        after = alloc.resident_bytes()
        # the ranges must remain readable (OA's contract) even after release
        probe = [alloc.read_u64(off) for off in range(16, 64 * 1024, 4096)]
        rows.append((strategy.value, peak >> 10, after >> 10,
                     alloc.stats.persistent_released, len(probe)))
        alloc.close()
    print(f"{'strategy':14s} {'peak KiB':>9s} {'after KiB':>10s} "
          f"{'sb released':>12s} {'reads ok':>9s}")
    for r in rows:
        print(f"{r[0]:14s} {r[1]:9d} {r[2]:10d} {r[3]:12d} {r[4]:9d}")
    print("\nkeep: frames stay with the process (reusable, not returned)")
    print("madvise/shared_remap: frames returned to the OS, ranges still "
          "readable")
    return rows


def device_pool_demo(params=None, device=None) -> dict:
    """A burst, ``shrink()``, the next burst on a one-layer reduced
    olmo-1b engine; returns the pool's (mapped superblocks, resident
    superblocks, mapped pages) after each, the next burst's remaps and
    the engine's steps."""
    print("\n=== device KV pool: superblock release after a burst ===")
    dev = resolve_device(device)
    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), n_layers=1)
    if params is None:
        params = build_model(cfg).init(seed=0, device=dev)
    eng = PagedServingEngine(
        cfg, params, num_pages=32, page_size=2, max_batch=4,
        max_pages_per_seq=8, pages_per_superblock=4,
        release_strategy=ReleaseStrategy.MADVISE, min_mapped_superblocks=1,
        device=dev)
    out = {}

    def state(name):
        s = eng.stats
        out[name] = (s.superblocks_mapped, s.superblocks_resident,
                     s.mapped_pages)
        return s

    for prompt in ([1, 2, 3], [4, 5], [6, 7, 8], [9, 10]):  # the burst
        eng.submit(prompt, 8)
    eng.run()
    s = state("after burst")
    print(f"after burst:  {s.superblocks_mapped}/{s.superblocks_resident} "
          f"superblocks mapped ({s.mapped_pages} pages)")
    released = eng.shrink()
    s = state("after shrink")
    print(f"after shrink: {s.superblocks_mapped}/{s.superblocks_resident} "
          f"superblocks mapped ({s.mapped_pages} pages) — "
          f"{released} superblocks released")
    r = eng.submit([11, 12, 13], 8)  # the next burst remaps under pressure
    eng.run()
    s = state("next burst")
    out["remapped"] = s.superblocks_remapped
    out["steps"] = s.steps
    print(f"next burst:   {s.superblocks_mapped}/{s.superblocks_resident} "
          f"superblocks mapped again ({s.superblocks_remapped} remapped, "
          f"{s.preemptions} preemptions) — request {r.state}")
    print("the KV arena itself is palloc'd once: released ranges stay "
          "readable,\nstale optimistic readers fail version validation "
          "instead of faulting")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    dev = ap.parse_args().device
    strategy_rows()
    device_pool_demo(device=dev)
