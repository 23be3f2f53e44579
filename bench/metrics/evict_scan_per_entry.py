"""evict_scan_per_entry: keys the prefix index's eviction sweeps counted
and sorted (``keys_scanned`` of the program's ``prefix.evict`` spans) per
entry they evicted (``entries_evicted``), over the sweeps that end inside
the window.  Nothing where no entry was evicted, the program records no
spans, or no longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    sweeps = [r for r in records_between(run.w0, run.w1) or ()
              if r.name == "prefix.evict"]
    evicted = sum(r.get("entries_evicted") for r in sweeps)
    if not evicted:
        return None
    return sum(r.get("keys_scanned") for r in sweeps) / evicted
