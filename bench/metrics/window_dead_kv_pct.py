"""window_dead_kv_pct: the share of the KV the window's steps held that no
sliding-window layer reads again: Σ ``window_dead_pages`` (pages of the
live rows wholly before their window, in every layer's slot of a page) ×
the share of the layers that slide (the family spec's ``n_sliding`` ÷
``n_layers``) ÷ Σ ``pages_in_use``, over the program's ``engine.step``
spans that end inside the window; what releasing a window layer's dead
pages would give back.  Nothing where the program records neither
counter, records no spans, or no longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    steps = [r for r in records_between(run.w0, run.w1) or ()
             if r.name == "engine.step"]
    held = sum(r.get("pages_in_use") for r in steps)
    sliding = getattr(run.spec, "n_sliding", None)
    if not held or sliding is None:
        return None
    dead = sum(r.get("window_dead_pages") for r in steps)
    return 100.0 * dead * sliding / run.spec.n_layers / held
