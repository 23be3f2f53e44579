"""step_fill_pct: tokens the window's steps committed (``tokens`` of the
program's ``engine.step`` spans that end inside the window), as a share of
the positions those steps computed (``positions`` of their
``runner.launch`` spans: rows × chunk).  Nothing where the program
records no spans, or no longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    recs = records_between(run.w0, run.w1) or ()
    steps = {r.id: r for r in recs if r.name == "engine.step"}
    positions = sum(r.get("positions") for r in recs
                    if r.name == "runner.launch" and r.parent in steps)
    if not positions:
        return None
    return 100.0 * sum(s.get("tokens") for s in steps.values()) / positions
