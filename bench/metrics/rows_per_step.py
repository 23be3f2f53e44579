"""rows_per_step: the rows a step advanced (granted and computed; a row
the KV pool starved does not count), averaged over the window's steps
(``rows`` of the program's ``engine.step`` spans that end inside the
window).  Nothing where the program records no such counter, records no
spans, or no longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    rows = [r.get("rows", None) for r in records_between(run.w0, run.w1) or ()
            if r.name == "engine.step"]
    if not rows or None in rows:
        return None
    return sum(rows) / len(rows)
