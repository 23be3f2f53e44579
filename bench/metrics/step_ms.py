"""step_ms: host wall time inside ``engine.step`` (plan, the fused step
and its one read back, absorb), averaged over the window's steps."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return 1e3 * sum(s.t_end - s.t_start for s in steps) / len(steps)
