"""sched_ms_per_step: host time inside the scheduler's ``admit``,
``plan_chunk``, ``plan_validate``, ``absorb`` and ``maintain`` during the
window (wrappers the benchmark installs on the engine's scheduler), ÷ the
window's steps."""


def read(run):
    steps = len(run.window_steps())
    if run.sched_s is None or not steps:
        return None
    return 1e3 * run.sched_s / steps
