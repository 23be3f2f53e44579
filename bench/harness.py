"""One run of one cell: set-up, the window, the traced slice, the check.

Everything that depends on the architecture comes from the cell's family
module (``Cell.family``, the family contract of ``bench/cells.py``): the
weights, the program's config, the reference that judges the run, the
FLOP and attention arithmetic of its readers, the launches a step.

Set-up makes the weights on the device from the seed, builds the engine
with the cell's settings, widens its prompt buffer to the longest prompt
the mix can send and captures every step graph the cell's traffic uses
before any traffic comes (:func:`capture_graphs`), then
serves the traffic until the warm-up is over (``bench/drive.py``).  The
window follows; with ``trace`` the scheduler's host time is tallied
during it and a profiled slice of steady steps follows it.  Then the
device's peak memory is read, the program's state is freed, and the
plain reference judges a sample of the finished requests
(``bench/check.py``).  Each metric comes from its reader,
``bench/metrics/<name>.py``; a reader that finds nothing returns None and
the metric is left out.
"""

from __future__ import annotations

import gc
import sys
import time

from bench.cells import Cell, load_reader
from bench.check import Served, compare, control_sample, sample
from bench.drive import Loop
from bench.generate import Traffic
from bench.timeline import Run


def longest_prompt(mix: dict) -> int:
    """The longest prompt the mix sends, its cache's fill included."""
    sp = mix.get("shared_prefix")
    n = int(mix["prompt_cap"]) + (int(sp["tokens"]) if sp else 0)
    return n + (int(mix["output_cap"]) - 1 if mix.get("fill_cache") else 0)


def build_engine(cell: Cell, seed: int, device):
    """The engine of ``cell`` over weights drawn from ``seed``."""
    from repro_torch.serving import PagedServingEngine

    params = cell.family.weights(cell.spec, seed, device)
    eng = PagedServingEngine(cell.family.program_config(cell.spec), params,
                             device=device, greedy=True, **cell.engine)
    eng.kv_manager.ensure_prompt_cap(longest_prompt(cell.mix))
    return eng


def capture_graphs(eng) -> None:
    """Capture every step graph the cell's traffic can ask for before any
    traffic comes: chunk 1 and the prefill chunk, under either validation
    verdict, at the widened prompt buffer (where the runner serves through
    graphs; the CPU steps eagerly)."""
    runner = eng.runner
    if not runner.graphs:
        return
    for C in sorted({1, eng.prefill_chunk}):
        for validate in (True, False):
            key = (C, False, validate, eng._prompt_cap)
            if key not in runner.step_graphs:
                runner.capture(eng.kv_manager, key)


def served_sample(loop: Loop, seed: int, min_tokens: int) -> list:
    """The requests to check: every finished one, sampled by
    :func:`bench.check.sample`."""
    return sample([Served(r.prompt, r.tokens) for r in loop.recs
                   if r.tokens is not None], seed, min_tokens)


def judge(reading, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the compared numbers, each beside its limit."""
    compared = {k: {"value": getattr(reading, k), "limit": v}
                for k, v in limits.items()}
    return (reading.positions > 0
            and all(c["value"] <= c["limit"] for c in compared.values()),
            compared)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, log=None) -> dict:
    """Run ``cell`` once (module docstring); returns the result line's
    object.  With ``control`` (calibration and tests only) the fp8
    reference is put in the program's place on the same sample and its
    tokens decide ``correct`` and ``compared``; the program's own reading
    is kept under ``program``."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    t = time.perf_counter()
    eng = build_engine(cell, seed, dev)
    log(f"engine built in {time.perf_counter() - t:.3f} s "
        f"(process start +{time.perf_counter() - t_start:.3f} s)")
    t = time.perf_counter()
    capture_graphs(eng)
    log(f"step graphs {sorted(eng.runner.step_graphs)} captured in "
        f"{time.perf_counter() - t:.3f} s")
    traffic = Traffic(cell.mix, seed, cell.spec.vocab)
    loop = Loop(eng, traffic)
    tally = None
    if trace:
        from bench.trace import time_scheduler
        tally = time_scheduler(eng, loop)
    sliced = {}

    def after(d):
        if trace and dev.type == "cuda":
            from bench.trace import profile_slice
            sliced["slice"] = profile_slice(
                d, cell.profile_steps,
                cell.family.attention_launches(cell.spec))

    loop.run(seconds, after=after)
    log(f"window {loop.w1 - loop.w0:.3f} s, {len(loop.steps)} steps, "
        f"set-up {loop.w0 - t_start:.3f} s; cache filled: {loop.filled}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"memory peak {device_info['memory_peak_bytes']} allocated, "
            f"{torch.cuda.max_memory_reserved(dev)} reserved, of "
            f"{torch.cuda.get_device_properties(dev).total_memory} bytes")
    run = Run(w0=loop.w0, w1=loop.w1, recs=loop.recs,
              steps=loop.steps, family=cell.family, spec=cell.spec,
              stats_w0=loop.stats_w0, stats_w1=loop.stats_w1,
              setup_s=loop.w0 - t_start,
              sched_s=tally["sched_s"] if tally else None,
              profile=sliced.get("slice"))
    if run.profile is not None:
        device_info["busy_s"] = run.profile.busy_s()
        device_info["window_s"] = run.profile.window_s
    picked = served_sample(loop, seed,
                           int(cell.check.get("sample_tokens", 512)))
    # free the program's state before the reference runs
    del eng, loop, traffic
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reading = compare(cell.family, cell.spec, seed, dev, picked)
    limits = {k: float(v) for k, v in cell.check["limits"].items()}
    program = None
    if control:
        program = judge(reading, limits)
        reading = compare(cell.family, cell.spec, seed, dev,
                          control_sample(cell.family, cell.spec, seed, dev,
                                         picked))
    log(f"{'control' if control else 'check'}: {len(picked)} requests, "
        f"{reading.positions} served tokens, "
        f"{reading.off_argmax} off the reference's argmax, widest gap "
        f"{reading.widest_gap!r}, mean gap {reading.mean_gap!r}, in "
        f"{time.perf_counter() - t:.3f} s; per request (prompt, served, "
        f"off, widest, share repeating within 8): {reading.per_request}")
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = load_reader(cell.root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, compared = judge(reading, limits)
    out = {"correct": correct, "attempted": len(run.due()),
           "failed": sum(r.failed for r in run.due()),
           "metrics": metrics, "device": device_info}
    if run.profile is not None:
        out["breakdown"] = run.profile.breakdown()
    if program is not None:
        out["program"] = {"correct": program[0], "compared": program[1]}
    out["compared"] = compared
    return out
