"""What a fleet's threads wait in while one replica's stream sleeps.

Usage: python tools/stall_probe.py [--sleep S] [--repeats N] [--out DIR]
                                  [--parts single,big,fleet] [--eager]

Needs a GPU.  Three parts, all on one card:

1. The fleet stall of ``tests/test_torch_fleet_streams.py::
   test_cuda_stalled_replica_fails_over_while_its_stream_sleeps``:
   reduced olmo-1b, float32, 2 replicas on the card, a 1 s stall timeout
   with ``auto_revive``; at its 4th driver iteration replica 0 enqueues a
   ``--sleep`` second ``torch.cuda._sleep`` on its stream.  From that
   moment ``faulthandler`` dumps every thread's stack each second into
   ``DIR/stall_probe_stacks_<run>.txt``; the fleet's failover, revival,
   graph preparation and each CUDA graph's ``capture_begin`` /
   ``capture_end`` / generator registration are stamped with their thread
   and their time since the sleep was enqueued.  Printed per run: the
   stamps, whether the fleet finished while the stream still slept, and
   each dump's innermost frames per thread.  ``--repeats`` runs it again;
   with ``--eager`` every runner steps eagerly from the stall on (no
   capture: what the fleet itself now does only for missing graphs).
2. Single calls against a sleeping stream: stream A sleeps 3 s; a helper
   thread may make one call on A (a pageable ``.cpu()``, ``.tolist()``, a
   pageable upload, a pinned copy and a stream wait, or nothing); then the
   main thread, on stream B, times a kernel launch and a wait for B, the
   capture of a graph over kernels no graph of the process held yet
   (fresh), of the same body again (instantiated once) and of a body
   whose kernels never launched, each phase of a capture apart
   (``capture_begin``, the body, ``capture_end``),
   ``register_generator_state``, a new stream, and a 1 GiB allocation.
   A time near 3 s means the call waited for the sleeping stream.
3. Graph size: graphs of 50 to 3200 kernels captured on stream B while
   stream A sleeps 2 s, each size twice; ``capture_end`` and a replay
   timed.

``--parts`` picks the parts (default: 1 and 2).
"""

from __future__ import annotations

import argparse
import faulthandler
import pathlib
import re
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

KW = dict(num_pages=32, page_size=4, max_batch=3, prefill_chunk=8)


def cycles_per_second(torch):
    """The card's ``torch.cuda._sleep`` cycles a second (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10_000_000)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 1e8 / (start.elapsed_time(end) / 1e3)


class Stamps:
    """Events stamped with their thread and seconds since :attr:`t0`."""

    def __init__(self):
        self.t0 = None
        self.rows = []
        self.names = {}  # faulthandler's thread id -> the thread's name
        self.lock = threading.Lock()

    def add(self, what, dt=None):
        if self.t0 is None:
            return
        t = time.perf_counter() - self.t0
        me = threading.current_thread()
        with self.lock:
            self.names[f"0x{me.ident:016x}"] = me.name
            self.rows.append((t, me.name, what, dt))

    def timed(self, owner, name, label, slow=None):
        """Patch ``owner.name`` to stamp its start and its duration (with
        ``slow``: only calls that took longer, at their end)."""
        orig = getattr(owner, name)
        stamps = self

        def wrapper(*a, **k):
            t = time.perf_counter()
            if slow is None:
                stamps.add(f"{label} begins")
            try:
                return orig(*a, **k)
            finally:
                dt = time.perf_counter() - t
                if slow is None or dt > slow:
                    stamps.add(f"{label} ends", dt)
        setattr(owner, name, wrapper)
        return orig


def summarize_dumps(path, names):
    """Each faulthandler dump's threads (by name where ``names`` has it)
    with their innermost frame and the next two of the repository."""
    text = pathlib.Path(path).read_text()
    out = []
    for n, dump in enumerate(re.split(r"\n(?=Timeout \()", text)):
        if not dump.strip():
            continue
        out.append(f"  dump {n}:")
        for block in re.split(r"\n(?=(?:Current thread|Thread) 0x)", dump):
            head = block.strip().splitlines()
            if not head or "Thread" not in head[0] and \
                    "thread" not in head[0]:
                continue
            lines = [ln.strip() for ln in head[1:]]
            frames = lines[:1] + [ln for ln in lines[1:]
                                  if "/repo/" in ln][:2]
            frames = [re.sub(r'File ".*?/(src|tools|tests)/', r"\1/", ln)
                      for ln in frames]
            tid = head[0].split()[-4] if "Current" in head[0] else \
                head[0].split()[1]
            out.append(f"    {names.get(tid, tid)}: " + " <- ".join(frames))
    return out


def fleet_stall(torch, sleep_s, run, out_dir, eager_after_stall=False):
    """Part 1 (module docstring); returns True iff the fleet finished
    while the stream still slept.  ``eager_after_stall``: every round
    after the stall steps eagerly, capturing nothing."""
    import numpy as np

    from repro_torch.core.pagepool import DevicePagePool
    from repro_torch.serving.kv_manager import KVCacheManager
    from repro_torch.serving.runner import ModelRunner

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                     WatchdogConfig)
    from repro_torch.serving import parallel

    cuda = torch.device("cuda", 0)
    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, seed=4, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(k)).tolist()
               for k in rng.integers(3, 14, 12)]
    clean = DataParallelEngine(cfg, params, replicas=2, devices=[cuda, cuda],
                               **KW)
    base_reqs = [clean.submit(p, 16) for p in prompts]
    clean.run()
    base = [list(r.generated) for r in base_reqs]
    fleet = DataParallelEngine(
        cfg, params, replicas=2, devices=[cuda, cuda],
        watchdog=WatchdogConfig(stall_timeout=1.0, auto_revive=True), **KW)
    warm = [fleet.submit(p[:4], 2) for p in prompts[:2]]
    fleet.run()
    assert all(r.state == "finished" for r in warm)
    cycles = int(sleep_s * cycles_per_second(torch))

    stamps = Stamps()
    G = torch.cuda.CUDAGraph
    undo = [(G, "capture_begin", stamps.timed(G, "capture_begin",
                                                "capture_begin")),
            (G, "capture_end", stamps.timed(G, "capture_end",
                                              "capture_end")),
            (G, "register_generator_state",
             stamps.timed(G, "register_generator_state",
                          "register_generator_state")),
            (parallel.DataParallelEngine, "_fail_over",
             stamps.timed(parallel.DataParallelEngine, "_fail_over",
                          "fail_over")),
            (parallel.DataParallelEngine, "revive",
             stamps.timed(parallel.DataParallelEngine, "revive", "revive")),
            (parallel.DataParallelEngine, "_supervise",
             stamps.timed(parallel.DataParallelEngine, "_supervise",
                          "round")),
            (PagedServingEngine, "_prepare_graphs",
             stamps.timed(PagedServingEngine, "_prepare_graphs",
                          "prepare_graphs"))]
    capture = ModelRunner.capture

    def keyed_capture(runner, kvm, key):
        stamps.add(f"capture of key {key}")
        return capture(runner, kvm, key)
    undo.append((ModelRunner, "capture", capture))
    ModelRunner.capture = keyed_capture
    for owner, name in ((DevicePagePool, "alloc"), (DevicePagePool, "share"),
                        (KVCacheManager, "row_pages"),
                        (KVCacheManager, "install_slot"),
                        (ModelRunner, "collect"), (ModelRunner, "launch"),
                        (PagedServingEngine, "__init__")):
        undo.append((owner, name, stamps.timed(owner, name, name, slow=0.2)))
    if eager_after_stall:
        prepare = PagedServingEngine._prepare_graphs

        def eager_prepare(eng):
            if stamps.t0 is None:
                return prepare(eng)
            eng.runner.graphs = False  # the eager step from the stall on
        undo.append((PagedServingEngine, "_prepare_graphs", prepare))
        PagedServingEngine._prepare_graphs = eager_prepare
    stacks = out_dir / f"stall_probe_stacks_{run}.txt"
    fh = open(stacks, "w")
    stalled, calls = {}, [0]

    def stall(_eng):
        calls[0] += 1
        if calls[0] == 4:
            stream = torch.cuda.current_stream(cuda)
            torch.cuda._sleep(cycles)
            stamps.t0 = time.perf_counter()
            faulthandler.dump_traceback_later(1.0, repeat=True, file=fh)
            stalled.update(stream=stream, done=stream.record_event(),
                           thread=threading.current_thread())
        elif calls[0] > 4:
            stamps.add(f"replica 0 iteration {calls[0]}")
    fleet.step_hooks[0] = stall
    reqs = [fleet.submit(p, 16) for p in prompts]
    t0 = time.perf_counter()
    fleet.run()
    wall = time.perf_counter() - t0
    stamps.add("fleet.run() returned")
    asleep = not stalled["done"].query()
    faulthandler.cancel_dump_traceback_later()
    for owner, name, orig in undo:
        setattr(owner, name, orig)
    stalled["done"].synchronize()
    stamps.add("the sleep ended")
    stalled["thread"].join(timeout=60)
    fh.close()
    st = fleet.stats
    exact = [r.output_tokens for r in reqs] == base
    print(f"run {run}{' (eager after the stall)' if eager_after_stall else ''}: fleet.run() {wall:.2f} s, the stream "
          f"{'still asleep' if asleep else 'awake'} at its end (sleep "
          f"{sleep_s} s); failures {st.replica_failures}, revivals "
          f"{st.replica_revivals}, migrated {st.requests_migrated}, all "
          f"finished {all(r.state == 'finished' for r in reqs)}, tokens "
          f"exact {exact}", flush=True)
    for t, thread, what, dt in stamps.rows:
        took = f" ({dt:.3f} s)" if dt is not None else ""
        print(f"  {t:7.3f} s [{thread}] {what}{took}")
    for line in summarize_dumps(stacks, stamps.names)[:12]:
        print(line)
    return asleep


def single_calls(torch):
    """Part 2 (module docstring)."""
    import numpy as np

    dev = torch.device("cuda", 0)
    cps = cycles_per_second(torch)
    x = torch.randn(4096, device=dev)
    pinned = torch.empty(4096, pin_memory=True)
    host = np.arange(4096, dtype=np.int64)
    bodies = iter([
        lambda y: torch.cumsum(y, 0), lambda y: torch.sort(y)[0],
        lambda y: torch.topk(y, 8)[0], lambda y: torch.logcumsumexp(y, 0),
        lambda y: torch.cummax(y, 0)[0], lambda y: torch.erfinv(y.tanh()),
        lambda y: torch.lgamma(y), lambda y: torch.digamma(y.abs() + 1),
        lambda y: torch.cummin(y, 0)[0],
        lambda y: torch.nan_to_num(y).cumprod(0),
        lambda y: torch.atan2(y, y + 1), lambda y: torch.special.i0(y),
        lambda y: torch.polygamma(1, y.abs() + 1),
        lambda y: torch.special.erfcx(y),
        lambda y: torch.special.ndtri(y.sigmoid())])
    helpers = {
        "none": None,
        "pageable .cpu()": lambda: x.cpu(),
        ".tolist()": lambda: x[:16].tolist(),
        "pageable upload": lambda: torch.as_tensor(host, device=dev),
        "pinned copy + stream wait": lambda: (
            pinned.copy_(x, non_blocking=True),
            torch.cuda.current_stream(dev).synchronize()),
    }
    for label, helper in helpers.items():
        A, B = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        with torch.cuda.stream(A):
            torch.cuda._sleep(int(3.0 * cps))
            woke = A.record_event()
        t_sleep = time.perf_counter()
        th = None
        if helper is not None:
            def run_helper():
                with torch.cuda.stream(A):
                    helper()
            th = threading.Thread(target=run_helper, daemon=True)
            th.start()
            time.sleep(0.3)
        rows = []

        def clock(name, fn):
            t = time.perf_counter()
            out = fn()
            rows.append(f"{name} {time.perf_counter() - t:.3f}")
            return out
        with torch.cuda.stream(B):
            clock("launch+wait", lambda: ((x * 2).sum(), B.synchronize()))
            body = next(bodies)
            body(x)  # its kernels launched once, eagerly
            B.synchronize()
            cold = next(bodies)  # never launched before its capture
            for kind, fn in (("fresh", body), ("again", body),
                             ("never launched", cold)):
                g = torch.cuda.CUDAGraph()
                try:
                    clock(f"{kind}: begin",
                          lambda: g.capture_begin(
                              capture_error_mode="thread_local"))
                    clock(f"{kind}: body", lambda: fn(x))
                    clock(f"{kind}: end", g.capture_end)
                    clock(f"{kind}: replay+wait",
                          lambda: (g.replay(), B.synchronize()))
                except RuntimeError as exc:
                    rows.append(f"{kind}: failed ({exc})")
            gen = torch.Generator(device=dev)
            clock("register_generator_state",
                  lambda: torch.cuda.CUDAGraph().register_generator_state(
                      gen))
            clock("new stream", lambda: torch.cuda.Stream(dev))
            clock("1 GiB alloc", lambda: torch.empty(
                2 ** 28, dtype=torch.float32, device=dev))
        print(f"helper on the sleeping stream: {label}; woke "
              f"{woke.query()} at {time.perf_counter() - t_sleep:.3f} s; "
              f"main thread (s): " + ", ".join(rows), flush=True)
        if th is not None:
            th.join(timeout=30)
        woke.synchronize()


def big_graphs(torch):
    """Part 3 (module docstring)."""
    dev = torch.device("cuda", 0)
    cps = cycles_per_second(torch)
    x = torch.randn(256, device=dev)
    for n in (50, 200, 800, 3200):
        for kind in ("fresh", "again"):
            A, B = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
            with torch.cuda.stream(A):
                torch.cuda._sleep(int(2.0 * cps))
                woke = A.record_event()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(B):
                g.capture_begin(capture_error_mode="thread_local")
                y = x
                for _ in range(n):
                    y = y * 1.0001
                t = time.perf_counter()
                g.capture_end()
                end = time.perf_counter() - t
                t = time.perf_counter()
                g.replay()
                B.synchronize()
                rep = time.perf_counter() - t
            print(f"graph of {n} kernels ({kind}): capture_end {end:.3f} s, "
                  f"replay+wait {rep:.3f} s, the 2 s sleep still running "
                  f"{not woke.query()}", flush=True)
            woke.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sleep", type=float, default=12.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "stall_probe"))
    ap.add_argument("--parts", default="single,fleet",
                    help="comma-separated: single, big, fleet")
    ap.add_argument("--eager", action="store_true",
                    help="every fleet run steps eagerly after the stall")
    args = ap.parse_args()
    parts = args.parts.split(",")

    import torch

    if not torch.cuda.is_available():
        print("stall_probe: needs a CUDA device", file=sys.stderr)
        return 1
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    if "single" in parts:
        single_calls(torch)
    if "big" in parts:
        big_graphs(torch)
    if "fleet" in parts:
        for run in range(args.repeats):
            fleet_stall(torch, args.sleep, run, out,
                        eager_after_stall=args.eager)
    return 0


if __name__ == "__main__":
    sys.exit(main())
