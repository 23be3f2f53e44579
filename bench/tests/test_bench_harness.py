"""The harness on the CPU: discovery from data files, the traffic, the
metric arithmetic on hand-built timelines, the refusal without a card, and
whole runs of tiny cells, sound and with the timed path broken."""

import json
import math
from collections import Counter
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from bench.cells import load_cell, load_family, load_reader
from bench.drive import Rec, StepRec
from bench.generate import Traffic
from bench.harness import run_cell
from bench.roofline import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S,
                            attention_work, bound_s)
from bench.spec import ModelSpec
from bench.tests.tiny import make_root
from bench.timeline import Run, percentile
from bench.trace import Slice

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
SPEC = ModelSpec(name="m", family="dense", norm="nonparam_ln", n_layers=2,
                 d_model=8, n_heads=2, n_kv_heads=2, head_dim=4, d_ff=16,
                 vocab=32, rope_theta=1e4, tied=True)
DENSE = load_family(REPO, "dense")


# -- discovery ---------------------------------------------------------------

def test_every_cell_of_the_benchmark_is_found_with_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(REPO, w["name"])
        assert cell.spec.name == w["config"] == cell.config
        assert cell.engine["num_pages"] > 0
        assert {m["name"] for m in cell.end_to_end} >= {"gen_tok_s",
                                                        "setup_s"}
        assert cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_reader(REPO, m["name"]))
    for c in bench["configs"]:
        raw = json.loads((REPO / c["file"]).read_text())
        assert load_family(REPO, raw["family"]).spec(raw).name == c["name"]


def test_a_new_cell_and_metric_are_found_by_adding_files(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.other",
                               "config": "tiny-dense", "traffic": "closed",
                               "chips": 1})
    bench["per_layer"].append({"name": "dummy.count", "unit": "steps",
                               "workloads": ["tiny-dense.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    own = json.loads((root / "bench/workloads/tiny-moe.closed.json")
                     .read_text())
    own["config"] = "tiny-dense"
    (root / "bench/workloads/tiny-dense.other.json").write_text(
        json.dumps(own))
    (root / "bench/metrics/dummy.count.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    cell = load_cell(root, "tiny-dense.other")
    assert cell.mix["loop"] == "closed" and cell.spec.family == "dense"
    assert "dummy.count" in [m["name"] for m in cell.per_layer]
    assert "dummy.count" not in [
        m["name"] for m in load_cell(root, "tiny-moe.closed").per_layer]
    assert load_reader(root, "dummy.count")(
        type("R", (), {"steps": [1, 2]})()) == 2


def test_a_cell_whose_file_disagrees_is_refused(tmp_path):
    root = make_root(tmp_path)
    path = root / "bench/workloads/tiny-moe.closed.json"
    own = json.loads(path.read_text())
    own["traffic"] = "open"
    path.write_text(json.dumps(own))
    with pytest.raises(ValueError, match="traffic"):
        load_cell(root, "tiny-moe.closed")


# -- traffic -----------------------------------------------------------------

MIX = {"loop": "open", "rate_rps": 20.0, "shape_seed": 3,
       "shared_prefix": {"count": 4, "tokens": 32, "zipf_s": 1.0},
       "prompt_median": 20, "prompt_cap": 64, "output_median": 10,
       "output_cap": 40}


BOUNDS = (0.0, 5.0, 20.0, 30.0)


def _open(seed):
    t = Traffic(MIX, seed, 1000)
    return [(due, s.user_len, s.max_new, s.prefix, t.prompt(s))
            for due, s in t.arrivals(BOUNDS)]


def test_traffic_is_deterministic_in_the_seed():
    a, b, c = _open(2**31 + 5), _open(2**31 + 5), _open(2**31 + 6)
    assert a == b
    assert a != c
    assert all(len(x[4]) == 32 + x[1] for x in a)
    assert [x[0] for x in a] == sorted(x[0] for x in a)
    # another seed: in each span the same sizes and gaps, in another order
    for lo, hi in zip(BOUNDS, BOUNDS[1:]):
        span = [[x for x in v if lo <= x[0] < hi] for v in (a, c)]
        assert len(span[0]) == len(span[1]) > 0
        assert sorted(x[1:3] for x in span[0]) == sorted(
            x[1:3] for x in span[1])
        # the seed picks which system prompt is the most popular
        assert sorted(Counter(x[3] for x in span[0]).values()) == sorted(
            Counter(x[3] for x in span[1]).values())
        gaps = [sorted(round(y - x, 9) for x, y in zip(
            [lo] + [e[0] for e in v], [e[0] for e in v])) for v in span]
        assert gaps[0] == pytest.approx(gaps[1], abs=1e-8)


def test_closed_loop_callers_start_out_of_step():
    mix = {"loop": "closed", "clients": 8, "shape_seed": 1,
           "prompt_median": 20, "prompt_cap": 64, "output_median": 30,
           "output_cap": 90}
    lanes = Traffic(mix, 9, 1000).client_specs(5)
    assert len(lanes) == 8 and all(len(lane) == 5 for lane in lanes)
    firsts = [lane[0].max_new for lane in lanes]
    assert len(set(firsts)) > 4 and min(firsts) >= 1
    again = Traffic(mix, 9, 1000).client_specs(5)
    assert [[s.max_new for s in lane] for lane in again] == [
        [s.max_new for s in lane] for lane in lanes]


# -- metric arithmetic ---------------------------------------------------------

def _run(recs, steps=(), **kw):
    stats = {"steps": 0, "tokens_committed": 0, "prefix_tokens_reused": 0}
    return Run(w0=10.0, w1=20.0, recs=list(recs), steps=list(steps),
               family=DENSE, spec=SPEC, stats_w0=stats,
               stats_w1=kw.pop("stats_w1", stats), **kw)


def _steady(t_due, first, n, gap=0.1):
    return Rec(t_due, [1] * 4, n, token_times=[first + i * gap
                                                for i in range(n)])


def _read(name, run):
    return load_reader(REPO, name)(run)


def test_percentile_interpolates_between_ranks():
    assert percentile([], 95) is None
    assert percentile([4.0], 95) == 4.0
    assert percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert percentile([1, 2, 3, 4], 50) == 2.5


def test_tails_and_rate_on_a_hand_built_timeline():
    # 9 requests due at 11..19 s, first token 0.25 s after due, then a
    # token every 0.1 s for 20 tokens
    recs = [_steady(11.0 + i, 11.25 + i, 20) for i in range(9)]
    recs.append(_steady(5.0, 9.55, 200))  # due before the window
    run = _run(recs)
    assert [round(x, 9) for x in run.ttfts_s()] == [0.25] * 9
    assert _read("ttft_p95_ms", run) == pytest.approx(250.0)
    assert _read("itl_p95_ms", run) == pytest.approx(100.0)
    # tokens inside (10, 20]: 7 × 20, request 7's first 18 (18.25 ..
    # 19.95), request 8's first 8 (19.25 .. 19.95), request 9's tokens
    # 5 .. 104 (10.05 .. 19.95)
    inside = 7 * 20 + 18 + 8 + 100
    assert _read("gen_tok_s", run) == pytest.approx(inside / 10.0)


def test_a_stall_inside_the_window_moves_the_tails():
    recs = [_steady(11.0 + i, 11.25 + i, 20) for i in range(9)]
    base = _run(recs)
    stalled = []
    for r in recs:  # the engine stops from 14 s to 16 s
        times = [t if t < 14.0 else t + 2.0 for t in r.token_times]
        first = r.t_due + 0.2
        if 14.0 <= first:
            first = max(first + 2.0 - (r.t_due - 14.0), 16.0 + 0.2)
        times[0] = first if r.t_due >= 14.0 else times[0]
        stalled.append(Rec(r.t_due, r.prompt, r.max_new, token_times=sorted(
            times)))
    run = _run(stalled)
    assert _read("itl_p95_ms", run) > _read("itl_p95_ms", base)
    assert _read("ttft_p95_ms", run) > _read("ttft_p95_ms", base)
    assert _read("gen_tok_s", run) < _read("gen_tok_s", base)


def test_a_request_without_a_first_token_counts_its_wait():
    late = Rec(18.0, [1], 5)  # nothing by the window's end
    refused = Rec(12.0, [1], 5, failed=True)
    run = _run([late, _steady(11.0, 11.5, 3)])
    assert sorted(run.ttfts_s()) == pytest.approx([0.5, 2.0])
    assert math.isinf(max(_run([refused]).ttfts_s()))


def test_roofline_and_mfu_arithmetic():
    # one decode row with 9 positions before, one prefill row of 4 tokens
    rows = [(9, 1), (0, 4)]
    byts, ops = attention_work(SPEC, rows)
    kv = 2 * 2 * 4 * 2  # K and V, 2 heads of 4, 2 bytes: a position
    assert byts == (10 * kv + 2 * 1 * kv + 2 * 1 * 2 * 4 * 2
                    + 4 * kv + 2 * 4 * kv + 2 * 4 * 2 * 4 * 2)
    assert ops == 4 * 4 * 2 * (10 + (1 + 2 + 3 + 4))
    assert bound_s(byts, ops) == max(byts / PEAK_HBM_BYTES_PER_S,
                                     ops / PEAK_BF16_FLOPS)
    # one request computing positions 4..13 inside the window, 10 of them
    # generated tokens there
    r = Rec(11.0, [1] * 4, 10, token_times=[11.0 + i for i in range(10)],
            committed_w0=4, committed_w1=14)
    run = _run([r])
    active = 2 * (8 * 4 * 8 + 3 * 8 * 16)
    flops = (2 * active * 10 + 4 * 2 * 2 * 4 * sum(range(5, 15))
             + 2 * 8 * 32 * 10)
    assert run.model_flops() == flops
    assert _read("mfu_pct", run) == pytest.approx(
        100 * flops / 10.0 / PEAK_BF16_FLOPS)


def test_slice_readers_on_a_hand_built_trace():
    steps = [StepRec(0.0, 1.0, 0, rows=[(9, 1), (0, 4)])] * 2
    ops = [("paged_attention_kernel<bf16>", 0.0, 0.002),
           ("paged_attention_kernel<bf16>", 0.003, 0.005),
           ("gemm", 0.0015, 0.004), ("gemm", 0.008, 0.009)]
    sl = Slice(0.0, 0.010, ops, [("absorb", 0.006, 0.0075)], steps,
               launches=4, expected=4)
    run = _run([], profile=sl)
    assert sl.busy_s() == pytest.approx(0.006)
    assert _read("device_idle_pct", run) == pytest.approx(40.0)
    bound = 2 * SPEC.n_layers * bound_s(*attention_work(SPEC, steps[0].rows))
    assert _read("attn_roofline", run) == pytest.approx(
        100 * bound / 0.004)
    gaps = dict(sl.breakdown()["idle_gaps"])
    assert gaps["absorb"] == pytest.approx(0.003)
    assert gaps["outside the engine's step"] == pytest.approx(0.001)
    # a trace that, taken again, still missed a launch reads no roofline:
    # the kernel time it holds is not all of the work the bound counts
    short = Slice(0.0, 0.010, ops[1:], [], steps, launches=3, expected=4)
    assert _read("attn_roofline", _run([], profile=short)) is None
    assert _read("device_idle_pct", _run([], profile=short)) is not None


# -- runs --------------------------------------------------------------------

def test_run_py_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "olmo-1b.chat", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _cell_run(root, cell, seed=2**31 + 11, trace=False, control=False):
    return run_cell(load_cell(root, cell), seed, 1.0, trace, "cpu",
                    time.perf_counter(), control=control,
                    log=lambda m: None)


def test_set_up_fills_the_prefix_cache_to_its_cap(root):
    from bench.drive import Loop
    from bench.harness import build_engine

    cell = load_cell(root, "tiny-dense.open")
    eng = build_engine(cell, 5, torch.device("cpu"))
    loop = Loop(eng, Traffic(cell.mix, 5, cell.spec.vocab))
    sent = loop.fill(slack_pages=2)
    index = eng.scheduler.index
    most = max(-(-len(loop.traffic.fill_prompt(s)) // 4)
               for s in loop.traffic.fill_specs(sent))
    assert sent == loop.filled["requests"] > 2
    assert index.cap - 2 - 2 * eng.max_batch * most <= len(index.pages)
    assert len(index.pages) <= index.cap
    assert not eng.scheduler.running and not eng.scheduler.queue


@pytest.mark.parametrize("cell", ["tiny-dense.open", "tiny-moe.closed"])
def test_a_sound_run_is_correct(root, cell):
    out = _cell_run(root, cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"gen_tok_s", "ttft_p95_ms", "itl_p95_ms",
                                   "setup_s"}
    assert list(out)[-1] == "compared"


def test_a_traced_run_reports_the_host_metrics(root):
    out = _cell_run(root, "tiny-dense.open", trace=True)
    assert out["correct"]
    # no card: nothing from a device trace
    assert {"sched_ms_per_step", "tok_per_step", "step_ms", "mfu_pct",
            "prefix_hit_pct"} <= set(out["metrics"])
    assert not {"attn_roofline", "device_idle_pct"} & set(out["metrics"])
    assert out["metrics"]["prefix_hit_pct"]["value"] > 0


@pytest.mark.parametrize("cell,seed", [
    ("tiny-dense.open", 1), ("tiny-dense.open", 2),
    ("tiny-dense.open", 2**31 + 3), ("tiny-moe.closed", 2**31 + 3)])
def test_the_fp8_control_fails_the_check(root, cell, seed):
    # the program's run is correct; the fp8 reference put in its place on
    # the same sample, judged by the same comparison and limits, is not
    out = _cell_run(root, cell, seed=seed, control=True)
    assert out["program"]["correct"], out["program"]["compared"]
    assert not out["correct"], out["compared"]
    assert out["compared"].keys() == out["program"]["compared"].keys()
    assert list(out)[-1] == "compared"


def _altered_token(monkeypatch):
    from repro_torch.serving import runner

    collect = runner.ModelRunner.collect

    def bad(self, pending):
        res = collect(self, pending)
        return res._replace(tokens=(res.tokens + 1) % 512)
    monkeypatch.setattr(runner.ModelRunner, "collect", bad)


def _state_unchanged(monkeypatch):
    from repro_torch.serving import paged_decode

    attend = paged_decode.paged_attention

    def bad(*a, append=None, **k):
        kns, vns, oks = append
        return attend(*a, append=(kns, vns, [o & False for o in oks]), **k)
    monkeypatch.setattr(paged_decode, "paged_attention", bad)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["token-altered", "kv-state-unchanged"])
@pytest.mark.parametrize("seed", [2**31 + 11, 4])
def test_a_broken_timed_path_is_not_correct(root, seed, fault, monkeypatch):
    fault(monkeypatch)
    out = _cell_run(root, "tiny-dense.open", seed=seed)
    assert not out["correct"], out["compared"]
