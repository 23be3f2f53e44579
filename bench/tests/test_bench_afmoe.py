"""Family ``afmoe`` (``trinity-mini``) in the benchmark: the family
contract, a tiny cell through the harness on the CPU (correct, and its
fp8 control not), the window in the FLOP and attention arithmetic, and
the three readers it brings (``window_dead_kv_pct``, ``rows_per_step``,
``expert_roofline``) on hand-built runs, and the bf16 witness of
``bench/tools/witness.py``.

The tiny cell ``tiny-afmoe.long`` is the trinity-mini configuration file
at a small width (5 layers, window 8 over pages of 4), closed-loop
prompts of median 20 tokens.  Its check compares the mean gap, limit
0.06: on the CPU over seeds 1-6, 2**31 + 3 and 2**31 + 11 the bf16
program read at most 0.0396 and the fp8 control at least 0.0825 (top-2
of 8 sigmoid-routed experts at this width flips experts under bf16
rounding, so the program's reading varies with the sample); the tests
run seed 2**31 + 3, where the program read 0.0010 and the control 0.1233.
"""

import dataclasses
import json
import pathlib
import time
from types import SimpleNamespace

import pytest
import torch

from bench.cells import FAMILY_CONTRACT, load_cell, load_family, load_reader
from bench.harness import run_cell
from bench.tests.tiny import make_root
from bench.trace import Slice

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
SEED = 2**31 + 3
CELL = "tiny-afmoe.long"
SPANS = [(0, 1), (4, 14), (100, 613), (1024, 1025), (0, 32),
         (3000, 3400), (16000, 16300)]
ROWS = [(9, 1), (0, 32), (2047, 1), (2100, 32), (16000, 1), (0, 0)]
#: trinity-mini's (model FLOPs, (bytes, ops) of the step's attention) on
#: SPANS (37 generated tokens) and ROWS, and the same without a window
PINNED = (8167136952320.0, (680820736, 38905446400))
UNWINDOWED = (10012008120320.0, (1369243648, 45253918720))


def _raw():
    raw = json.loads((BENCH / "configs" / "trinity-mini.json").read_text())
    raw.update(name="tiny-afmoe", hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=96,
               moe_intermediate_size=32, num_experts=8,
               num_experts_per_tok=2, num_dense_layers=1,
               num_hidden_layers=5, sliding_window=8, vocab_size=512,
               layer_types=raw["layer_types"][:5],
               assumed={"init_std": 0.08, "norm_scale_std": 0.1,
                        "router_bias_std": 0.02})
    return raw


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny benchmark tree with the afmoe cell added as new files and
    entries only."""
    root = make_root(tmp_path_factory.mktemp("bench"))
    b = root / "bench"
    for d in ("families", "reference"):
        for src in (BENCH / d).glob("*.py"):
            dst = b / d / src.name
            dst.parent.mkdir(parents=True, exist_ok=True)
            if not dst.exists():
                dst.write_bytes(src.read_bytes())
    (b / "configs" / "tiny-afmoe.json").write_text(json.dumps(_raw()))
    (b / "traffic" / "long.json").write_text(json.dumps({
        "loop": "closed", "clients": 4, "per_client": 64,
        "warmup_completions": 2, "shape_seed": 7, "prompt_median": 20,
        "prompt_cap": 40, "output_median": 6, "output_cap": 12}))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "config": "tiny-afmoe", "traffic": "long",
        "engine": {"page_size": 4, "max_batch": 4, "prefill_chunk": 4,
                   "max_pages_per_seq": 16, "num_pages": 64,
                   "prefix_cache": False, "reclaim_policy": "oa-validate",
                   "speculative_k": 0},
        "profile_steps": 4,
        "check": {"limits": {"mean_gap": 0.06}, "sample_tokens": 64}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-afmoe",
                             "file": "bench/configs/tiny-afmoe.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny-afmoe",
                               "traffic": "long", "chips": 1})
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in real["per_layer"]:
        if "trinity-mini.long-chat" in m.get("workloads", ()):
            bench["per_layer"].append({**m, "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _spec():
    return load_family(REPO, "afmoe").spec(json.loads(
        (BENCH / "configs" / "trinity-mini.json").read_text()))


def test_the_family_keeps_the_contract(root):
    fam = load_family(REPO, "afmoe")
    assert all(callable(getattr(fam, n)) for n in FAMILY_CONTRACT)
    assert callable(fam.expert_work) and fam.EXPERT_KERNELS
    cell = load_cell(root, CELL)
    assert cell.spec.n_sliding == 4 and cell.spec.n_layers == 5
    assert cell.family.attention_launches(cell.spec) == 5
    spec = _spec()
    assert (spec.n_layers, spec.n_sliding, spec.window) == (32, 24, 2048)
    assert round(spec.active_params() / 1e9, 2) == 2.65  # 3.06 with the head


def test_the_tiny_cell_runs_correct_through_the_harness(root):
    out = run_cell(load_cell(root, CELL), SEED, 1.0, True, "cpu",
                   time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["compared"]
    assert out["metrics"]["rows_per_step"]["value"] > 0
    assert 0 < out["metrics"]["window_dead_kv_pct"]["value"] < 100
    # no device trace on the CPU: the roofline reads nothing
    assert "expert_roofline" not in out["metrics"]


def test_the_fp8_control_fails_the_tiny_cell(root):
    out = run_cell(load_cell(root, CELL), SEED, 1.0, False, "cpu",
                   time.perf_counter(), control=True, log=lambda m: None)
    assert out["program"]["correct"]
    assert not out["correct"], out["compared"]


def test_the_bf16_witness_rounds_the_products_alone(root):
    """``precision="bf16"`` (``bench/tools/witness.py``'s witness) moves
    the logits by bf16's rounding of the products: off the float32
    reference, in the median logit, by far less than the fp8 control (the
    widest error is an expert flipped by either); its first choices are
    judged as the control's are."""
    from bench.check import Served, compare
    from bench.tools.witness import picks

    cell = load_cell(root, CELL)
    fam, spec = cell.family, cell.spec
    params = fam.weights(spec, SEED, "cpu")
    toks = list(range(2, 60))
    ref = fam.forward_logits(spec, params, toks)
    err = {p: float((fam.forward_logits(spec, params, toks, precision=p)
                     - ref).abs().median()) for p in ("bf16", "fp8")}
    assert 0 < err["bf16"] < err["fp8"] / 4, err
    served = [Served(toks[:30], toks[30:])]
    judged = compare(fam, spec, SEED, "cpu",
                     picks(fam, spec, SEED, "cpu", served, "bf16"))
    assert judged.positions == 28 and judged.mean_gap < 0.01, judged


def test_model_flops_and_attention_work_count_the_window():
    fam, spec = load_family(REPO, "afmoe"), _spec()
    got = (fam.model_flops(spec, SPANS, 37), fam.attention_work(spec, ROWS))
    assert got == PINNED
    wide = dataclasses.replace(spec, window=0)
    assert (fam.model_flops(wide, SPANS, 37),
            fam.attention_work(wide, ROWS)) == UNWINDOWED
    # below the window every layer is full attention
    short = [(0, 100)]
    assert fam.model_flops(spec, short, 0) == fam.model_flops(wide, short, 0)
    assert fam.attention_launches(spec) == 32


def test_expert_work_counts_live_tokens_and_touched_experts():
    fam, spec = load_family(REPO, "afmoe"), _spec()
    assert fam.expert_work(spec, 0) == (0, 0)
    b1, f1 = fam.expert_work(spec, 1)
    b64, f64 = fam.expert_work(spec, 64)
    assert f64 == 64 * f1 == 64 * 30 * 2.0 * 8 * 3 * 2048 * 1024
    # one token touches 8 experts' weights; 64 nearly all 128
    w = 30 * 3 * 2048 * 1024 * 2
    assert abs(b1 - w * 8 - 30 * 8 * 3 * (2048 + 1024) * 2) < 1e-3
    assert 120 * w < b64 < 128 * w + 30 * 512 * 3 * 3072 * 2


def _tracer_steps(t0, counters, rows):
    from repro_torch.spans import new_tracer

    tr = new_tracer()
    for i, (c, r) in enumerate(zip(counters, rows)):
        a = t0 + 0.01 * i
        with tr.span("engine.step") as s:
            with tr.span("runner.launch") as ln:
                ln.set(positions=64)
            ln.t0, ln.t1 = a, a + 0.001
            s.set(tokens=3, **c, **({} if r is None else {"rows": r}))
        s.t0, s.t1 = a, a + 0.009
    return tr


def test_the_readers_on_hand_built_runs(root):
    t0 = 5.0e6
    counters = [{"window_dead_pages": 40, "pages_in_use": 100},
                {"window_dead_pages": 80, "pages_in_use": 300}]
    _tracer_steps(t0, counters, [3, 5])
    run = SimpleNamespace(w0=t0 - 1, w1=t0 + 1, spec=_spec())
    # 100 × 120 dead pages × 24/32 of the layers ÷ 400 held
    assert load_reader(root, "window_dead_kv_pct")(run) == pytest.approx(
        22.5)
    assert load_reader(root, "rows_per_step")(run) == 4.0
    # a program without the counters: nothing, not 0
    _tracer_steps(t0 + 100, [{}, {}], [None, None])
    old = SimpleNamespace(w0=t0 + 99, w1=t0 + 101, spec=_spec())
    assert load_reader(root, "window_dead_kv_pct")(old) is None
    assert load_reader(root, "rows_per_step")(old) is None
    # expert_roofline: two steps of 40 and 1 live tokens, grouped kernels
    # of 3 ms and 1 ms (another kernel not counted)
    fam = load_family(REPO, "afmoe")
    steps = [SimpleNamespace(rows=[(100, 32), (50, 8)]),
             SimpleNamespace(rows=[(9, 1), (0, 0)])]
    ops = [("void cutlass::GroupProblemShape<...>", 0.0, 0.003),
           ("prepare_grouped_gemm_data<...>", 0.003, 0.004),
           ("nvjet_gemm", 0.004, 0.010)]
    sl = Slice(0.0, 0.01, ops, [], steps, 64, 64)
    run = SimpleNamespace(profile=sl, family=fam, spec=_spec())
    from bench.roofline import bound_s
    want = 100 * (bound_s(*fam.expert_work(run.spec, 40))
                  + bound_s(*fam.expert_work(run.spec, 1))) / 0.004
    assert load_reader(root, "expert_roofline")(run) == pytest.approx(want)
    # a trace without grouped kernels (the padded layout): nothing
    sl.ops = ops[2:]
    assert load_reader(root, "expert_roofline")(run) is None
