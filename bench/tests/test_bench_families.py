"""The family modules (``bench/families/``, the contract of
``bench/cells.py``).

The shipped ``dense`` and ``moe`` are pinned to what the harness computed
before it reached them through a family module: the program config equal
field for field to the harness's former ``arch_config`` (copied here), the
weights' bits (digests of the former ``make_weights``'s draws), and the
model FLOPs and one step's attention work equal to the values the former
``Run.model_flops`` and ``roofline.attention_work`` × layers gave on fixed
spans and rows, written in as numbers.

A toy third family (``bench/tests/toy/``: a dense decoder with a
squared-ReLU MLP, its own reference) enters a benchmark tree as new files
and BENCHMARK.json entries only, and its cell runs correct through
``load_cell`` → ``run_cell`` → ``compare`` while its fp8 control does not.
"""

import dataclasses
import hashlib
import json
import pathlib
import time

import pytest
import torch

from bench.cells import load_cell, load_family
from bench.drive import Rec
from bench.harness import run_cell
from bench.tests.tiny import SPECS as TINY
from bench.tests.tiny import add_toy_family, make_root
from bench.timeline import Run

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
CONFIGS = {"dense": "olmo-1b", "moe": "olmoe-1b-7b"}
SPANS = [(0, 1), (4, 14), (100, 613), (1024, 1025), (0, 32)]
GENERATED = 37
ROWS = [(9, 1), (0, 4), (511, 1), (1000, 32), (0, 0)]
#: (model FLOPs, (bytes, ops) of the step's attention) on SPANS and ROWS
PINNED = {
    "tiny-dense": (187083776.0, (856064, 16926720)),
    "tiny-moe": (160846848.0, (856064, 16926720)),
    "olmo-1b": (1227992858624.0, (219152384, 4333240320)),
    "olmoe-1b-7b": (1230329085952.0, (219152384, 4333240320)),
}
#: sha256 of the weights: (bf16 from seed 2**31 + 7, float32 from seed 0)
WEIGHTS = {
    "dense": (
        "bb1b81fe6dfb6ba25ef0ccabb98098dbd2aa5aae1f8d288900d38283b59e407a",
        "b509a4616fda545e6fcdb9bb6dd68c95b897cf937cafe3cec4425c40d9578446"),
    "moe": (
        "1002fffce127889b1f67b1630e76d790d4056672ffb5d5c37358e0b3177ac72d",
        "b2e9982006a0a86acb8f39c18f6c0f9e7d6a9711b87e2b9dca97161f2fe314ea"),
}


def _former_arch_config(spec):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(
        name=spec.name, family=spec.family, n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff, vocab=spec.vocab,
        vocab_padded=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, norm_type=spec.norm, mlp_type="swiglu",
        moe=spec.family == "moe", n_experts=spec.n_experts,
        top_k=spec.top_k, tie_embeddings=spec.tied, remat="none",
        fsdp=False)


def _specs(family):
    """(family module, [its TINY spec, its configuration file's spec])."""
    fam = load_family(REPO, family)
    raw = json.loads((BENCH / "configs" / f"{CONFIGS[family]}.json")
                     .read_text())
    return fam, [TINY[family], fam.spec(raw)]


def _digest(params) -> str:
    h = hashlib.sha256()

    def walk(path, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{path}/{k}", x[k])
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(f"{path}/{i}", v)
        else:
            h.update(f"{path}:{x.dtype}:{tuple(x.shape)};".encode())
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    walk("", params)
    return h.hexdigest()


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_program_config_equals_the_former_arch_config(family):
    fam, specs = _specs(family)
    for spec in specs:
        assert (dataclasses.asdict(fam.program_config(spec))
                == dataclasses.asdict(_former_arch_config(spec))), spec.name


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_weights_keep_their_bits(family):
    fam = load_family(REPO, family)
    spec = TINY[family]
    assert (_digest(fam.weights(spec, 2**31 + 7, "cpu")),
            _digest(fam.weights(spec, 0, "cpu", dtype=torch.float32))
            ) == WEIGHTS[family]


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_flops_and_attention_work_keep_their_values(family):
    fam, specs = _specs(family)
    recs = [Rec(11.0, [1], 5, committed_w0=c0, committed_w1=c1)
            for c0, c1 in SPANS]
    recs.append(Rec(11.0, [1], GENERATED, token_times=[
        11.0 + 0.1 * i for i in range(GENERATED)]))
    for spec in specs:
        flops, work = PINNED[spec.name]
        run = Run(w0=10.0, w1=20.0, recs=recs, steps=[], family=fam,
                  spec=spec, stats_w0={}, stats_w1={})
        assert run.spans() == SPANS
        assert run.model_flops() == flops
        assert fam.model_flops(spec, SPANS, GENERATED) == flops
        assert fam.attention_work(spec, ROWS) == work
        assert fam.attention_launches(spec) == spec.n_layers


def test_a_family_without_the_whole_contract_is_refused(tmp_path):
    root = make_root(tmp_path)
    (root / "bench/families/half.py").write_text(
        "def spec(raw):\n    return raw\n")
    with pytest.raises(AttributeError, match="weights"):
        load_family(root, "half")


def _files(tree: pathlib.Path) -> dict:
    return {p: p.read_bytes() for p in tree.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("seed", [9, 2**31 + 29])
def test_a_new_family_enters_as_new_files_only(tmp_path, seed):
    root = make_root(tmp_path / "root")
    before = _files(root / "bench")
    real = _files(BENCH)
    added = add_toy_family(root)
    after = _files(root / "bench")
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == set(added)
    assert all(p.is_relative_to(root) for p in added)
    cell = load_cell(root, "tiny-relu2.closed")
    assert pathlib.Path(cell.family.__file__).is_relative_to(root)
    assert "w_gate" not in cell.family.weights(
        cell.spec, seed, "cpu")["blocks"][0]["mlp"]
    out = run_cell(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                   control=True, log=lambda m: None)
    assert out["program"]["correct"], out["program"]["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not out["correct"], out["compared"]
    assert _files(BENCH) == real
