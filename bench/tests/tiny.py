"""A tiny benchmark tree for the CPU tests: the real readers and family
modules, tiny configurations, mixes and cells, under a temporary root."""

from __future__ import annotations

import json
import pathlib
import shutil

from bench.spec import ModelSpec

BENCH = pathlib.Path(__file__).resolve().parent.parent
TOY = BENCH / "tests" / "toy"

#: the shipped families' specs at a tiny width, for tests of their parts
SPECS = {
    "dense": ModelSpec(name="tiny-dense", family="dense", norm="nonparam_ln",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab=256, rope_theta=1e4,
                       tied=True, init_std=0.08),
    "moe": ModelSpec(name="tiny-moe", family="moe", norm="rmsnorm",
                     n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=32, vocab=256, rope_theta=1e4,
                     tied=False, n_experts=8, top_k=2, norm_eps=1e-6,
                     init_std=0.08, norm_scale_std=0.1),
}
DENSE = {"name": "tiny-dense", "family": "dense", "norm": "nonparam_ln",
         "hidden_size": 128, "intermediate_size": 256,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 4, "vocab_size": 512,
         "rope_theta": 10000.0, "tie_word_embeddings": True,
         "assumed": {"init_std": 0.08}}
MOE = {"name": "tiny-moe", "family": "moe", "norm": "rmsnorm",
       "hidden_size": 128, "intermediate_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 4, "num_experts": 8,
       "num_experts_per_tok": 4, "vocab_size": 512, "rope_theta": 10000.0,
       "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
       "assumed": {"init_std": 0.08, "norm_scale_std": 0.1}}
OPEN = {"loop": "open", "process": "poisson", "rate_rps": 40.0,
        "warmup_s": 0.5, "tail_s": 20.0, "shape_seed": 5,
        "shared_prefix": {"count": 2, "tokens": 16, "zipf_s": 1.0},
        "prompt_median": 6, "prompt_cap": 12, "output_median": 6,
        "output_cap": 12, "fill_cache": True}
CLOSED = {"loop": "closed", "clients": 4, "per_client": 64,
          "warmup_completions": 2, "shape_seed": 6, "prompt_median": 8,
          "prompt_cap": 16, "output_median": 6, "output_cap": 12}
ENGINE = {"page_size": 4, "max_batch": 4, "prefill_chunk": 4,
          "max_pages_per_seq": 12, "num_pages": 256,
          "reclaim_policy": "oa-validate", "speculative_k": 0}


#: each tiny cell's check, set as the full-size cells' are: the dense
#: cell compares the widest gap, the MoE cell the mean gap, over more
#: tokens.  On the CPU over seeds 1-8, 2**31 + 3 and 2**31 + 11 (a tiny run's
#: sample depends on which requests its 1 s window finished, so each seed
#: was read several times), the dense cell's bf16 program read a widest
#: gap of at most 0.0274 and its fp8 control at least 0.0875; the MoE
#: cell's program a mean gap of at most 0.00137 and its control at least
#: 0.00635.  (Top-2 of 8 experts at this width flips experts under bf16
#: rounding often enough that no mean-gap limit separated the two.)
CHECKS = {"tiny-dense.open": {"limits": {"widest_gap": 0.05},
                              "sample_tokens": 64},
          "tiny-moe.closed": {"limits": {"mean_gap": 0.003},
                              "sample_tokens": 160}}

#: the toy family's cell ``tiny-relu2.closed`` (``toy/workloads/``) checks
#: the widest gap, limit 0.05: on the CPU over seeds 1-12, 2**31 + 3,
#: 2**31 + 5, 2**31 + 11 and 2**31 + 19 its bf16 program read at most
#: 0.0265 and its fp8 control at least 0.0968.


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """Write the tree: cells ``tiny-dense.open`` (shared prefixes, cache
    on) and ``tiny-moe.closed``, every real metric reader and family
    module."""
    root = pathlib.Path(tmp)
    b = root / "bench"
    for d in ("configs", "traffic", "workloads"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "families"):
        shutil.copytree(BENCH / d, b / d, dirs_exist_ok=True)
    for cfg in (DENSE, MOE):
        (b / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, mix in (("open", OPEN), ("closed", CLOSED)):
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = {"tiny-dense.open": ("tiny-dense", "open", True),
             "tiny-moe.closed": ("tiny-moe", "closed", False)}
    for cell, (cfg, mix, cache) in cells.items():
        own = {"config": cfg, "traffic": mix,
               "engine": {**ENGINE, "prefix_cache": cache,
                          **({"prefix_cache_pages": 32} if cache else {})},
               "profile_steps": 4,
               "check": CHECKS[cell]}
        (b / "workloads" / f"{cell}.json").write_text(json.dumps(own))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench = {
        "configs": [{"name": c["name"], "file": f"bench/configs/"
                     f"{c['name']}.json"} for c in (DENSE, MOE)],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, (c, t, _) in cells.items()],
        "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                       for m in real["end_to_end"]],
        "per_layer": [{k: v for k, v in m.items() if k != "workloads"}
                      for m in real["per_layer"]],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def add_toy_family(root: pathlib.Path) -> list[pathlib.Path]:
    """Add the toy family ``relu2`` to the tree at ``root`` as new files
    only: its family module, its reference, its configuration and its
    cell ``tiny-relu2.closed`` (copies of ``bench/tests/toy/``), and their
    entries in ``BENCHMARK.json``.  Returns the files added."""
    root = pathlib.Path(root)
    added = []
    for src in sorted(TOY.rglob("*.json")) + sorted(TOY.rglob("*.py")):
        dst = root / "bench" / src.relative_to(TOY)
        if dst.exists():
            raise FileExistsError(dst)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
        added.append(dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-relu2",
                             "file": "bench/configs/tiny-relu2.json"})
    bench["workloads"].append({"name": "tiny-relu2.closed",
                               "config": "tiny-relu2", "traffic": "closed",
                               "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return added
