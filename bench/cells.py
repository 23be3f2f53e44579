"""Finding a cell and everything it names, by name, from data files.

``BENCHMARK.json`` at the root lists the cells, configurations and
metrics.  A cell's own file, ``bench/workloads/<cell>.json``, names its
configuration and traffic mix (which must agree with ``BENCHMARK.json``)
and holds the engine settings, any traffic parameters it sets for itself
(the open loop's rate), the profiled slice's length and the limit of its
correctness check.  The configuration is the file ``BENCHMARK.json`` gives
it; the mix is ``bench/traffic/<mix>.json``; each metric's reader is
``bench/metrics/<metric>.py``.  A later cell, configuration, mix or
metric is a new file and a new entry, and no file already there changes.

The configuration's ``family`` value names its model family, the module
``bench/families/<family>.py``, which owns everything that depends on the
architecture (:data:`FAMILY_CONTRACT`):

- ``spec(raw)``: the family's sizes from the configuration file's object,
  a frozen dataclass with at least ``name`` and ``vocab`` (``Cell.spec``);
- ``weights(spec, seed, device, dtype=torch.bfloat16)``: the weights in
  the layout the program takes, the same bits from the same seed;
- ``forward_logits(spec, params, tokens, precision="fp32")``: the plain
  float32 reference's logits [S, vocab] of one sequence, and with
  ``precision="fp8"`` its control; it lives in a file under
  ``bench/reference/`` that imports nothing of the program;
- ``program_config(spec)``: the program's config object (the program
  imported inside the function);
- ``model_flops(spec, spans, generated)``: the useful FLOPs of a window in
  which each request computed its positions ``c0 .. c1 - 1`` (``spans``,
  its (c0, c1)) and ``generated`` tokens reached the host;
- ``attention_work(spec, rows)``: (bytes, ops) of one step's attention in
  all its layers, ``rows`` the step's (context before it, tokens
  appended) per running row; ``attention_launches(spec)``: the
  ``paged_attention_kernel`` launches of a step.

A new architecture is a configuration file, a family module, its
reference and new ``BENCHMARK.json`` entries: new files only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import types

FAMILY_CONTRACT = ("spec", "weights", "forward_logits", "program_config",
                   "model_flops", "attention_work", "attention_launches")


@dataclasses.dataclass
class Cell:
    name: str
    root: pathlib.Path
    chips: int
    config: str
    family: types.ModuleType  # bench/families/<family>.py
    spec: object  # family.spec(<the configuration file>)
    mix_name: str
    mix: dict  # the mix file, with the cell's own traffic parameters
    engine: dict
    check: dict
    profile_steps: int
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    own = json.loads((root / "bench" / "workloads" / f"{name}.json")
                     .read_text())
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"{name}: its file names {key} {own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    raw = json.loads((root / cfg["file"]).read_text())
    family = load_family(root, raw["family"])
    mix = json.loads((root / "bench" / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    mix.update(own.get("traffic_params", {}))
    return Cell(
        name=name, root=root, chips=int(entry["chips"]),
        config=entry["config"], family=family, spec=family.spec(raw),
        mix_name=entry["traffic"], mix=mix, engine=dict(own["engine"]),
        check=dict(own["check"]), profile_steps=int(own["profile_steps"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_file(path: pathlib.Path, prefix: str) -> types.ModuleType:
    """The module of the Python file ``path``, loaded by path under a
    name made of ``prefix`` and the file's stem, and entered in
    ``sys.modules`` under it (a dataclass looks its module up there)."""
    path = pathlib.Path(path)
    name = prefix + "_" + path.stem.replace(".", "_").replace("-", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def load_reader(root: pathlib.Path, metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    return load_file(pathlib.Path(root) / "bench" / "metrics"
                     / f"{metric}.py", "bench_metric").read


def load_family(root: pathlib.Path, family: str) -> types.ModuleType:
    """The module ``bench/families/<family>.py`` (module docstring), which
    has to define every name of :data:`FAMILY_CONTRACT`."""
    mod = load_file(pathlib.Path(root) / "bench" / "families"
                    / f"{family}.py", "bench_family")
    missing = [n for n in FAMILY_CONTRACT if not callable(
        getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"family {family!r} ({mod.__file__}) lacks "
                             f"{missing}")
    return mod
