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
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

from bench.spec import ModelSpec, load_spec


@dataclasses.dataclass
class Cell:
    name: str
    root: pathlib.Path
    chips: int
    config: str
    spec: ModelSpec
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
    mix = json.loads((root / "bench" / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    mix.update(own.get("traffic_params", {}))
    return Cell(
        name=name, root=root, chips=int(entry["chips"]),
        config=entry["config"], spec=load_spec(root / cfg["file"]),
        mix_name=entry["traffic"], mix=mix, engine=dict(own["engine"]),
        check=dict(own["check"]), profile_steps=int(own["profile_steps"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(root: pathlib.Path, metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    path = pathlib.Path(root) / "bench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
