"""Multi-pod dry run: every (arch x shape) cell on the production mesh,
without a device.  The port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's sharded step for 256 (or
512) placeholder devices and records XLA's memory analysis and a
trip-count-corrected count of the partitioned HLO.  The port compiles
nothing and has no partitioner, so for each cell :func:`run_cell` writes
the reference's record with these numbers:

- ``memory.argument_bytes``: the exact bytes one device holds of the
  step's arguments — parameters (``param_specs``; serving specs for
  decode, as the reference passes), AdamW state (``opt_specs``, train),
  the batch (``batch_specs``) and the decode cache (``cache_specs``) —
  under ``sharding/rules.py``; ``output_bytes``, ``temp_bytes``,
  ``alias_bytes`` and ``peak_bytes_est`` are ``None``: no compiler
  assigns buffers;
- ``hlo``: ``launch/op_analysis.py``'s count of one device's share of
  the port's sharded step (``launch/steps.py::sharded`` with
  ``step_specs``, the specs ``lower_cell`` passes) run once on fake
  tensors (``split: "sharded"``): its dot FLOPs and bytes, and the
  collectives it issues — ``collective_bytes`` by kind, their total and
  their counts (a reduce-scatter's bytes times the mesh's 'model' size, as
  the reference passes ``n_shards_hint``).

The mesh is a ``DeviceMesh`` of the production shape over a fake process
group of its size (``launch/abstract.py::fake_world``; this process is
rank 0): nothing touches a device.  The collectives are DTensor's: on a
CPU mesh DTensor gathers where a CUDA mesh would exchange all-to-all, so
such a move counts as an all-gather of the whole.  ``launch/roofline.py``
reads these records.  ``--save-hlo`` has no counterpart (there is no
HLO).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --shapes train_4k --out-dir artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_supported,
                                 decode_cache_size, get_config, input_specs)
from repro_torch.launch.abstract import (abstract_cache, abstract_opt_state,
                                         abstract_params, fake_mode,
                                         fake_world)
from repro_torch.launch.mesh import make_device_mesh, make_production_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, place_tree, sharded,
                                      step_specs)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import rules


def _itemsizes(tree):
    """Element sizes in :func:`rules.shape_tree`'s stacked layout."""
    tree = tree.tree() if hasattr(tree, "tree") else tree
    if isinstance(tree, dict):
        return {k: _itemsizes(v[0] if isinstance(v, list) else v)
                for k, v in tree.items()}
    return tree.element_size()


def _tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` (fake or real tensors) under ``specs``."""
    shapes, sizes = rules.shape_tree(tree), _itemsizes(tree)

    def walk(sh, sz, sp):
        if isinstance(sh, dict):
            return sum(walk(sh[k], sz[k], sp[k]) for k in sh)
        return rules.shard_bytes(sh, sz, sp, mesh)
    return walk(shapes, sizes, specs)


def cell_inputs(cfg, shape, mode):
    """The step's arguments of one cell as fake tensors under ``mode``:
    (params, opt_state or None, batch, cache or None)."""
    params = abstract_params(cfg, mode)
    batch = input_specs(cfg, shape, mode)
    opt = cache = None
    if shape.kind == "train":
        opt = abstract_opt_state(params, mode)
    elif shape.kind == "decode":
        cache = abstract_cache(cfg, shape.global_batch,
                               decode_cache_size(cfg, shape), mode)
    return params, opt, batch, cache


def argument_bytes(cfg, shape, mesh, inputs) -> dict:
    """Per-device bytes of each argument of the cell's step under the
    sharding rules, and their ``total``."""
    params, opt, batch, cache = inputs
    out = {"params": _tree_bytes(params, rules.param_specs(
        cfg, params, mesh, serving=(shape.kind == "decode")), mesh),
        "batch": _tree_bytes(batch, rules.batch_specs(cfg, batch, mesh),
                             mesh)}
    if opt is not None:
        ospecs = rules.opt_specs(cfg, params, mesh)
        out["opt_state"] = sum(
            _tree_bytes(_moments_tree(params, opt[k]), ospecs[k], mesh)
            for k in ("m", "v")) + opt["step"].element_size()
    if cache is not None:
        out["cache"] = _tree_bytes(cache, rules.cache_specs(cfg, cache, mesh),
                                   mesh)
    out["total"] = sum(out.values())
    return out


def _moments_tree(params, moments: dict):
    """AdamW moments (by parameter name) in the parameters' nested layout."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(t)]
        return moments[prefix[:-1]]
    return walk(params.tree(), "")


def step_cost(cfg, shape, inputs, mode, mesh,
              grad_compression="none") -> dict:
    """``op_analysis.analyze`` of the cell's step, once, on ``inputs``:
    one device's share of the step sharded over ``mesh`` (a
    ``DeviceMesh``)."""
    model = build_model(cfg)
    params, opt, batch, cache = inputs
    kind = shape.kind
    if kind == "train":
        step = make_train_step(model, AdamWConfig(),
                               grad_compression=grad_compression)
        args = (params, opt, batch)
    elif kind == "prefill":
        step, args = make_prefill_step(model, shape.seq_len), (params, batch)
    else:
        step, args = make_decode_step(model), (params, cache, batch)
    with mode:
        params.requires_grad_(kind == "train")
        ins, outs = step_specs(
            cfg, kind, mesh, params, batch,
            None if kind == "train" else
            shape.seq_len if kind == "prefill" else cache_size_of(cache))
        args = tuple(place_tree(a, s, mesh) for a, s in zip(args, ins))
        with torch.set_grad_enabled(kind == "train"):
            return analyze(sharded(step, mesh, ins, outs), *args,
                           n_shards_hint=mesh.size(
                               mesh.mesh_dim_names.index("model")))


def cache_size_of(cache) -> int:
    """The slot count of a decode cache (its K/V's third axis; 0 for a
    state-only cache)."""
    k = cache.get("k")
    return 0 if k is None else k.shape[2]


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             grad_compression: str = "none") -> dict:
    """The record of one (arch, shape) cell (module docstring)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "grad_compression": grad_compression}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        mode = fake_mode(allow_non_fake_inputs=True)
        inputs = cell_inputs(cfg, shape, mode)
        args = argument_bytes(cfg, shape, mesh, inputs)
        with fake_world(mesh.size):
            dmesh = make_device_mesh(tuple(mesh.shape.values()),
                                     mesh.axis_names, device_type="cpu")
            cost = step_cost(cfg, shape, inputs, mode, dmesh,
                             grad_compression)
        rec.update(
            status="ok",
            count_seconds=round(time.time() - t0, 2),
            memory=dict(argument_bytes=args["total"], arguments=args,
                        output_bytes=None, temp_bytes=None, alias_bytes=None,
                        peak_bytes_est=None),
            hlo=dict(dot_flops=cost["dot_flops"],
                     hbm_bytes=cost["hbm_bytes"],
                     collective_bytes=cost["collective_bytes"],
                     collective_bytes_total=cost["collective_bytes_total"],
                     collective_counts=cost["collective_counts"],
                     split="sharded", devices=mesh.size,
                     n_ops=cost["n_ops"]),
        )
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=repr(e),
                   traceback=traceback.format_exc())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run: count "
                                 "every (arch x shape) on the production mesh")
    ap.add_argument("--arch", default="all", help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shapes", default="all",
                    help=f"comma list of {list(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16"])
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    os.makedirs(args.out_dir, exist_ok=True)

    for arch in archs:
        for shape_name in shapes:
            mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
            tag = f"{arch}_{shape_name}_{mesh_name}"
            if args.grad_compression != "none":
                tag += f"_gc{args.grad_compression}"
            path = os.path.join(args.out_dir, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] {tag}: exists, skipping")
                continue
            print(f"[dryrun] {tag}: counting...", flush=True)
            rec = run_cell(arch, shape_name, args.multi_pod, args.out_dir,
                           grad_compression=args.grad_compression)
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            status = rec["status"]
            if status == "ok":
                extra = (f"count={rec['count_seconds']}s "
                         f"args={rec['memory']['argument_bytes'] / 2**30:.2f}"
                         f"GiB/dev "
                         f"dotTFLOP={rec['hlo']['dot_flops'] / 1e12:.3f}/dev "
                         f"coll={rec['hlo']['collective_bytes_total'] / 2**30:.3f}"
                         f"GiB/dev")
            elif status == "error":
                extra = rec["error"][:200]
            else:
                extra = rec["reason"][:80]
            print(f"[dryrun] {tag}: {status} {extra}", flush=True)


if __name__ == "__main__":
    main()
