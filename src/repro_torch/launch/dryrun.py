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
- ``hlo``: ``launch/op_analysis.py``'s count of the port's own step
  (``launch/steps.py``) run once on fake tensors at the cell's GLOBAL
  shapes, divided by the mesh's device count (``split: "ideal"``: what
  each device would do if the work split evenly), beside the whole step's
  count; ``collective_bytes_total`` is ``None``: the port has no sharded
  step yet, so no collective is counted.

``launch/roofline.py`` reads these records.  Nothing here touches a
device: the production mesh is an abstract ``{axis: size}``
(``launch/mesh.py``).  ``--save-hlo`` has no counterpart (there is no
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
                                         abstract_params, fake_mode)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
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


def step_cost(cfg, shape, inputs, mode, grad_compression="none") -> dict:
    """``op_analysis.analyze`` of the cell's step, once, on ``inputs`` (one
    device's view of the whole global step)."""
    model = build_model(cfg)
    params, opt, batch, cache = inputs
    with mode:
        if shape.kind == "train":
            params.requires_grad_(True)
            step = make_train_step(model, AdamWConfig(),
                                   grad_compression=grad_compression)
            return analyze(step, params, opt, batch)
        with torch.no_grad():
            if shape.kind == "prefill":
                return analyze(make_prefill_step(model, shape.seq_len),
                               params, batch)
            return analyze(make_decode_step(model), params, cache, batch)


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
        mode = fake_mode()
        inputs = cell_inputs(cfg, shape, mode)
        args = argument_bytes(cfg, shape, mesh, inputs)
        cost = step_cost(cfg, shape, inputs, mode, grad_compression)
        n = mesh.size
        rec.update(
            status="ok",
            count_seconds=round(time.time() - t0, 2),
            memory=dict(argument_bytes=args["total"], arguments=args,
                        output_bytes=None, temp_bytes=None, alias_bytes=None,
                        peak_bytes_est=None),
            hlo=dict(dot_flops=cost["dot_flops"] / n,
                     hbm_bytes=cost["hbm_bytes"] / n,
                     collective_bytes=None, collective_bytes_total=None,
                     collective_counts=None, split="ideal", devices=n,
                     step_dot_flops=cost["dot_flops"],
                     step_hbm_bytes=cost["hbm_bytes"],
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
                         f"dotTFLOP={rec['hlo']['dot_flops'] / 1e12:.3f}/dev")
            elif status == "error":
                extra = rec["error"][:200]
            else:
                extra = rec["reason"][:80]
            print(f"[dryrun] {tag}: {status} {extra}", flush=True)


if __name__ == "__main__":
    main()
