"""Roofline over dry-run records: the port of ``repro.launch.roofline``.

Three terms per (arch x shape) cell, all PER DEVICE per step, from the op
count of the dry run's sharded step (``launch/dryrun.py``,
``launch/op_analysis.py``):

    compute    = dot_flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = collective_bytes / LINK_BW

plus MODEL_FLOPS (the 6·N·D / 2·N·D analytic "useful" flops), the
useful-compute ratio MODEL_FLOPS / counted FLOPs (catches remat, padding
and dispatch waste), and the roofline fraction = ideal time / dominant
term — the score a perfectly overlapped implementation would push to 1.

Hardware model: one NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
datasheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 900 GB/s
bidirectional (450 GB/s each way).  The reference's table is for its TPU
(``CHIPS = 256`` stays: the production mesh's device count).

The dry run's counts are one device's share of the sharded step and the
collectives it issues, and its memory the exact argument bytes; it has no
compiler's temporaries, so the peak column reads "—".  The dominant term
is the largest of the three.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline --dir artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM5 datasheet
HBM_BW = 3.35e12  # HBM3 bytes/s, H100 SXM5 datasheet
LINK_BW = 450e9  # NVLink 4 bytes/s per direction (900 GB/s bidirectional)
CHIPS = 256  # single-pod roofline table


@functools.cache
def count_params(arch: str) -> tuple[float, float]:
    """(total, active) parameter counts from fake tensors (no allocation)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.abstract import abstract_params, fake_mode

    cfg = get_config(arch)
    params = abstract_params(cfg, fake_mode())
    total = expert = 0
    for name, leaf in params.named_parameters():
        n = leaf.numel()
        total += n
        keys = name.split(".")
        if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down"):
            expert += n
    active = total - expert
    if cfg.moe and cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return float(total), float(active)


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful flops per device per step (6ND train / 2ND fwd)."""
    from repro_torch.configs import SHAPES

    sh = SHAPES[shape_name]
    total, active = count_params(arch)
    if sh.kind == "train":
        tokens = sh.seq_len * sh.global_batch
        return 6.0 * active * tokens / CHIPS
    if sh.kind == "prefill":
        tokens = sh.seq_len * sh.global_batch
        return 2.0 * active * tokens / CHIPS
    # decode: one token per sequence
    return 2.0 * active * sh.global_batch / CHIPS


def decode_native_floor_gib(arch: str, shape_name: str) -> float | None:
    """Analytic bf16-native per-device residency for decode cells:
    TP-resident params + sharded KV cache."""
    from repro_torch.configs import SHAPES, decode_cache_size, get_config
    from repro_torch.launch.abstract import abstract_cache, fake_mode

    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    if sh.kind != "decode":
        return None
    total, _ = count_params(arch)
    params_gib = total * 2 / 16 / 2**30  # bf16, TP=16
    cache = abstract_cache(cfg, sh.global_batch, decode_cache_size(cfg, sh),
                           fake_mode())
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    shards = 16 * (16 if sh.global_batch % 16 == 0 else 1)
    return params_gib + cache_bytes / shards / 2**30


def build_table(art_dir: str, mesh: str = "pod16x16") -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(art_dir, f"*_{mesh}.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mesh") != mesh:
            continue
        row = {"arch": r["arch"], "shape": r["shape"], "status": r["status"]}
        if r["status"] == "skipped":
            row["note"] = r["reason"].split(":")[0]
            rows.append(row)
            continue
        if r["status"] != "ok":
            row["note"] = r.get("error", "")[:80]
            rows.append(row)
            continue
        h = r["hlo"]
        ct = h["dot_flops"] / PEAK_FLOPS
        mt = h["hbm_bytes"] / HBM_BW
        coll = h["collective_bytes_total"]
        lt = None if coll is None else coll / LINK_BW
        dom = max((kv for kv in (("compute", ct), ("memory", mt),
                                 ("collective", lt)) if kv[1] is not None),
                  key=lambda kv: kv[1])
        mf = model_flops(r["arch"], r["shape"])
        ideal = mf / PEAK_FLOPS
        peak = r["memory"]["peak_bytes_est"]
        row.update(
            compute_s=ct, memory_s=mt, collective_s=lt,
            dominant=dom[0], dominant_s=dom[1],
            model_flops=mf,
            useful_ratio=mf / h["dot_flops"] if h["dot_flops"] else 0.0,
            roofline_fraction=ideal / dom[1] if dom[1] else 0.0,
            argument_gib=r["memory"]["argument_bytes"] / 2**30,
            peak_gib=None if peak is None else peak / 2**30,
            native_floor_gib=decode_native_floor_gib(r["arch"], r["shape"]),
        )
        rows.append(row)
    return rows


def _num(x, fmt):
    return "—" if x is None else format(x, fmt)


def render_markdown(rows: list[dict]) -> str:
    out = [
        "| arch | shape | compute s | memory s | coll s | dominant | useful ratio | roofline frac | argument GiB (native est.) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | {r['status']} "
                f"| — | — | {r.get('note', '')} |")
            continue
        nf = r.get("native_floor_gib")
        mem = f"{r['argument_gib']:.2f}" + (f" ({nf:.2f})" if nf else "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {_num(r['collective_s'], '.4f')} | "
            f"{r['dominant']} | {r['useful_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} | {mem} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    rows = build_table(args.dir, args.mesh)
    print(render_markdown(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
