"""The port's launch tools against the JAX package: the roofline's analytic
counts, the dry run's per-device argument bytes, and the CLI.

- ``roofline.count_params`` (total and active), ``model_flops`` and
  ``decode_native_floor_gib`` equal the reference's exactly, for all ten
  archs and every shape (the port's from fake tensors, the reference's
  from ``jax.eval_shape``).
- ``dryrun.argument_bytes`` on ``make_smoke_mesh((2, 4))``: reduced
  olmo-1b's and mixtral-8x7b's train, prefill and decode cells (B=4,
  S=64) equal XLA's ``compiled.memory_analysis().argument_size_in_bytes``
  of the reference's sharded step, compiled in ONE subprocess with 8
  forced host devices.  (XLA counts less where ``jax.jit`` drops an
  argument the step never reads — ``keep_unused=False``: whisper's decode
  reads no encoder weight, mamba2's no ``len`` — so those cells are not
  held here.)
- The CLI writes one record per cell (``ok`` with one device's count of
  the sharded step and its collectives, or ``skipped``), and ``roofline``
  renders them.
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCH_IDS
from repro.launch import roofline as jroof
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.abstract import fake_mode
from repro_torch.launch.mesh import make_smoke_mesh

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE_ARCHS = ["olmo-1b", "mixtral-8x7b"]
CELLS = ["train_4k", "prefill_32k", "decode_32k"]

_REF_PROG = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
from repro.configs import get_config, reduced, SHAPES
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_smoke_mesh, mesh_context
from repro.models import build_model

out = {}
mesh = make_smoke_mesh((2, 4), ("data", "model"))
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    for name in CELLS:
        sh = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=4)
        with mesh_context(mesh):
            compiled = lower_cell(cfg, model, sh, mesh).compile()
        out[f"{arch}/{name}"] = compiled.memory_analysis().argument_size_in_bytes
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def xla_arguments(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_reference") / "ref.json"
    prog = f"ARCHS = {SMOKE_ARCHS!r}\nCELLS = {CELLS!r}\n" + _REF_PROG
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", prog, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def reference_counts():
    """The reference's roofline functions, its parameter count cached per
    arch (a pure function of the arch; it is re-derived per call)."""
    counts = functools.cache(jroof.count_params)
    mp = pytest.MonkeyPatch()
    mp.setattr(jroof, "count_params", counts)
    yield jroof
    mp.undo()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_counts_equal_the_reference(reference_counts, arch):
    assert roofline.count_params(arch) == reference_counts.count_params(arch)
    total, active = roofline.count_params(arch)
    assert total >= active > 0
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == \
            reference_counts.model_flops(arch, shape)
        assert roofline.decode_native_floor_gib(arch, shape) == \
            reference_counts.decode_native_floor_gib(arch, shape)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_argument_bytes_equal_xla_on_the_smoke_mesh(xla_arguments, arch,
                                                    cell):
    cfg = reduced(get_config(arch))
    sh = dataclasses.replace(SHAPES[cell], seq_len=64, global_batch=4)
    got = dryrun.argument_bytes(cfg, sh, make_smoke_mesh((2, 4)),
                                dryrun.cell_inputs(cfg, sh, fake_mode()))
    assert got["total"] == xla_arguments[f"{arch}/{cell}"], got
    assert ("opt_state" in got) == (sh.kind == "train")
    assert ("cache" in got) == (sh.kind == "decode")


def test_cli_writes_records_that_roofline_renders(tmp_path):
    dryrun.main(["--arch", "mamba2-780m", "--shapes", "decode_32k,long_500k",
                 "--out-dir", str(tmp_path)])
    dryrun.main(["--arch", "olmo-1b", "--shapes", "long_500k",
                 "--out-dir", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*.json"))}
    assert set(recs) == {"mamba2-780m_decode_32k_pod16x16.json",
                         "mamba2-780m_long_500k_pod16x16.json",
                         "olmo-1b_long_500k_pod16x16.json"}
    skipped = recs["olmo-1b_long_500k_pod16x16.json"]
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
    rec = recs["mamba2-780m_decode_32k_pod16x16.json"]
    assert rec["status"] == "ok", rec.get("traceback")
    h = rec["hlo"]
    assert h["split"] == "sharded" and h["devices"] == 256
    assert h["dot_flops"] > 0 and h["hbm_bytes"] > 0
    assert h["collective_bytes_total"] == sum(
        h["collective_bytes"].values()) > 0
    assert set(h["collective_counts"]) == set(h["collective_bytes"])
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["argument_bytes"] == \
        rec["memory"]["arguments"]["total"] > 0
    rows = roofline.build_table(str(tmp_path))
    assert [r["status"] for r in rows] == ["ok", "ok", "skipped"]
    ok = rows[0]
    assert ok["collective_s"] == h["collective_bytes_total"] / roofline.LINK_BW
    assert ok["memory_s"] == h["hbm_bytes"] / roofline.HBM_BW
    assert ok["dominant_s"] == max(ok["compute_s"], ok["memory_s"],
                                   ok["collective_s"])
    assert ok["native_floor_gib"] == roofline.decode_native_floor_gib(
        "mamba2-780m", "decode_32k")
    md = roofline.render_markdown(rows)
    assert md.count("\n") == len(rows) + 1 and "| mamba2-780m | decode_32k" in md
    # an existing record is kept
    dryrun.main(["--arch", "olmo-1b", "--shapes", "long_500k",
                 "--out-dir", str(tmp_path)])
    assert len(list(tmp_path.glob("*.json"))) == 3
