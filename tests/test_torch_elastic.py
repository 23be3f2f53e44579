"""Elastic scaling in the port: a checkpoint moves across mesh topologies,
the counterpart of ``tests/test_elastic.py``.

One world of 8 gloo ranks (``tests/torch_world.py``) places reduced
olmo-1b's float32 train state (parameters by ``param_specs``, AdamW by
``opt_specs``) on a (data=2, model=4) mesh, saves it sharded at step 7,
then restores it onto a (data=4, model=2) mesh with ``shardings=`` — the
cluster resized — and runs the loss there.  Held: the step, every leaf
bitwise equal (gathered), the restored leaves' placements, the loss
within 1e-5 (the reference holds 1e-2; the gap is printed with ``-s``),
and that the sharded save wrote one checkpoint whose files are those a
plain save of the gathered tree writes (the reference's format), also
when it is asynchronous and the ranks run collectives before its wait,
and that only rank 0, the writer, copied the gathered tree to the host.
"""

import pytest
import torch

from torch_world import run_world

torch.set_num_threads(1)

_PROG = r"""
import filecmp, os
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import place_tree, sharded, step_specs
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.sharding import rules

cfg = reduced(get_config("olmo-1b"))
model = build_model(cfg)
mesh_a = make_device_mesh((2, 4), device_type="cpu")
mesh_b = make_device_mesh((4, 2), device_type="cpu")
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g,
                                 dtype=torch.int32)}


def leaves(params, opt):
    return ([p for _, p in params.named_parameters()]
            + list(opt["m"].values()) + list(opt["v"].values())
            + [opt["step"]])


def loss(params, batch):
    return model.loss(params, batch)[0].detach()


params = model.init(0, torch.float32, "cpu")
opt = adamw_init(params)
opt["step"] += 7
ins_a, _ = step_specs(cfg, "train", mesh_a, params, batch)
params = rules.distribute_params(cfg, params, mesh_a)
opt = place_tree(opt, ins_a[1], mesh_a)
loss_a = sharded(loss, mesh_a, (ins_a[0], ins_a[2]), None)(params, batch)
cm = CheckpointManager(f"{WORK}/sharded", keep_last=1)
cm.save(7, (params, opt), blocking=True)
snapshot_bytes = cm.last_save["bytes"]
whole_a = [x.full_tensor() for x in leaves(params, opt)]
# an asynchronous sharded save: the ranks run collectives meanwhile and
# meet at wait()
cm_async = CheckpointManager(f"{WORK}/async", keep_last=1)
cm_async.save(8, (params, opt))
loss_async = sharded(loss, mesh_a, (ins_a[0], ins_a[2]), None)(params, batch)
cm_async.wait()
if RANK == 0:  # the same values saved whole, as an unsharded run saves them
    plain = model.init(0, torch.float32, "cpu")
    names = [n for n, _ in plain.named_parameters()]
    with torch.no_grad():
        for p, w in zip(plain.parameters(), whole_a):
            p.copy_(w)
    n = len(names)
    popt = {"m": dict(zip(names, whole_a[n:2 * n])),
            "v": dict(zip(names, whole_a[2 * n:3 * n])),
            "step": whole_a[-1]}
    CheckpointManager(f"{WORK}/plain").save(7, (plain, popt), blocking=True)

# --- the cluster resized: a new topology ---
like = model.init(3, torch.float32, "cpu")
like_opt = adamw_init(like)
ins_b, _ = step_specs(cfg, "train", mesh_b, like, batch)
shardings = (rules.to_placed(ins_b[0], mesh_b), rules.to_placed(ins_b[1],
                                                                 mesh_b))
(params_b, opt_b), step, _ = cm.restore((like, like_opt), shardings=shardings)
loss_b = sharded(loss, mesh_b, (ins_b[0], ins_b[2]), None)(params_b, batch)
placed = all(
    isinstance(p, DTensor) and p.device_mesh == mesh_b
    and tuple(p.placements) == rules.placements(ins_b[0][n], mesh_b)
    for n, p in params_b.named_parameters()) and all(
    tuple(opt_b[k][n].placements) == rules.placements(ins_b[1][k][n], mesh_b)
    for k in ("m", "v") for n in opt_b[k])
whole_b = [x.full_tensor() for x in leaves(params_b, opt_b)]
same = len(whole_a) == len(whole_b) and all(
    a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(whole_a, whole_b))
files = None
if RANK == 0:
    a, b = f"{WORK}/sharded/step_00000007", f"{WORK}/plain/step_00000007"
    names = sorted(os.listdir(a))
    files = {"dirs": sorted(os.listdir(f"{WORK}/sharded")),
             "async": sorted(os.listdir(f"{WORK}/async")),
             "same_files": names == sorted(os.listdir(b)) and all(
                 filecmp.cmp(f"{a}/{n}", f"{b}/{n}", shallow=False)
                 for n in names)}
print(json.dumps({"step": step, "same": same, "placed": placed,
                  "loss_a": float(loss_a.to_local()),
                  "loss_b": float(loss_b.to_local()), "files": files,
                  "snapshot_bytes": snapshot_bytes,
                  "whole_bytes": sum(x.nbytes for x in whole_a)}))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(_PROG, tmp_path_factory.mktemp("elastic"))


def test_cross_mesh_restore(ranks):
    for r in ranks:
        assert r["step"] == 7
        assert r["same"]
        gap = abs(r["loss_a"] - r["loss_b"])
        assert gap < 1e-5, (r["loss_a"], r["loss_b"])
    print(f"loss on (2,4) {ranks[0]['loss_a']!r}, on (4,2) "
          f"{ranks[0]['loss_b']!r}, gap {gap!r}")


def test_restored_leaves_take_the_target_placements(ranks):
    assert all(r["placed"] for r in ranks)


def test_sharded_save_writes_one_checkpoint_in_the_plain_format(ranks):
    files = ranks[0]["files"]
    assert files["dirs"] == ["step_00000007"]
    assert files["async"] == ["step_00000008"]
    assert files["same_files"]
    assert all(r["files"] is None for r in ranks[1:])


def test_only_the_writing_rank_snapshots_to_the_host(ranks):
    assert ranks[0]["snapshot_bytes"] == ranks[0]["whole_bytes"] > 0
    assert all(r["snapshot_bytes"] == 0 for r in ranks[1:])
