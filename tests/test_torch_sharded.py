"""The sharded step (``launch/steps.py::sharded``) on a (data=2, model=4)
mesh of 8 gloo ranks on the CPU, against the port's unsharded step and
the JAX package's sharded one.

- One world of 8 ranks (``tests/torch_world.py``) runs, for reduced
  olmo-1b, mixtral-8x7b and mamba2-780m in float32 from the reference's
  weights: the loss and every gradient (gathered), 3 ``make_train_step``
  steps, prefill (logits and the cache, placed by ``cache_specs``) and 4
  decode steps, each through ``sharded`` with ``step_specs``; rank 0 runs
  the same unsharded.  Each rank also places a bf16 train state of the
  olmo-1b and mixtral-8x7b train cells (B=4, S=64) and reports the bytes
  it holds.
- The reference's numbers come from one subprocess with 8 forced host
  devices: ``jax.jit`` with the same specs on its (2, 4) smoke mesh.
- Tolerance 1e-4 abs + 1e-4 rel (the training tests' own) on every
  number; the observed maxima are printed (``-s``).  The bytes each rank
  holds equal ``dryrun.argument_bytes`` exactly, which
  ``tests/test_torch_dryrun.py`` holds equal to XLA's.
- The same world runs all ten reduced configs with ``fsdp=True`` and
  ``remat="full"`` (parameters over 'data', gathered inside each
  recomputed layer): the loss and every gradient against the unsharded
  port's.
- The rules' placements and the annotations without a mesh need no world.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget, reduced as jreduced
from repro.models import build_model as jbuild
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.abstract import fake_mode
from repro_torch.launch.mesh import AbstractMesh, make_smoke_mesh
from repro_torch.sharding import rules
from torch_world import REPO, run_world

torch.set_num_threads(1)

ARCHS = ["olmo-1b", "mixtral-8x7b", "mamba2-780m"]
BYTES_ARCHS = ["olmo-1b", "mixtral-8x7b"]
B, S, CACHE, DECODE = 4, 32, 40, 4
TOL = dict(atol=1e-4, rtol=1e-4)

_PORT = r"""
import pickle
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_from_jax
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, place_tree, sharded,
                                      step_specs)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import rules

mesh = make_device_mesh((2, 4), device_type="cpu")
inp = pickle.load(open(f"{WORK}/inputs.pkl", "rb"))
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)


def host(t):
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy().copy()


def cases(cfg, d, mesh):
    model = build_model(cfg)
    out = {}

    def fresh(grad=False):
        return model_from_jax(cfg, d["params"], dtype=torch.float32,
                              device="cpu").requires_grad_(grad)

    batch = {"tokens": torch.from_numpy(d["tokens"])}

    def loss_grads(params, batch):
        loss, _ = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
        return loss.detach(), dict(zip(names, g))

    params, f = fresh(True), loss_grads
    if mesh is not None:
        ins, _ = step_specs(cfg, "train", mesh, params, batch)
        f = sharded(loss_grads, mesh, (ins[0], ins[2]), (None, None))
    loss, grads = f(params, batch)
    out["loss"] = host(loss)
    out["grads"] = {n: host(g) for n, g in grads.items()}

    params = fresh(True)
    opt = adamw_init(params)
    step = make_train_step(model, OPT)
    if mesh is not None:
        step = sharded(step, mesh, *step_specs(cfg, "train", mesh, params,
                                               batch))
    out["train_losses"] = []
    for b in d["batches"]:
        params, opt, met = step(params, opt, {"tokens": torch.from_numpy(b)})
        out["train_losses"].append(host(met["loss"]))
    out["train_params"] = {n: host(p) for n, p in params.named_parameters()}

    params = fresh()
    step = make_prefill_step(model, CACHE)
    if mesh is not None:
        ins, outs = step_specs(cfg, "prefill", mesh, params, batch, CACHE)
        step = sharded(step, mesh, ins, outs)
        want = rules.to_placed(outs[0], mesh)
    with torch.no_grad():
        cache, logits = step(params, batch)
    out["prefill_logits"] = host(logits)
    out["cache"] = {k: host(v) for k, v in cache.items()}
    if mesh is not None:
        out["cache_placed"] = all(
            tuple(v.placements) == want[k].placements
            for k, v in cache.items())

    step = make_decode_step(model)
    pos = lambda i: torch.full((B,), S + i, dtype=torch.int32)
    if mesh is not None:
        db = {"token": torch.from_numpy(d["decode"][0]), "pos": pos(0)}
        step = sharded(step, mesh, *step_specs(cfg, "decode", mesh, params,
                                               db, CACHE))
    out["decode_logits"] = []
    for i, tok in enumerate(d["decode"]):
        with torch.no_grad():
            lg, cache = step(params, cache, {"token": torch.from_numpy(tok),
                                             "pos": pos(i)})
        out["decode_logits"].append(host(lg))
    return out


def held_bytes(arch):
    cfg = reduced(get_config(arch))
    params = build_model(cfg).init(0, torch.bfloat16, "cpu")
    state = (params, adamw_init(params),
             {"tokens": torch.zeros((4, 64), dtype=torch.int32)})
    ins, _ = step_specs(cfg, "train", mesh, params, state[2])
    placed = [place_tree(a, s, mesh) for a, s in zip(state, ins)]
    leaves = list(placed[0].parameters()) + list(placed[1]["m"].values()) \
        + list(placed[1]["v"].values()) + [placed[1]["step"]] \
        + list(placed[2].values())
    return sum(t.to_local().numel() * t.element_size() for t in leaves)


def family(arch):
    # loss and every gradient of arch reduced with FSDP and full remat,
    # sharded and not, from one seeded init and batch
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config(arch)), fsdp=True,
                              remat="full")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(4, cfg.encoder_seq, cfg.d_model,
                                      generator=g)
    if cfg.prefix_tokens:
        batch["patches"] = torch.randn(4, cfg.prefix_tokens, cfg.d_model,
                                       generator=g)

    def loss_grads(params, batch):
        loss, _ = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
        return loss.detach(), dict(zip(names, g))

    out = {}
    for tag, mesh_ in (("sharded", mesh), ("plain", None)):
        params = model.init(0, torch.float32, "cpu").requires_grad_(True)
        f = loss_grads
        if mesh_ is not None:
            ins, _ = step_specs(cfg, "train", mesh_, params, batch)
            f = sharded(loss_grads, mesh_, (ins[0], ins[2]), (None, None))
        loss, grads = f(params, batch)
        out[tag] = (host(loss), {n: host(t) for n, t in grads.items()})
    return out


res = {"sharded": {}, "plain": {}}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    res["sharded"][arch] = cases(cfg, inp[arch], mesh)
res["family"] = {arch: family(arch) for arch in FAMILY}
if RANK == 0:
    for arch in ARCHS:
        res["plain"][arch] = cases(reduced(get_config(arch)), inp[arch], None)
    pickle.dump(res, open(f"{WORK}/port.pkl", "wb"))
print(json.dumps({a: held_bytes(a) for a in BYTES_ARCHS}))
"""

_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.launch.mesh import make_smoke_mesh, mesh_context
from repro.launch.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
from repro.models import build_model
from repro.optim import AdamWConfig, adamw_init
from repro.sharding import rules

work = sys.argv[1]
inp = pickle.load(open(f"{work}/inputs.pkl", "rb"))
mesh = make_smoke_mesh((2, 4), ("data", "model"))
named = lambda t: rules.to_named(t, mesh)
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    d = inp[arch]
    params = jax.tree.map(jnp.asarray, d["params"])
    batch = {"tokens": jnp.asarray(d["tokens"])}
    r = {}
    with mesh_context(mesh):
        ps = named(rules.param_specs(cfg, params, mesh))
        bs = named(rules.batch_specs(cfg, batch, mesh))
        vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]),
                     in_shardings=(ps, bs))
        loss, grads = vg(params, batch)
        r["loss"], r["grads"] = f32(loss), f32(grads)
        opt = adamw_init(params)
        os_ = named(rules.opt_specs(cfg, params, mesh))
        step = jax.jit(make_train_step(model, AdamWConfig(
            lr=1e-2, warmup_steps=2, total_steps=10)),
            in_shardings=(ps, os_, bs), out_shardings=(ps, os_, None))
        p, o = jax.device_put(params, ps), jax.device_put(opt, os_)
        r["train_losses"] = []
        for b in d["batches"]:
            p, o, m = step(p, o, {"tokens": jnp.asarray(b)})
            r["train_losses"].append(float(m["loss"]))
        r["train_params"] = f32(p)
        pre = jax.jit(make_prefill_step(model, CACHE), in_shardings=(ps, bs))
        cache, logits = pre(params, batch)
        r["prefill_logits"], r["cache"] = f32(logits), f32(cache)
        sps = named(rules.param_specs(cfg, params, mesh, serving=True))
        cs = named(rules.cache_specs(cfg, cache, mesh))
        cache = jax.device_put(cache, cs)
        db = lambda i: {"token": jnp.asarray(d["decode"][i]),
                        "pos": jnp.full((B,), S + i, jnp.int32)}
        dbs = named(rules.batch_specs(cfg, db(0), mesh))
        dec = jax.jit(make_decode_step(model), in_shardings=(sps, cs, dbs),
                      out_shardings=(None, cs))
        r["decode_logits"] = []
        for i in range(len(d["decode"])):
            lg, cache = dec(params, cache, jax.device_put(db(i), dbs))
            r["decode_logits"].append(f32(lg))
    out[arch] = r
pickle.dump(out, open(f"{work}/jax.pkl", "wb"))
"""


def _inputs(path):
    """The reference's weights (bf16 init, cast to float32) and the
    batches, seeded, as numpy."""
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        cfg = jreduced(jget(arch))
        p = jbuild(cfg).init(jax.random.PRNGKey(0))
        tok = lambda *shape: rng.integers(0, cfg.vocab, shape).astype(np.int32)
        out[arch] = {
            "params": jax.tree.map(lambda a: np.asarray(
                a.astype(jnp.float32)), p),
            "tokens": tok(B, S),
            "batches": [tok(B, S) for _ in range(3)],
            "decode": [tok(B) for _ in range(DECODE)],
        }
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port sharded, port unsharded, reference sharded, bytes per rank):
    the reference's subprocess and the port's world run at once."""
    work = tmp_path_factory.mktemp("sharded")
    _inputs(work / "inputs.pkl")
    consts = f"ARCHS = {ARCHS!r}\nB, S, CACHE = {B}, {S}, {CACHE}\n"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ref = subprocess.Popen([sys.executable, "-c", consts + _JAX, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=REPO)
    try:
        ranks = run_world(consts + f"BYTES_ARCHS = {BYTES_ARCHS!r}\n"
                          f"FAMILY = {ARCH_IDS!r}\n" + _PORT, work)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    port = pickle.load(open(work / "port.pkl", "rb"))
    jref = pickle.load(open(work / "jax.pkl", "rb"))
    return port["sharded"], port["plain"], jref, ranks, port["family"]


def _jax_named(cfg, tree):
    from repro_torch.convert import named_from_jax
    return {n: t.numpy() for n, t in named_from_jax(cfg, tree,
                                                    device="cpu").items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want)),
                       initial=0.0))
    print(f"{what}: max abs diff {err:.3g}")


def _both(runs, arch, get, what):
    """The sharded value against the unsharded port's and the
    reference's."""
    sh, plain, jref = runs[:3]
    _close(get(sh[arch], "port"), get(plain[arch], "port"),
           f"{arch} {what} sharded vs unsharded")
    _close(get(sh[arch], "port"), get(jref[arch], "jax"),
           f"{arch} {what} sharded vs reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(runs, arch):
    _both(runs, arch, lambda r, _: r["loss"], "loss")
    cfg = reduced(get_config(arch))
    sh, plain, jref = runs[:3]
    jg = _jax_named(cfg, jref[arch]["grads"])
    assert set(sh[arch]["grads"]) == set(jg)
    for n, g in sh[arch]["grads"].items():
        _close(g, plain[arch]["grads"][n], f"{arch} grad {n} vs unsharded")
        _close(g, jg[n], f"{arch} grad {n} vs reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps(runs, arch):
    _both(runs, arch, lambda r, _: np.asarray(r["train_losses"]), "losses")
    cfg = reduced(get_config(arch))
    sh, plain, jref = runs[:3]
    jp = _jax_named(cfg, jref[arch]["train_params"])
    for n, p in sh[arch]["train_params"].items():
        _close(p, plain[arch]["train_params"][n], f"{arch} {n} vs unsharded")
        _close(p, jp[n], f"{arch} {n} vs reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill(runs, arch):
    _both(runs, arch, lambda r, _: r["prefill_logits"], "prefill logits")
    sh, plain, jref = runs[:3]
    assert sh[arch]["cache_placed"]
    assert set(sh[arch]["cache"]) == set(jref[arch]["cache"])
    for k, v in sh[arch]["cache"].items():
        _close(v, plain[arch]["cache"][k], f"{arch} cache {k} vs unsharded")
        _close(v, jref[arch]["cache"][k], f"{arch} cache {k} vs reference")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode(runs, arch):
    for i in range(DECODE):
        _both(runs, arch, lambda r, _: r["decode_logits"][i],
              f"decode {i} logits")


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_bytes_each_rank_holds(runs, arch):
    cfg = reduced(get_config(arch))
    sh = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
    want = dryrun.argument_bytes(cfg, sh, make_smoke_mesh((2, 4)),
                                 dryrun.cell_inputs(cfg, sh, fake_mode()))
    assert [r[arch] for r in runs[3]] == [want["total"]] * 8


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_with_fsdp_and_remat(runs, arch):
    """All ten reduced configs with ``fsdp=True`` and ``remat="full"``:
    the sharded loss and every gradient against the unsharded port's."""
    got, want = runs[4][arch]["sharded"], runs[4][arch]["plain"]
    _close(got[0], want[0], f"{arch} loss sharded vs unsharded")
    assert set(got[1]) == set(want[1])
    for n, g in got[1].items():
        _close(g, want[1][n], f"{arch} grad {n} sharded vs unsharded")


class _Mesh:
    """Dim names are all :func:`rules.placements` reads."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_follow_the_spec():
    m = _Mesh("pod", "data", "model")
    assert rules.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements((None, None), m) == (Replicate(),) * 3
    assert rules.placements(("model", None), m, partial=("data",)) == (
        Replicate(), Partial(), Shard(0))
    with pytest.raises(ValueError, match="order"):
        rules.placements((("data", "pod"),), m)


def test_layer_spec_moves_the_zero_axes():
    mesh = AbstractMesh({"data": 2, "model": 4})
    # the data axes on the layer axis move to the largest dim they divide
    assert rules.layer_spec((("data",), None, "model"), (64, 128), mesh) == (
        ("data",), "model")
    assert rules.layer_spec((("data",), "model", None), (8, 6), mesh) == (
        "model", ("data",))
    # no dim they divide: replicated over them
    assert rules.layer_spec((("data",), None), (3,), mesh) == (None,)
    assert rules.layer_spec((None, "model"), (8,), mesh) == ("model",)


def test_annotations_are_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert rules.shard_seq(x) is x
    assert rules.shard_logits(x) is x
    assert rules.shard_experts(x) is x
    assert rules.constrain(x, "data", None, "model") is x
