"""The port's training path against the JAX package's, on the CPU.

- ``Model.loss`` and the gradient of every parameter against
  ``jax.value_and_grad(model.loss)`` on the first half of the zoo's
  reduced configs (the second half, and the ``remat`` cases:
  ``tests/test_torch_train_zoo.py``).  The reference's bf16 weights are
  cast to float32 on both sides, the port's through ``convert.py``, as
  ``tests/test_torch_models.py`` does.
  Tolerance 1e-5 abs + 1e-4 rel on the loss and 1e-4 abs/rel on each
  gradient: both are float32 and differ in summation order;
- the flash-attention backward (``layers._FlashCore``) against the
  reference's ``custom_vjp`` over ``tests/test_torch_flash.py``'s cases
  (the reference's five, ``q_offset`` and an odd chunk): 1e-4 abs/rel in
  float32, 2e-2 in bf16 (a gradient may round to a neighbouring bf16
  value); a row with every key masked gets zero gradients, not NaN;
- three ``make_train_step`` steps on reduced olmo-1b and olmoe-1b-7b (the
  capacity-bounded experts and the aux loss), with and without
  ``grad_compression="bf16"``, on the same pipeline batches, from one
  float32 state: each step's loss, ce, aux, grad norm and lr, then every
  parameter and moment, within 1e-4 abs/rel;
- ``launch/train.py::train`` with a simulated failure on ramp data, as
  ``tests/test_system.py`` runs the reference's: the loss falls by more
  than 0.5, and the resumed run ends bit for bit where an uninterrupted
  one does.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget, reduced as jreduced
from repro.data import DataConfig
from repro.data import TokenPipeline as JPipeline
from repro.launch.steps import make_train_step as jmake_step
from repro.models import build_model as jbuild
from repro.models import layers as jl
from repro.optim import AdamWConfig as JAdamW, adamw_init as jadamw_init
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import (model_from_jax, named_from_jax,
                                 opt_state_from_jax)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from test_torch_flash import CASES as FLASH_CASES, _qkv

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 24
#: the zoo split over this file and test_torch_train_zoo.py
ARCHS_HERE = ARCH_IDS[:5]


@functools.cache
def _setup(arch, remat=None):
    """(jax cfg, torch cfg, jax model, port model, jax float32 params)."""
    jc, tc = jreduced(jget(arch)), treduced(tget(arch))
    if remat:
        jc, tc = (dataclasses.replace(c, remat=remat) for c in (jc, tc))
    jm = jbuild(jc)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    return jc, tc, jm, build_model(tc), jp


def _module(tc, jp):
    """The reference's float32 tree as the port's module, gradients on."""
    m = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                       device="cpu")
    return m.requires_grad_(True)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S - cfg.prefix_tokens))
         .astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        b["patches"] = rng.standard_normal(
            (B, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def check_loss_and_grads(arch, remat=None):
    """Loss, metrics and every gradient leaf against the reference's
    ``value_and_grad``; returns the port's module."""
    jc, tc, jm, tm, jp = _setup(arch, remat)
    jb, tb = _batch(jc)
    (jloss, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    params = _module(tc, jp)
    loss, met = tm.loss(params, tb)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   **LOSS_TOL)
    want = named_from_jax(tc, jax.tree.map(np.asarray, jg), device="cpu")
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert g.shape == want[n].shape, n
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n,
                                   **TOL)
    assert any(float(g.abs().max()) > 0 for g in grads)
    return params


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def test_remat_is_off_without_grad(monkeypatch):
    """Inference under ``no_grad`` never checkpoints, whatever ``remat``."""
    monkeypatch.setattr(T, "checkpoint", None)  # would raise if called
    jc, tc, jm, tm, jp = _setup("olmo-1b", "full")
    with torch.no_grad():
        tm.loss(_module(tc, jp), _batch(jc)[1])


def _flash_grads(c, q, k, v, co, tdtype, jdtype):
    kw = dict(causal=c["causal"], chunk=c.get("chunk", 16),
              window=c["window"], prefix_len=c["prefix"],
              q_offset=c["S"] - q.shape[1])
    jf = lambda a: jnp.sum(jl.flash_attention(*a, **kw).astype(jnp.float32)
                           * jnp.asarray(co))
    jg = jax.grad(jf)(tuple(jnp.asarray(a, jdtype) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(tdtype).requires_grad_(True)
          for a in (q, k, v)]
    out = tl.flash_attention(*ts, **kw)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(co)).sum(), ts)
    return jg, tg


@pytest.mark.parametrize("c", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_grads_match_reference(c):
    q, k, v = _qkv(c, seed=len(str(c)))
    co = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    jg, tg = _flash_grads(c, q, k, v, co, torch.float32, jnp.float32)
    for j, t, nm in zip(jg, tg, "qkv"):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=nm, **TOL)


def test_flash_grads_bf16_match_reference():
    c = FLASH_CASES[0]
    q, k, v = _qkv(c, seed=7)
    co = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    jg, tg = _flash_grads(c, q, k, v, co, torch.bfloat16, jnp.bfloat16)
    for j, t, nm in zip(jg, tg, "qkv"):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2, err_msg=nm)


def test_flash_fully_masked_rows_get_zero_grads():
    c = dict(FLASH_CASES[0], window=0)
    q, k, v = _qkv(c, seed=3)
    co = np.ones(q.shape, np.float32)
    jg, tg = _flash_grads(c, q, k, v, co, torch.float32, jnp.float32)
    for j, t in zip(jg, tg):
        assert np.all(np.asarray(j) == 0) and torch.all(t == 0)


@pytest.mark.parametrize("compression", ["none", "bf16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_train_steps_match_reference(arch, compression):
    """Three steps of each package's ``make_train_step`` from one float32
    state on the same ramp-pipeline batches."""
    jc, tc, jm, tm, jp = _setup(arch)
    jcfg, tcfg = (cls(lr=1e-2, warmup_steps=2, total_steps=10)
                  for cls in (JAdamW, AdamWConfig))
    jstep = jax.jit(jmake_step(jm, jcfg, grad_compression=compression))
    tstep = make_train_step(tm, tcfg, grad_compression=compression)
    jstate = jadamw_init(jp)
    params = _module(tc, jp)
    tstate = opt_state_from_jax(tc, jax.tree.map(np.asarray, jstate),
                                device="cpu")
    pipe = JPipeline(DataConfig(vocab=jc.vocab, seq_len=S, global_batch=B,
                                source="ramp"))
    for i in range(3):
        host = pipe.next()
        jp, jstate, jmet = jstep(jp, jstate, {"tokens": jnp.asarray(
            host["tokens"])})
        params, tstate, tmet = tstep(params, tstate, {
            "tokens": torch.from_numpy(host["tokens"])})
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       err_msg=f"step {i}: {k}", **LOSS_TOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    if tc.moe:  # the aux loss is live (and held above)
        assert float(tmet["aux"]) > 0
    want = {"params": named_from_jax(tc, jax.tree.map(np.asarray, jp),
                                     device="cpu"),
            **opt_state_from_jax(tc, jax.tree.map(np.asarray, jstate),
                                 device="cpu")}
    got = {"params": {n: p.detach() for n, p in params.named_parameters()},
           "m": tstate["m"], "v": tstate["v"]}
    for part in ("params", "m", "v"):
        for n, t in got[part].items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), want[part][n].numpy(),
                                       err_msg=f"{part} {n}", **TOL)


def test_moe_loss_drops_assignments():
    """The loss runs the capacity-bounded experts: at this size some
    assignments are dropped, so its hidden states differ from the
    dropless ``forward``'s (and the reference's loss, held above, agrees
    with the bounded one)."""
    jc, tc, jm, tm, jp = _setup("olmoe-1b-7b")
    params, tb = _module(tc, jp), _batch(jc)[1]
    with torch.no_grad():
        bounded, _ = T.decoder_forward(tc, params, tb)
        dropless, _ = tm.forward(params, tb)
    assert not torch.allclose(bounded, dropless, atol=1e-4)


def _args(tmp_path, **kw):
    return argparse.Namespace(**{
        "arch": "olmo-1b", "reduced": True, "steps": 60, "batch": 2,
        "seq": 64, "lr": 3e-3, "seed": 0, "log_every": 20,
        "ckpt_dir": str(tmp_path), "ckpt_every": 20, "fail_at_step": 45,
        "grad_compression": "bf16", "data_source": "ramp", "device": "cpu",
        **kw})


def test_training_survives_failure_and_resumes_bitwise(tmp_path):
    """The reference's system test on the port, then the same run without
    the failure: the restored run ends bit for bit where it does."""
    from repro_torch.launch.train import train

    out = train(_args(tmp_path / "a"))
    assert out["restarts"] == 1
    assert out["final_loss"] < out["history"][0]["loss"] - 0.5
    clean = train(_args(tmp_path / "b", fail_at_step=None))
    assert clean["restarts"] == 0
    assert out["history"] == clean["history"]
    for (n, p), (_, q) in zip(out["params"].named_parameters(),
                              clean["params"].named_parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), n
    for part in ("m", "v"):
        for n, t in out["opt_state"][part].items():
            assert torch.equal(t, clean["opt_state"][part][n]), (part, n)
    assert torch.equal(out["opt_state"]["step"], clean["opt_state"]["step"])


def test_prefill_and_decode_steps_are_the_models():
    """``make_prefill_step`` and ``make_decode_step`` bind the model's
    ``prefill`` and ``decode_step``, as the reference's do."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    jc, tc, jm, tm, jp = _setup("olmo-1b")
    params, tb = _module(tc, jp), _batch(jc)[1]
    with torch.no_grad():
        cache, logits = make_prefill_step(tm, S + 2)(params, tb)
        want_cache, want = tm.prefill(params, tb, S + 2)
        assert torch.equal(logits, want)
        step = {"token": logits[:, -1].argmax(-1).to(torch.int32),
                "pos": torch.full((B,), S, dtype=torch.int32)}
        got, _ = make_decode_step(tm)(params, cache, step)
        assert torch.equal(got, tm.decode_step(params, want_cache, step)[0])
