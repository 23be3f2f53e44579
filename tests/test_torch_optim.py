"""The port's AdamW (``repro_torch.optim``) against the JAX package's.

- the reference's own optimizer tests (``tests/test_optim.py``) on the
  port: a quadratic minimised, clipping bounds the update, the schedule's
  warmup and decay, the global norm, bf16 parameters keep their dtype;
- five steps of both on the same parameters and gradients (numpy, from a
  seed), float32: every step's ``grad_norm`` and ``lr``, then every
  parameter and moment, within 1e-6 abs + 1e-5 rel (float32, the same
  operations in the same order; ``b ** step`` may differ in its last
  bit); with bf16 parameters the parameters stay bf16 and agree within
  one bf16 step (2^-7 relative: the float32 results a rounding apart may
  round to neighbouring bf16 values), the moments stay float32;
- the learning-rate schedule at every step of a short run, and the
  reference's state carried into the port (``convert.opt_state_from_jax``)
  steps on as the reference's does;
- nothing in an update reads the device from the host: ``step``, ``lr``
  and ``grad_norm`` are tensors on the parameters' device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro_torch import optim as to

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-5)
SHAPES = {"a": (4, 3), "b": (7,), "c/d": (2, 2, 5)}


def test_adamw_minimizes_quadratic():
    cfg = to.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                         total_steps=200)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = to.adamw_init(params)
    for _ in range(150):
        g = {"x": 2 * params["x"]}
        params, state, _ = to.adamw_update(cfg, params, g, state)
    assert float(torch.sum(params["x"] ** 2)) < 1e-2


def test_grad_clipping_bounds_update():
    cfg = to.AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=1)
    params = {"x": torch.zeros(3)}
    state = to.adamw_init(params)
    p2, state, info = to.adamw_update(cfg, params, {"x": torch.full((3,), 1e9)},
                                      state)
    assert float(info["grad_norm"]) > 1e8
    assert float(p2["x"].abs().max()) < 1.0  # update stayed bounded


def test_schedule_warmup_and_decay():
    cfg = to.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(to.cosine_schedule(cfg, 0)) == 0.0
    assert abs(float(to.cosine_schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(to.cosine_schedule(cfg, 100)) < 1e-6
    assert float(to.cosine_schedule(cfg, 50)) < 1.0


def test_schedule_matches_reference():
    for jc, tc in ((jo.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40),
                    to.AdamWConfig(lr=3e-3, warmup_steps=7, total_steps=40)),
                   (jo.AdamWConfig(warmup_steps=0, total_steps=1),
                    to.AdamWConfig(warmup_steps=0, total_steps=1))):
        for s in range(45):
            j = jo.cosine_schedule(jc, jnp.asarray(s, jnp.int32))
            t = to.cosine_schedule(tc, torch.tensor(s, dtype=torch.int32))
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t), float(j), **TOL)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(to.global_norm(t)) - 5.0) < 1e-6


def test_bf16_params_keep_dtype():
    cfg = to.AdamWConfig(lr=1e-3, warmup_steps=1)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = to.adamw_init(params)
    p2, state, _ = to.adamw_update(
        cfg, params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state)
    assert p2["w"].dtype == torch.bfloat16
    assert state["m"]["w"].dtype == torch.float32  # moments stay fp32


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_steps_match_reference(dtype):
    jcfg = jo.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                          clip_norm=0.5)
    tcfg = to.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                          clip_norm=0.5)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = _trees(0)
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in p0.items()}
    js, ts = jo.adamw_init(jp), to.adamw_init(tp)
    for i in range(5):
        g = _trees(10 + i)
        g["a"] *= 20  # some steps clip
        jp, js, jinfo = jo.adamw_update(
            jcfg, jp, {k: jnp.asarray(v).astype(jd) for k, v in g.items()}, js)
        tp, ts, tinfo = to.adamw_update(
            tcfg, tp, {k: torch.from_numpy(v).to(td) for k, v in g.items()},
            ts)
        for k in ("grad_norm", "lr"):
            assert tinfo[k].dtype == torch.float32
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                       err_msg=f"step {i} {k}", **TOL)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
    for k in SHAPES:
        assert tp[k].dtype == td
        want = np.asarray(jp[k].astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_allclose(tp[k].float().numpy(), want,
                                       atol=1e-6, rtol=2**-7, err_msg=k)
        else:
            np.testing.assert_allclose(tp[k].numpy(), want, err_msg=k, **TOL)
        for part in ("m", "v"):
            assert ts[part][k].dtype == torch.float32
            np.testing.assert_allclose(ts[part][k].numpy(),
                                       np.asarray(js[part][k]),
                                       err_msg=f"{part} {k}", **TOL)


def test_module_state_is_keyed_by_parameter_name():
    """Over a module, the state follows ``named_parameters()``, and the
    update writes the parameters in place."""
    mod = torch.nn.Linear(3, 2)
    state = to.adamw_init(mod)
    assert set(state["m"]) == {"weight", "bias"}
    before = mod.weight.detach().clone()
    grads = {n: torch.ones_like(p) for n, p in mod.named_parameters()}
    out, state, _ = to.adamw_update(to.AdamWConfig(warmup_steps=1), mod,
                                    grads, state)
    assert out is mod and not torch.equal(mod.weight, before)


def test_reference_state_carries_into_the_port():
    """The reference's state after two steps, carried through
    ``convert.opt_state_from_jax``, steps on as the reference's does."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import named_from_jax, opt_state_from_jax
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild

    jc, tc = jreduced(jget("olmo-1b")), reduced(get_config("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jbuild(jc).init(jax.random.PRNGKey(0)))
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(4)
    grads = [tdef.unflatten([jnp.asarray(rng.standard_normal(l.shape),
                                         jnp.float32) * 1e-2 for l in leaves])
             for _ in range(3)]
    js = jo.adamw_init(jp)
    for g in grads[:2]:
        jp, js, _ = jo.adamw_update(jo.AdamWConfig(**cfg), jp, g, js)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    tp = named_from_jax(tc, np_tree(jp), device="cpu")
    ts = opt_state_from_jax(tc, np_tree(js), device="cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    jp, js, _ = jo.adamw_update(jo.AdamWConfig(**cfg), jp, grads[2], js)
    tp, ts, _ = to.adamw_update(to.AdamWConfig(**cfg), tp, named_from_jax(
        tc, np_tree(grads[2]), device="cpu"), ts)
    want_p = named_from_jax(tc, np_tree(jp), device="cpu")
    want_s = opt_state_from_jax(tc, np_tree(js), device="cpu")
    for n in want_p:
        np.testing.assert_allclose(tp[n].numpy(), want_p[n].numpy(),
                                   err_msg=n, **TOL)
        for part in ("m", "v"):
            np.testing.assert_allclose(ts[part][n].numpy(),
                                       want_s[part][n].numpy(),
                                       err_msg=f"{part} {n}", **TOL)


def test_update_keeps_everything_on_the_device():
    """``step``, ``lr`` and ``grad_norm`` are 0-d float32/int32 tensors on
    the parameters' device: nothing was read back to the host."""
    params = {"w": torch.zeros(3)}
    state = to.adamw_init(params)
    _, state, info = to.adamw_update(to.AdamWConfig(), params,
                                     {"w": torch.ones(3)}, state)
    for t, dt in ((state["step"], torch.int32), (info["lr"], torch.float32),
                  (info["grad_norm"], torch.float32)):
        assert isinstance(t, torch.Tensor) and t.dtype == dt and t.dim() == 0
        assert t.device == params["w"].device
