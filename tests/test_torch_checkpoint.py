"""The port's checkpoint manager and data pipeline against the JAX
package's.

- the reference's checkpoint tests (``tests/test_checkpoint.py``) on
  ``repro_torch.checkpoint.CheckpointManager``: a round trip with bf16
  (bit for bit), the async save, a crashed writer's ``*.tmp`` ignored,
  ``keep_last``, a shape mismatch and a missing leaf refused, restore
  onto a named device (the reference's ``shardings=``), and a mid-decode
  serving engine's weights restored into a fresh engine that continues
  token for token;
- the on-disk format is the reference's: a directory the reference's
  manager wrote from a flat dict of numpy arrays (float32, bfloat16,
  int32, a 0-d leaf) restores bit for bit in the port, and one the port
  wrote restores bit for bit in the reference;
- a training state (a module and its AdamW state) restores bit for bit
  into a fresh module, in place, and fresh moments;
- the pipeline (``repro_torch.data``, a drift-checked copy): the
  reference's pipeline tests on the copy, and the copy's batches equal
  the reference's for every source.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JPipeline
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, TokenPipeline

torch.set_num_threads(1)


def tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
        "nested": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(t):
    from repro_torch.checkpoint.manager import _flatten
    return [x for _, x in _flatten(t)]


def test_roundtrip_including_bf16(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = tree()
    cm.save(5, t, extra={"note": "x"}, blocking=True)
    restored, step, extra = cm.restore(tree())
    assert step == 5 and extra["note"] == "x"
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_async_save_then_restore(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree())
    cm.wait()
    assert cm.latest_step() == 1
    assert cm.last_save["bytes"] == 12 * 4 + 4 * 2 + 4


def test_partial_tmp_dir_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, tree(), blocking=True)
    os.makedirs(tmp_path / "step_00000009.tmp")  # crashed writer
    assert cm.latest_step() == 3


def test_gc_keeps_last(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree(), blocking=True)
    assert cm.all_steps() == [3, 4]


def test_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree(), blocking=True)
    with pytest.raises(ValueError):
        cm.restore({**tree(), "w": torch.zeros(2, 2)})


def test_missing_leaf_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree(), blocking=True)
    with pytest.raises(KeyError):
        cm.restore({**tree(), "extra": torch.zeros(3)})


def test_restore_onto_a_device(tmp_path):
    """Re-placement: every leaf lands on the named device, also when the
    structure is given as meta tensors (shapes only)."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, tree(), blocking=True)
    like = {k: v for k, v in tree().items()}
    like["w"] = torch.empty(3, 4, device="meta")
    restored, _, _ = cm.restore(like, device="cpu")
    assert all(x.device.type == "cpu" for x in _leaves(restored))
    assert torch.equal(restored["w"], tree()["w"])


def test_write_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A failed background write raises on the next ``wait`` and leaves
    only a ``*.tmp`` directory, which restore ignores."""
    from repro_torch.checkpoint import manager

    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree(), blocking=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(manager.np, "save", broken)
    cm.save(2, tree())
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    assert cm.latest_step() == 1
    assert os.path.isdir(tmp_path / "step_00000002.tmp")


def _flat_numpy():
    rng = np.random.default_rng(0)
    return {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
        "c/d": np.arange(6, dtype=np.int32).reshape(2, 3),
        "s": np.asarray(11, np.int32),
    }


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    flat = _flat_numpy()
    JManager(str(tmp_path)).save(7, {k: jnp.asarray(v) for k, v in
                                     flat.items()}, extra={"data": 1},
                                 blocking=True)
    like = {k: torch.zeros(v.shape, dtype=_as_torch(v).dtype)
            for k, v in flat.items()}
    got, step, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 7 and extra == {"data": 1}
    for k, v in flat.items():
        assert got[k].dtype == _as_torch(v).dtype, k
        assert tuple(got[k].shape) == v.shape, k
        assert _bits(got[k]) == _bits(v), k


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    flat = _flat_numpy()
    CheckpointManager(str(tmp_path)).save(
        3, {k: _as_torch(v) for k, v in flat.items()}, extra={"x": [1, 2]},
        blocking=True)
    like = jax.eval_shape(lambda: {k: jnp.asarray(v) for k, v in
                                   flat.items()})
    got, step, extra = JManager(str(tmp_path)).restore(like)
    assert step == 3 and extra == {"x": [1, 2]}
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert _bits(got[k]) == _bits(v), k


def test_training_state_restores_bitwise(tmp_path):
    """(module, AdamW state) as ``launch/train.py`` saves it: a fresh
    module is loaded in place, the moments and step come back as new
    tensors, bit for bit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    model = build_model(reduced(get_config("olmoe-1b-7b")))
    params = model.init(seed=1, dtype=torch.bfloat16, device="cpu")
    state = adamw_init(params)
    grads = {n: torch.full_like(p, 0.01) for n, p in params.named_parameters()}
    params, state, _ = adamw_update(AdamWConfig(warmup_steps=1), params,
                                    grads, state)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, (params, state), blocking=True)
    fresh = model.init(seed=2, dtype=torch.bfloat16, device="cpu")
    (got, got_state), step, _ = cm.restore((fresh, adamw_init(fresh)))
    assert got is fresh and step == 1
    for (n, p), (_, q) in zip(params.named_parameters(),
                              got.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    assert got.blocks[0]["moe"]["w_router"].dtype == torch.float32
    for part in ("m", "v"):
        for n, t in state[part].items():
            assert torch.equal(t, got_state[part][n]), (part, n)
    assert got_state["step"].dtype == torch.int32
    assert int(got_state["step"]) == 1


def test_serving_engine_snapshot_restores_token_exact(tmp_path):
    """The reference's mid-decode snapshot test on the port's engine: the
    weights (a module) and each request's committed tokens go into a
    checkpoint, a fresh engine on a fresh pool continues from the
    restored weights, and the stitched outputs equal an uninterrupted
    run's."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import PagedServingEngine

    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), n_layers=1)
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.float32, device="cpu")
    kw = dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8,
              device="cpu")
    prompts, max_new = [[5, 9, 13], [7, 11]], 8

    oracle = []
    for p in prompts:
        e = PagedServingEngine(cfg, params, **kw)
        r = e.submit(p, max_new)
        e.run()
        oracle.append(r.generated)

    eng = PagedServingEngine(cfg, params, **kw)
    rs = [eng.submit(p, max_new) for p in prompts]
    eng._admit()
    for _ in range(4):
        eng.step()
    assert all(r.state == "running" and r.generated for r in rs)

    cm = CheckpointManager(str(tmp_path))
    cm.save(11, {"params": params}, blocking=True, extra={
        "requests": [{"prompt": r.prompt, "generated": r.generated,
                      "remaining": r.max_new_tokens - len(r.generated)}
                     for r in rs]})
    like = {"params": model.init(seed=5, dtype=torch.float32, device="cpu")}
    restored, step, extra = cm.restore(like)
    assert step == 11

    fresh = PagedServingEngine(cfg, restored["params"], **kw)
    conts = [fresh.submit(q["prompt"] + q["generated"], q["remaining"])
             for q in extra["requests"]]
    fresh.run()
    stitched = [q["generated"] + c.generated
                for q, c in zip(extra["requests"], conts)]
    assert stitched == oracle


# -- the data pipeline (the reference's cases on the copy) --------------------


def test_data_pipeline_determinism_and_resume():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=4)
    p1 = TokenPipeline(cfg)
    batches = [p1.next()["tokens"] for _ in range(5)]
    state = p1.state_dict()
    more = [p1.next()["tokens"] for _ in range(3)]
    p2 = TokenPipeline(cfg)
    p2.load_state_dict(state)
    resumed = [p2.next()["tokens"] for _ in range(3)]
    for a, b in zip(more, resumed):
        np.testing.assert_array_equal(a, b)
    p3 = TokenPipeline(cfg)
    np.testing.assert_array_equal(p3.next()["tokens"], batches[0])


def test_data_pipeline_fingerprint_guard():
    cfg1 = DataConfig(vocab=100, seq_len=8, global_batch=4)
    cfg2 = DataConfig(vocab=101, seq_len=8, global_batch=4)
    st = TokenPipeline(cfg1).state_dict()
    with pytest.raises(AssertionError):
        TokenPipeline(cfg2).load_state_dict(st)


def test_data_pipeline_prefetch_thread():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=4, prefetch=2)
    p = TokenPipeline(cfg).start()
    ref = TokenPipeline(cfg)
    for _ in range(4):
        np.testing.assert_array_equal(p.next()["tokens"], ref.next()["tokens"])
    p.stop()


def test_data_pipeline_host_sharding():
    a = TokenPipeline(DataConfig(vocab=50, seq_len=4, global_batch=8,
                                 num_hosts=2, host_id=0)).next()["tokens"]
    b = TokenPipeline(DataConfig(vocab=50, seq_len=4, global_batch=8,
                                 num_hosts=2, host_id=1)).next()["tokens"]
    assert a.shape == b.shape == (4, 4)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("source", ["synthetic", "ramp", "file"])
def test_pipeline_batches_equal_the_reference(source, tmp_path):
    """The copy's batches and state equal the reference pipeline's, from a
    fresh start and after a resume, with prefetch on."""
    path = None
    if source == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(3).integers(0, 300, 4000).astype(
            np.uint16).tofile(path)
    kw = dict(vocab=300, seq_len=16, global_batch=4, source=source, path=path)
    tp, jp = TokenPipeline(DataConfig(**kw)).start(), JPipeline(
        JDataConfig(**kw))
    for _ in range(9):
        np.testing.assert_array_equal(tp.next()["tokens"],
                                      jp.next()["tokens"])
    assert tp.state_dict() == jp.state_dict()
    tp.stop()
    resumed = TokenPipeline(DataConfig(**kw))
    resumed.load_state_dict(jp.state_dict())
    np.testing.assert_array_equal(resumed.next()["tokens"],
                                  jp.next()["tokens"])
