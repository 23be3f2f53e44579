"""Training driver with checkpoint/restart fault tolerance.

The port of ``repro.launch.train``: the same flags, supervisor loop and
output lines, plus ``--device`` (default ``cuda``; the tests pass
``--device cpu``).  Parameters start as the seeded bf16 ``init`` of the
config's family, with gradients turned on; the AdamW moments are float32
(``optim/adamw.py``).  One device runs the step.  The reference's
docstring names ``--mesh`` and ``--elastic-restore`` flags, but its
parser has neither, and neither has this one.

Fault tolerance demonstrated end-to-end: ``--fail-at-step N`` raises a
simulated host failure mid-run; the driver's supervisor loop restores the
latest checkpoint (params, optimizer, data-iterator state) and continues —
the same restart path a real cluster supervisor would exercise.

Host transfers: the pipeline's batch goes up from pinned memory without a
wait, whisper's frames and the VLM's patches are drawn on the device
(a ``torch.Generator`` seeded by the step, in the parameters' dtype), and
only a log step reads the loss back; a checkpoint step also copies the
state down for its snapshot.  Any other step makes no device->host
transfer.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init

#: the parameters' dtype, as the reference's init makes them
PARAM_DTYPE = torch.bfloat16


class SimulatedHostFailure(RuntimeError):
    pass


def _device_batch(cfg, host: dict, step: int, batch_size: int, dev) -> dict:
    """The pipeline's numpy batch on ``dev``, plus whisper's frames or the
    VLM's patches drawn there from a generator seeded by ``step``."""
    batch = {}
    for k, v in host.items():
        t = torch.from_numpy(v)
        batch[k] = (t.pin_memory().to(dev, non_blocking=True)
                    if dev.type == "cuda" else t)
    extra = {"audio": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if cfg.prefix_tokens:
        extra = ("patches", cfg.prefix_tokens)
    if extra:
        gen = torch.Generator(device=dev)
        gen.manual_seed(step)
        batch[extra[0]] = torch.randn(
            (batch_size, extra[1], cfg.d_model), generator=gen, device=dev,
            dtype=PARAM_DTYPE)
    return batch


def train(args) -> dict:
    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg,
                              grad_compression=args.grad_compression)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch,
                          source=getattr(args, "data_source", "synthetic"))
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3) if args.ckpt_dir else None

    failures_left = 1 if args.fail_at_step else 0
    restarts = 0
    history = []

    while True:  # supervisor loop: restart on failure
        params = model.init(seed=args.seed, dtype=PARAM_DTYPE, device=dev)
        params.requires_grad_(True)
        opt_state = adamw_init(params)
        pipe = TokenPipeline(data_cfg).start()
        start = 0
        if ckpt and ckpt.latest_step() is not None:
            (params, opt_state), start, extra = ckpt.restore(
                (params, opt_state), device=dev)
            pipe.load_state_dict(extra["data"])
            pipe.start()
            print(f"[train] restored step {start} (data at epoch={pipe.epoch} "
                  f"step={pipe.step})", flush=True)
        try:
            t0 = time.time()
            for step in range(start, args.steps):
                batch = _device_batch(cfg, pipe.next(), step, args.batch, dev)
                if failures_left and step == args.fail_at_step:
                    failures_left -= 1
                    raise SimulatedHostFailure(f"injected failure at step {step}")
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                if step % args.log_every == 0 or step == args.steps - 1:
                    loss = float(metrics["loss"])
                    tps = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} tok/s={tps:.0f}",
                          flush=True)
                    history.append({"step": step, "loss": loss})
                if ckpt and step > start and step % args.ckpt_every == 0:
                    # saved step = next step to run on restore
                    ckpt.save(step + 1, (params, opt_state),
                              extra={"data": pipe.state_dict()})
            break
        except SimulatedHostFailure as e:
            print(f"[train] {e}; restarting from checkpoint", flush=True)
            restarts += 1
            if ckpt:
                ckpt.wait()
            pipe.stop()
            continue
        finally:
            pipe.stop()

    if ckpt:
        ckpt.save(args.steps, (params, opt_state),
                  extra={"data": pipe.state_dict()}, blocking=True)
    final_loss = history[-1]["loss"] if history else float("nan")
    print(f"[train] done: final loss {final_loss:.4f}", flush=True)
    return {"history": history, "final_loss": final_loss,
            "restarts": restarts, "params": params, "opt_state": opt_state}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--grad-compression", default="none", choices=["none", "bf16"])
    ap.add_argument("--data-source", default="synthetic",
                    choices=["synthetic", "ramp", "file"])
    ap.add_argument("--device", default="cuda",
                    help="where the step runs: 'cuda' (the default, an error "
                         "without a card), 'cuda:N' or 'cpu'")
    train(ap.parse_args())


if __name__ == "__main__":
    main()
