"""End-to-end training example over the PyTorch port (``repro_torch``), as
``examples/train_lm.py`` runs it over the JAX package: a ~20M-param LM
for a few hundred steps with checkpointing and an injected mid-run
failure (the restart from the last checkpoint is automatic).

Run on the card: PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
On the CPU:      PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Without ``--ckpt-dir`` the checkpoints go to a temporary directory that is
removed afterwards (a directory that already holds checkpoints would be
resumed from).
"""

import argparse
import tempfile

import repro_torch.launch.train as T


def run(steps: int = 300, ckpt_dir=None, device=None, batch: int = 4,
        seq: int = 128, ckpt_every: int = 100, log_every: int = 25) -> dict:
    """Train reduced olmo-1b for ``steps`` steps of ramp data, a checkpoint
    every ``ckpt_every`` steps and a failure injected at ``steps // 2``;
    asserts the loss fell.  Returns ``train``'s result."""
    if ckpt_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run(steps, tmp, device, batch, seq, ckpt_every, log_every)
    args = argparse.Namespace(
        arch="olmo-1b", reduced=True, steps=steps, batch=batch, seq=seq,
        lr=3e-3, seed=0, log_every=log_every, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, fail_at_step=steps // 2,
        grad_compression="bf16", data_source="ramp", device=device)
    out = T.train(args)
    assert out["restarts"] == 1, "the injected failure must restart once"
    assert out["final_loss"] < out["history"][0]["loss"], \
        "loss must decrease"
    print("train_lm OK — loss decreased through an injected failure+restart")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ns = ap.parse_args()
    run(ns.steps, ns.ckpt_dir, ns.device)
