"""``Model.loss`` and every gradient leaf against the JAX package's on the
second half of the zoo's reduced configs (the first half, and the rest of
the training path: ``tests/test_torch_train.py``), in float32 at the
tolerances stated there.  This half holds both MoE configs (the
capacity-bounded experts, the aux loss and the combine's transpose,
which the port leaves to autograd), the VLM (the loss on its text suffix
only), RecurrentGemma and Mamba-2.  Also the same on reduced olmo-1b
and recurrentgemma-9b with ``remat="full"`` and olmo-1b with ``"dots"``
(``reduced()`` sets ``"none"``), where the port must run each layer under
``torch.utils.checkpoint``."""

import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch.models import transformer as T
from test_torch_train import ARCHS_HERE, _setup, check_loss_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in ARCHS_HERE])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch,remat", [("olmo-1b", "full"),
                                        ("recurrentgemma-9b", "full"),
                                        ("olmo-1b", "dots")])
def test_remat_loss_and_grads_match_reference(arch, remat, monkeypatch):
    """The reference's ``_maybe_remat`` scans against the port's layer
    loops under ``torch.utils.checkpoint``: the same loss and gradients,
    and one checkpointed call per layer (per group for the hybrid, whose
    tail runs as it is)."""
    calls = []

    def counted(fn, *args, **kw):
        calls.append(kw.get("context_fn"))
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    check_loss_and_grads(arch, remat)
    tc = _setup(arch, remat)[1]
    assert len(calls) == (tc.n_layers // 3 if tc.family == "hybrid"
                          else tc.n_layers)
    assert all((c is not None) == (remat == "dots") for c in calls)
