"""ModelRunner: the fused-step executor of the serving stack (PyTorch).

The port of ``repro.serving.runner``.  The runner owns the model, the
sampling generator and the ONE-device→host-transfer-per-step invariant.
It treats the device state bundle
(:class:`repro_torch.serving.kv_manager.DeviceStepState`) as opaque: it
forwards the pool into the fused step and hands the updated state
straight back to the manager, never reading an anchor or a version.

``launch`` enqueues a step's work on the device and returns its six [B]
results still on the device; ``collect`` packs them into one int32 tensor
and reads it back with a single ``.cpu()`` — the one transfer of a steady
step.  ``execute`` is launch then collect.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kv_manager import DeviceStepState, KVCacheManager
from .paged_decode import fused_decode_step


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a host sync: on CUDA the copy
    leaves from pinned memory and is queued on the current stream (an
    upload from pageable memory would wait for it to land)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StepResult(NamedTuple):
    """One step's host-side results — the contents of the single read:
    per-slot next tokens, OA validity, grant info (fresh pages granted, −1
    = starved), COW flags, advanced-token counts and accepted-draft counts
    (0 on non-speculative steps), all as numpy arrays."""

    tokens: np.ndarray
    valid: np.ndarray
    grant_info: np.ndarray
    cow: np.ndarray
    adv: np.ndarray
    n_acc: np.ndarray


class ModelRunner:
    """Executes fused decode/prefill steps against a KV manager's device
    state (module docstring).  Holds everything the step needs that is NOT
    page lifecycle: the model, the attention tiling knob and sampling."""

    def __init__(self, cfg, model, *, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 pages_per_compute_block: int = 1):
        self.cfg = cfg
        self.model = model
        self.greedy = greedy
        self.temperature = float(temperature)
        self.pages_per_compute_block = pages_per_compute_block
        # the sampling stream lives on the model's device, seeded once
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)

    def launch(self, kvm: KVCacheManager, *, chunk_size: int = 1,
               budget: int = 1, drafts: dict | None = None,
               do_validate: bool = True):
        """Enqueue ONE fused step and install the updated device state back
        into the manager.  Returns the pending per-slot outputs for
        :meth:`collect`; nothing is read back here.

        ``drafts`` (slot → draft token list) selects the speculative step:
        the plan rides a host→device upload (never a download)."""
        st = kvm.step_state()
        speculative = drafts is not None
        draft_toks = draft_lens = None
        if speculative:
            B = kvm.max_batch
            dt = np.zeros((B, max(chunk_size - 1, 1)), np.int32)
            dl = np.zeros((B,), np.int32)
            for slot, toks in drafts.items():
                dl[slot] = len(toks)
                dt[slot, :len(toks)] = toks
            draft_toks = _upload(dt, kvm.device)
            draft_lens = _upload(dl, kvm.device)
        (kv, pool, bt, snap, lengths, last,
         nxt, valid, grant_info, cow, adv, n_acc) = fused_decode_step(
            self.model, st.kv, st.pool, st.block_tables, st.snapshot,
            st.lengths, st.last_tok, st.active, st.prompt_buf, st.prompt_len,
            self.generator, self.temperature, budget, draft_toks, draft_lens,
            do_validate, cfg=self.cfg, greedy=self.greedy,
            pages_per_compute_block=self.pages_per_compute_block,
            chunk_size=chunk_size, speculative=speculative)
        kvm.install_state(DeviceStepState(
            kv, pool, bt, snap, lengths, last,
            st.active, st.prompt_buf, st.prompt_len))
        return torch.stack([nxt, valid.to(torch.int32), grant_info,
                            cow.to(torch.int32), adv, n_acc])

    def collect(self, pending) -> StepResult:
        """THE one host transfer of a steady step: the six packed [B]
        results in a single ``.cpu()``."""
        host = pending.cpu().numpy()
        return StepResult(host[0], host[1].astype(bool), host[2],
                          host[3].astype(bool), host[4], host[5])

    def execute(self, kvm: KVCacheManager, *, chunk_size: int = 1,
                budget: int = 1, drafts: dict | None = None,
                do_validate: bool = True) -> StepResult:
        """One full step: launch, then collect its single transfer."""
        return self.collect(self.launch(
            kvm, chunk_size=chunk_size, budget=budget, drafts=drafts,
            do_validate=do_validate))
