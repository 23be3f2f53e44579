"""Nothing downstream of attention reads a padded query slot.

On CUDA, kernel 1 writes zeros to each row's query slots past its chunk
length (``kernels/csrc/paged_attention.cu``, header note point 8) and
does not compute them; the plain version on the CPU gives them the
horizon of the row's length.  Here the serving engine runs on the CPU
twice from the same weights and requests — once as it is, once with
``serving/paged_decode.py``'s ``paged_attention`` wrapped to zero those
slots — with a mix of prefilling, decoding and speculative rows in one
[B, C] step.  The two runs commit the same tokens, and every logit the
step computes at a live position is bitwise the same: what the padded
slots hold reaches no committed token, no live logit and no K/V.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_decoder_lm
from repro_torch.serving import PagedServingEngine, paged_decode

torch.set_num_threads(1)


class _Alternating:
    """A drafter that guesses a context's last k tokens when its length is
    odd and nothing otherwise, so that plain and speculative steps, and
    drafting and plain decoding rows, alternate whatever the weights."""

    def propose(self, context, k):
        return list(context[-k:]) if len(context) % 2 else []


def _serve(cfg, params, monkeypatch, zero):
    """Serve six requests (four slots, chunks of 8, drafts of up to 3);
    returns (each request's tokens, every ``_unembed`` output with the
    step's chunk lengths, what the attention wrapper saw)."""
    seen = dict(zeroed=0, mixed=0, spec=0, plain=0, chunk_lens=None)
    logits = []
    attend, unembed = paged_decode.paged_attention, paged_decode._unembed
    accept = paged_decode.speculative_accept

    def attention(*args, chunk_lens, **kw):
        outs = attend(*args, chunk_lens=chunk_lens, **kw)
        C = outs[0].shape[1]
        seen["chunk_lens"] = cl = chunk_lens[0].clone()
        if C > 1 and int(cl.min()) == 1 and 1 < int(cl.max()) < C:
            seen["mixed"] += 1  # decoding and prefilling rows in one step
        for out, n in zip(outs, chunk_lens):
            pad = torch.arange(C)[None, :] >= n[:, None]
            seen["zeroed"] += int(torch.count_nonzero(out[pad]))
            if zero:
                out[pad] = 0
        return outs

    def logits_of(cfg, shards, layout, x):
        y = unembed(cfg, shards, layout, x)
        seen["plain"] += int(x.shape[1] == 1 and x.shape[0] > 0)
        logits.append((y.detach().clone(), seen["chunk_lens"]))
        return y

    def speculative(tgt, tok, dlens):
        seen["spec"] += int(dlens.max() > 0)
        return accept(tgt, tok, dlens)

    monkeypatch.setattr(paged_decode, "paged_attention", attention)
    monkeypatch.setattr(paged_decode, "_unembed", logits_of)
    monkeypatch.setattr(paged_decode, "speculative_accept", speculative)
    eng = PagedServingEngine(cfg, params, num_pages=64, page_size=4,
                             max_batch=4, prefill_chunk=8, speculative_k=3,
                             drafter=_Alternating(), device="cpu")
    rng = np.random.default_rng(3)
    motif = [7, 3, 9, 4]
    prompts = [motif * 6 + [5], rng.integers(2, 400, 19).tolist(),
               motif * 2, rng.integers(2, 400, 30).tolist(), motif * 4,
               rng.integers(2, 400, 11).tolist()]
    reqs = [eng.submit(p, 10) for p in prompts]
    eng.run()
    monkeypatch.undo()
    return [r.generated for r in reqs], logits, seen


@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b", "trinity-mini"],
                         ids=["dense", "moe", "afmoe"])
def test_padded_slots_reach_nothing_downstream(arch, monkeypatch):
    cfg = reduced(get_config(arch))
    params = init_decoder_lm(cfg, seed=9, dtype=torch.float32, device="cpu")
    tokens, logits, seen = _serve(cfg, params, monkeypatch, zero=False)
    z_tokens, z_logits, z_seen = _serve(cfg, params, monkeypatch, zero=True)
    # the runs held every kind of row, and the wrapper had work to do
    assert all(seen[n] > 0 for n in ("mixed", "spec", "plain", "zeroed"))
    assert z_tokens == tokens and all(len(t) == 10 for t in tokens)
    assert len(z_logits) == len(logits)
    for (a, cl), (b, z_cl) in zip(logits, z_logits):
        assert torch.equal(cl, z_cl)
        if a.shape[1] > 1:  # a speculative step: logits at every position
            live = torch.arange(a.shape[1])[None, :] < cl[:, None]
            a, b = a[live], b[live]
        assert torch.equal(a, b)
