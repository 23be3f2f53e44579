"""The plain reference against the program's own forward, on the CPU at a
tiny width: the same float32 weights from ``bench/weights.py``, the
reference's logits held to those of ``repro_torch``'s teacher-forced
decoder forward (dropless experts, as every serving path runs them).
Tests may import both; the reference imports nothing of the program."""

import pytest
import torch

from bench.harness import arch_config
from bench.reference.model import forward_logits
from bench.spec import ModelSpec
from bench.weights import make_weights

torch.set_num_threads(1)

TINY = {
    "dense": ModelSpec(name="tiny-dense", family="dense", norm="nonparam_ln",
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab=256, rope_theta=1e4,
                       tied=True, init_std=0.08),
    "moe": ModelSpec(name="tiny-moe", family="moe", norm="rmsnorm",
                     n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=32, vocab=256, rope_theta=1e4,
                     tied=False, n_experts=8, top_k=2, norm_eps=1e-6,
                     init_std=0.08, norm_scale_std=0.1),
}


def _program_logits(spec, params, tokens):
    from repro_torch.models.transformer import (DecoderLM, decoder_forward,
                                                unembed)

    cfg = arch_config(spec)
    model = DecoderLM(cfg, params)
    hidden, _ = decoder_forward(cfg, model, {"tokens": tokens[None]},
                                dropless=True)
    return unembed(cfg, model, hidden)[0].float()


@pytest.mark.parametrize("family", sorted(TINY))
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_prefill_logits_match_the_program(family, seed):
    spec = TINY[family]
    params = make_weights(spec, seed, "cpu", dtype=torch.float32)
    tokens = torch.randint(2, spec.vocab, (40,),
                           generator=torch.Generator().manual_seed(seed))
    ref = forward_logits(spec, params, tokens)
    got = _program_logits(spec, params, tokens)
    assert ref.shape == got.shape == (40, spec.vocab)
    # float32 on both sides, in other orders of summation
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-4)


def test_fp8_control_departs_from_float32():
    spec = TINY["dense"]
    params = make_weights(spec, 3, "cpu", dtype=torch.float32)
    tokens = torch.arange(2, 42)
    ref = forward_logits(spec, params, tokens)
    low = forward_logits(spec, params, tokens, precision="fp8")
    err = (low - ref).abs().max().item()
    assert 1e-3 < err < 1.0 * ref.abs().max().item()
