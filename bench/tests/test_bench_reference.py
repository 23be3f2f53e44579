"""The plain reference against the program's own forward, on the CPU at a
tiny width, each through its family module (``bench/families/``): the
same float32 weights from the family, the reference's logits held to
those of ``repro_torch``'s teacher-forced decoder forward over the
family's program config (dropless experts, as every serving path runs
them).  Tests may import both; the reference imports nothing of the
program."""

import pathlib

import pytest
import torch

from bench.cells import load_family
from bench.tests.tiny import SPECS as TINY

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]


def _program_logits(family, spec, params, tokens):
    from repro_torch.models.transformer import (DecoderLM, decoder_forward,
                                                unembed)

    cfg = family.program_config(spec)
    model = DecoderLM(cfg, params)
    hidden, _ = decoder_forward(cfg, model, {"tokens": tokens[None]},
                                dropless=True)
    return unembed(cfg, model, hidden)[0].float()


@pytest.mark.parametrize("family", sorted(TINY))
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_prefill_logits_match_the_program(family, seed):
    spec, fam = TINY[family], load_family(REPO, family)
    params = fam.weights(spec, seed, "cpu", dtype=torch.float32)
    tokens = torch.randint(2, spec.vocab, (40,),
                           generator=torch.Generator().manual_seed(seed))
    ref = fam.forward_logits(spec, params, tokens)
    got = _program_logits(fam, spec, params, tokens)
    assert ref.shape == got.shape == (40, spec.vocab)
    # float32 on both sides, in other orders of summation
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-4)


def test_fp8_control_departs_from_float32():
    spec, fam = TINY["dense"], load_family(REPO, "dense")
    params = fam.weights(spec, 3, "cpu", dtype=torch.float32)
    tokens = torch.arange(2, 42)
    ref = fam.forward_logits(spec, params, tokens)
    low = fam.forward_logits(spec, params, tokens, precision="fp8")
    err = (low - ref).abs().max().item()
    assert 1e-3 < err < 1.0 * ref.abs().max().item()
