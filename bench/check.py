"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample of
the requests the program finished, drawn from the seed with the longest
among them, is run through the plain reference once each: prompt and
served tokens, teacher-forced.  The reference and its weights, drawn
again from the seed, are the cell's family's (the family contract of
``bench/cells.py``: ``forward_logits`` and ``weights``).  At every served
position the reference's float32 logits give the gap by which the served
token lies below the reference's best token there (0 where the program
picked the reference's argmax).  Two numbers come of it: the widest gap
over the sample (``widest_gap``) and the mean gap over its served
positions (``mean_gap``).  A cell's file names the numbers it compares,
each with its limit (``check.limits``); the run is correct when every one
is at most its limit.

The control (:func:`control_sample`, used by ``bench/tools/calibrate.py``
and the tests, never by a benchmark run) puts the family's reference
computed in fp8 (``precision="fp8"``) in the program's place: at the same
positions of the same prompts and served tokens, the gap read is that of
the token the fp8 forward puts first.  The harness then judges that
sample by the same :func:`compare` and the same limits, and the control
has to come out not correct.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch


@dataclasses.dataclass
class Served:
    """One finished request: its prompt and the tokens the program served.
    ``judged``, where given, are the tokens whose gaps are read at the
    served positions in their place (the control's); the context stays
    the served tokens."""

    prompt: list
    tokens: list
    judged: list | None = None


def sample(served: list[Served], seed: int, min_tokens: int,
           max_requests: int = 16) -> list[Served]:
    """The longest request (most served tokens), then others drawn from
    ``seed`` until the sample holds ``min_tokens`` served tokens."""
    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -len(served[i].tokens))
    picked = [order[0]]
    rest = order[1:]
    rng = np.random.default_rng([int(seed) % 2**63, 7])
    rng.shuffle(rest)
    total = len(served[order[0]].tokens)
    for i in rest:
        if total >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(i)
        total += len(served[i].tokens)
    return [served[i] for i in picked]


def served_gaps(ref_logits: torch.Tensor, prompt_len: int,
                tokens) -> torch.Tensor:
    """Per served token: the reference's best logit at its position minus
    the logit of that token (float32, [len(tokens)])."""
    rows = ref_logits[prompt_len - 1:prompt_len - 1 + len(tokens)]
    picked = rows.gather(1, torch.as_tensor(tokens, device=rows.device)
                         .long()[:, None])[:, 0]
    return rows.max(dim=1).values - picked


@dataclasses.dataclass
class Reading:
    widest_gap: float
    mean_gap: float
    positions: int
    off_argmax: int
    per_request: list = dataclasses.field(default_factory=list)


def repeating(tokens) -> float:
    """Share of served tokens equal to one of the 8 before them: how far
    greedy decoding on random weights has fallen into a loop."""
    t = list(tokens)
    hits = sum(1 for i in range(1, len(t)) if t[i] in t[max(0, i - 8):i])
    return hits / max(len(t), 1)


def compare(family: types.ModuleType, spec, seed: int, device,
            requests: list[Served]) -> Reading:
    """Run ``family``'s reference over each sampled request (module
    docstring).  The weights are drawn again from ``seed``: the reference
    takes nothing the program made."""
    params = family.weights(spec, seed, device)
    widest = total = 0.0
    n = off = 0
    per = []
    for r in requests:
        seq = list(r.prompt) + list(r.tokens)[:-1]
        ref = family.forward_logits(spec, params, seq)
        judged = r.tokens if r.judged is None else r.judged
        gaps = served_gaps(ref, len(r.prompt), judged)
        widest = max(widest, float(gaps.max()))
        total += float(gaps.sum())
        n += len(judged)
        off += int((gaps > 0).sum())
        per.append((len(r.prompt), len(judged), int((gaps > 0).sum()),
                    round(float(gaps.max()), 4), round(repeating(judged), 3)))
        del ref
    return Reading(widest, total / max(n, 1), n, off, per)


def control_sample(family: types.ModuleType, spec, seed: int, device,
                   requests: list[Served]) -> list[Served]:
    """The control in the program's place (module docstring): at each
    served position, teacher-forced on the served tokens, the fp8
    reference's first choice is the token judged."""
    params = family.weights(spec, seed, device)
    out = []
    for r in requests:
        seq = list(r.prompt) + list(r.tokens)[:-1]
        low = family.forward_logits(spec, params, seq, precision="fp8")
        picks = low[len(r.prompt) - 1:].argmax(dim=1)
        out.append(Served(r.prompt, r.tokens, picks.tolist()))
        del low
    return out
