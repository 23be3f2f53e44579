"""Host-side draft proposers for speculative decoding — pure host logic.

The scheduler (the policy layer — no jax, see ``tests/test_layering.py``)
asks a drafter for up to K optimistic next tokens per decoding row; the
fused step verifies the whole draft in ONE dispatch and commits only the
accepted prefix (``serving/paged_decode.py``).  Drafting is the optimistic
half of the paper's discipline applied to the sequence axis: propose
without coordination, validate after the fact, discard what fails — so a
drafter is allowed to be wrong, only *cheap* and *often right* matter.

``NGramDrafter`` is prompt-lookup decoding (the ``ngram`` speculator
shipped by mainstream serving stacks): agentic and repetitive text is highly
self-predictive, so the continuation of the sequence's own most recent
n-gram match is a strong draft at zero model cost.  A drafter returns
FEWER than k tokens (possibly none) when it has no basis to guess — the
scheduler then simply runs that row as plain decode, so a useless drafter
degrades to the non-speculative path instead of taxing it.
"""

from __future__ import annotations


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation of the earliest
    earlier occurrence of the context's n-gram suffix.

    For n = ``max_ngram`` down to 1, take the last n tokens of the context
    and search left-to-right for its FIRST earlier occurrence; on a hit,
    the k tokens that followed that occurrence become the draft.  Shorter
    suffixes only match when longer ones failed, so the strongest
    available evidence wins; no match at any n returns ``[]`` (the row
    decodes normally this step).  First-match (not most-recent-match)
    deliberately: on looping/templated text every occurrence continues the
    same way, but the earliest one has the longest tail still inside the
    context — a most-recent match sitting j tokens from the end could
    never yield more than j draft tokens no matter how large K is.
    """

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = int(max_ngram)

    def propose(self, context: list[int], k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing ``context`` (may be fewer or
        empty — see the class docstring).  Pure host scan, O(max_ngram ·
        len(context)); contexts are a few hundred tokens on the serving
        path, so this stays invisible next to a fused dispatch."""
        if k <= 0 or len(context) < 2:
            return []
        L = len(context)
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            suffix = context[L - n:]
            # earliest earlier occurrence: scan left-to-right, excluding
            # the suffix's own position (class docstring: the earliest
            # match has the longest continuation window)
            for i in range(0, L - n):
                if context[i:i + n] == suffix:
                    cont = context[i + n: i + n + k]
                    if cont:
                        return list(cont)
        return []
