"""prefix_hit_pct: prompt tokens served from the prefix cache inside the
window (``EngineStats.prefix_tokens_reused``), as a share of the prompt
tokens of the requests first admitted inside it."""


def read(run):
    prompt = run.admitted_prompt_tokens()
    if not prompt:
        return None
    return 100.0 * run.counter("prefix_tokens_reused") / prompt
