"""tok_per_step: tokens the engine committed inside the window (prompt
tokens prefilled and tokens generated; ``EngineStats.tokens_committed``),
÷ the window's steps (``EngineStats.steps``)."""


def read(run):
    steps = run.counter("steps")
    return run.counter("tokens_committed") / steps if steps else None
