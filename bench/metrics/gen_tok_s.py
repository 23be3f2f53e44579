"""gen_tok_s: generated tokens that reached the host inside the window, ÷
the window's seconds (host clock)."""


def read(run):
    return run.generated() / run.window_s
