"""setup_s: process start to the window's opening: imports, kernel
libraries, weights, engine, graph capture and warm-up traffic (host
clock)."""


def read(run):
    return run.setup_s
