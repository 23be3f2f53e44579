"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries land in ``build/repro_torch_kernels/<hash>/`` under
the repository root — a directory ``.gitignore`` lists — keyed on a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Only sources in the repository are built.  With no ``nvcc`` or no GPU,
loading raises: there is no fallback.

The data-parallel fleet drives its replicas from one thread each, so what
the kernel modules share across calls is thread-safe: :func:`load` and
the typed entry points are cached by :func:`locked_cache` (threads that
meet a cold library wait for one build instead of each starting
``nvcc``), and the launch counters move through :func:`count_launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
SOURCES = ("paged_attention", "kv_append")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is built.  Returns
    (process or None, temporary output, target path)."""
    out = _target(name)
    if out.exists():
        return None, None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp, out: pathlib.Path) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's output."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel (one ``nvcc`` each); returns
    each source's compiler output (``-Xptxas -v`` register and shared
    memory report; empty when the library was already built)."""
    started = {n: _start(n) for n in SOURCES}
    return {n: _finish(n, *started[n]) for n in SOURCES}


def locked_cache(fn):
    """``functools.cache`` of ``fn`` whose calls hold a lock, so one thread
    computes a missing entry while the others wait for it (the cache alone
    lets two threads both compute it).  ``__wrapped__`` is ``fn``;
    ``cache_clear`` empties the cache."""
    cached = functools.cache(fn)
    lock = threading.Lock()

    @functools.wraps(fn)
    def call(*args):
        with lock:
            return cached(*args)
    call.cache_clear = cached.cache_clear
    return call


_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches``, a kernel wrapper's launch counter, under
    a lock: a bare ``+=`` from two driver threads can lose a count."""
    with _count_lock:
        fn.launches += 1


@locked_cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built first if needed)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device to run the kernel on")
    proc, tmp, out = _start(name)
    _finish(name, proc, tmp, out)
    return ctypes.CDLL(str(out))
