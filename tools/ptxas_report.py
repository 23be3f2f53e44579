"""Registers and spills of every kernel in a CUDA source, as built.

Usage: python tools/ptxas_report.py SOURCE.cu [SOURCE.cu ...]

Compiles each source with the port's flags
(``repro_torch.kernels.build.NVCC_FLAGS``, which include ``-Xptxas -v``)
into a temporary library and prints one JSON object a source: each
kernel instantiation's ``[registers, stack-frame bytes, spill-store
bytes, spill-load bytes]``.  Needs ``nvcc``; a GPU is not needed.  ``chip_smoke.py`` prints
the same table for the sources it builds.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.build import (NVCC_FLAGS, nvcc_path,  # noqa: E402
                                       ptxas_table)


def report(source: str) -> dict[str, tuple[int, int, int, int]]:
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(pathlib.Path(tmp) / "k.so"),
             source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{proc.stdout}"
                         f"{proc.stderr}")
    return ptxas_table(proc.stdout + proc.stderr)


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    for source in argv:
        print(json.dumps({"source": source, "kernels": report(source)},
                         sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
