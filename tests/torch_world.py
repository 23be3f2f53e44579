"""A world of gloo ranks on the CPU for the sharded-step tests.

:func:`run_world` starts ``n`` Python processes of one program, each with
its rank, the world size, a free port and a work directory on its command
line (``sys.argv[1:5]``), waits for all of them (each with its own
timeout) and returns what each printed as JSON on its last line.  The
port is found by binding port 0, so files that run at once under xdist
never share one.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the head of every rank's program: one thread a rank, the process group
WORLD_HEAD = r"""
import json, sys
import torch
torch.set_num_threads(1)
RANK, WORLD, PORT, WORK = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
from repro_torch.launch.mesh import init_distributed, make_device_mesh
init_distributed(rank=RANK, world_size=WORLD, device_type="cpu", port=PORT)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(prog: str, work, n: int = 8, timeout: int = 600) -> list:
    """Run ``WORLD_HEAD + prog`` on ``n`` gloo ranks; each rank's last
    stdout line, parsed as JSON, in rank order."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD_HEAD + prog, str(r), str(n), str(port),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
