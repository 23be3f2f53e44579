"""What the benchmark loads.

A fresh process drives a whole run of a tiny cell of each family on the
CPU through the harness (every module ``bench/run.py`` loads, the metric
readers, the family modules and the program's serving stack included) and
then lists the modules it holds: no top-level name, compared whole, may be
``jax``, ``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` is the program
and allowed).  The plain reference, imported alone, and each family
module, loaded alone with its reference, must not pull in ``repro_torch``,
and no file of ``bench/reference/`` names it.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
ENV = {"PYTHONPATH": f"{REPO / 'src'}:{REPO}", "PATH": "/usr/bin:/bin",
       "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def _child(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(1)\n"
        "import bench.run as br\n"
        "from bench.tests.tiny import add_toy_family, make_root\n"
        "from bench.cells import load_cell\n"
        "from bench.harness import run_cell\n"
        f"root = make_root({str(tmp_path)!r})\n"
        "add_toy_family(root)\n"
        "for cell in ('tiny-dense.open', 'tiny-moe.closed',\n"
        "             'tiny-relu2.closed'):\n"
        "    run_cell(load_cell(root, cell), 5, 0.5, True, 'cpu',\n"
        "             time.perf_counter(), log=lambda m: None)\n"
        "assert 'repro_torch.serving' in sys.modules\n"
        "print(br.forbidden_modules())\n")
    assert _child(code) == "[]"


def test_forbidden_names_are_compared_whole():
    code = (
        "import sys, types\n"
        "import bench.run as br\n"
        "sys.modules['repro_torch_extra'] = types.ModuleType('x')\n"
        "sys.modules['jaxon'] = types.ModuleType('x')\n"
        "before = br.forbidden_modules()\n"
        "sys.modules['repro.core'] = types.ModuleType('x')\n"
        "print(before, br.forbidden_modules())\n")
    assert _child(code) == "[] ['repro.core']"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import bench.reference.model, bench.check\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('repro', 'repro_torch',\n"
            "                                    'jax')))\n")
    assert _child(code) == "[]"


@pytest.mark.parametrize("family", sorted(
    p.stem for p in (BENCH / "families").glob("*.py")))
def test_a_family_and_its_reference_load_nothing_of_the_program(family):
    code = ("import inspect, pathlib, sys\n"
            "from bench.cells import load_family\n"
            f"fam = load_family({str(REPO)!r}, {family!r})\n"
            "ref = pathlib.Path(inspect.getsourcefile(fam.forward_logits))\n"
            "print(ref.parent.name, sorted(\n"
            "    m for m in sys.modules if m.split('.')[0] in\n"
            "    ('repro', 'repro_torch', 'jax', 'jaxlib', 'flax')))\n")
    assert _child(code) == "reference []"


@pytest.mark.parametrize("path", sorted(
    [*(BENCH / "reference").glob("*.py"),
     *(BENCH / "tests" / "toy" / "reference").glob("*.py")]),
                         ids=lambda p: p.name)
def test_reference_files_name_no_program_module(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("repro", "repro_torch", "jax",
                                           "jaxlib"), (path.name, n)
