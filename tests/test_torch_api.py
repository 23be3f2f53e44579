"""Completeness of the port: every public name of ``repro`` has a
counterpart of the same name in the same module of ``repro_torch``.

Read by AST, so neither package is imported.  For each module of
``src/repro/``, the names in its ``__all__`` and its public top-level
functions and classes must be bound at the top level of the port's module
of the same path (defined, assigned or imported there).  ``RENAMED`` lists
the names that differ by design, and only those.
"""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"

#: (reference module, name) -> (port module, name), or None where the port
#: has no counterpart by design
RENAMED = {
    # the Pallas kernels' CUDA counterparts
    ("kernels/__init__.py", "kv_append_pallas"):
        ("kernels/__init__.py", "kv_append_cuda"),
    ("kernels/kv_append.py", "kv_append_pallas"):
        ("kernels/kv_append.py", "kv_append_cuda"),
    ("kernels/paged_attention.py", "paged_attention_pallas"):
        ("kernels/paged_attention.py", "paged_attention_cuda"),
    # a spec tree placed on a DeviceMesh, not named on a jax Mesh
    ("sharding/__init__.py", "to_named"): ("sharding/__init__.py", "to_placed"),
    ("sharding/rules.py", "to_named"): ("sharding/rules.py", "to_placed"),
    # the eager step's ops are counted instead of compiled HLO text
    ("launch/hlo_analysis.py", "analyze"): ("launch/op_analysis.py", "analyze"),
    # no HLO text to parse
    ("launch/hlo_analysis.py", "Op"): None,
    ("launch/hlo_analysis.py", "parse_computations"): None,
    # the port lowers nothing: ``cell_inputs`` and ``step_cost`` run the
    # cell's sharded step on fake tensors
    ("launch/dryrun.py", "lower_cell"): None,
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text())


def public_names(tree: ast.Module) -> set[str]:
    """``__all__``'s entries and the public top-level functions/classes."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            out |= {e.value for e in node.value.elts}
    return out


def bound_names(tree: ast.Module) -> set[str]:
    """Names bound at a module's top level: defs, classes, assignment
    targets and imports."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    missing = []
    for name in sorted(public_names(_tree(REF / rel))):
        key = (rel, name)
        if key in RENAMED and RENAMED[key] is None:
            continue
        mod, want = RENAMED.get(key, key)
        path = PORT / mod
        if not path.exists() or want not in bound_names(_tree(path)):
            missing.append(f"{name} -> {mod}::{want}")
    assert not missing, f"{rel}: no counterpart in repro_torch: {missing}"


def test_renamed_map_lists_only_real_differences():
    """Every entry of the map names a public reference name that the port
    does not bind under the same name in the same module: the map cannot
    hide a name the port has, nor outlive a rename."""
    for (rel, name), target in RENAMED.items():
        assert name in public_names(_tree(REF / rel)), (rel, name)
        same = PORT / rel
        assert not (same.exists() and name in bound_names(_tree(same))), \
            (rel, name)
        if target is not None:
            assert target[1] in bound_names(_tree(PORT / target[0])), target
