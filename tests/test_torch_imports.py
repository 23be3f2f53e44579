"""Layering of the PyTorch port: it never imports jax or the JAX package.

An AST lint over every file of ``src/repro_torch``, ``chip_smoke.py`` and
the port's examples (``examples/*_torch.py``),
an import of every port module in a child process where ``jax`` and
``repro`` cannot be imported, and the device rule: with no GPU and no
explicit ``device=``, the entry points raise instead of falling back to
the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "examples").glob("*_torch.py")))


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_repro(path):
    for m in _imports(path):
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {m}"


def test_every_port_module_imports_with_jax_blocked():
    """A child process poisons ``jax`` and ``repro`` in ``sys.modules`` (so
    importing either raises) and imports every module of the port."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_raise_without_cuda_and_without_device(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.pagepool import DevicePagePool, kv_pages_init
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine, kv_storage_init

    cfg = reduced(get_config("olmo-1b"))
    params = init_decoder_lm(cfg, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_storage_init(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServingEngine(cfg, params, num_pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePagePool(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_pages_init(4, 4, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decoder_lm(cfg)
    # an explicit CPU request is honoured
    assert kv_storage_init(cfg, 4, 4, device="cpu")["k"].device.type == "cpu"
    assert kv_pages_init(4, 4, 2, 8, device="cpu")["v"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny",
                                  "recurrentgemma-9b", "mamba2-780m"])
def test_build_model_raises_without_cuda_and_without_device(monkeypatch, arch):
    """``build_model``'s ``init`` and ``init_cache`` follow the device
    rule for every family: no card and no ``device=`` is an error."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    model = build_model(reduced(get_config(arch)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    params = model.init(dtype=torch.float32, device="cpu")
    assert params.device.type == "cpu"
    assert model.init_cache(2, 8, device="cpu")["len"].device.type == "cpu"


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``launch/train.py`` follows the device rule: no card and no
    ``--device`` is an error before any weight is made; ``--device cpu``
    trains."""
    import argparse

    from repro_torch.launch import train as T

    args = argparse.Namespace(
        arch="olmo-1b", reduced=True, steps=2, batch=1, seq=8, lr=1e-3,
        seed=0, log_every=1, ckpt_dir=None, ckpt_every=1, fail_at_step=None,
        grad_compression="none", data_source="ramp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train(args)
    monkeypatch.setattr("sys.argv", ["train"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main()  # --device defaults to cuda
    out = T.train(argparse.Namespace(**vars(args), device="cpu"))
    assert len(out["history"]) == 2
    assert out["params"].embed["tok"].device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors_and_missing_gpu(monkeypatch):
    """The CUDA wrappers never fall back: CPU tensors are refused before any
    build, and with no GPU the kernel library refuses to load."""
    from repro_torch.kernels import build
    from repro_torch.kernels.kv_append import kv_append_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    q = torch.zeros(1, 1, 2, 8)
    pages = torch.zeros(4, 2, 2, 8)
    ints = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention_cuda(q, pages, pages, torch.zeros(1, 2, dtype=torch.int32),
                             ints, ints)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv_append_cuda(pages, pages, q, q, torch.zeros(1, 2, dtype=torch.int32),
                       ints, ints, torch.ones(1, dtype=torch.bool))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.load.__wrapped__("kv_append")
    # the build cache is keyed on the source: every kernel has its own key
    assert len({build._target(n).parent for n in build.SOURCES}) == \
        len(build.SOURCES)


def test_device_meshes_raise_without_cuda_and_on_a_wrong_world(monkeypatch):
    """``make_device_mesh`` and ``init_distributed`` never fall back to the
    CPU, and a mesh must cover the process group exactly."""
    from repro_torch.launch.abstract import fake_world
    from repro_torch.launch.mesh import init_distributed, make_device_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="init_distributed first"):
        make_device_mesh((1, 1), device_type="cpu")
    with fake_world(8):
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            make_device_mesh((2, 2), device_type="cpu")
        mesh = make_device_mesh((2, 4), device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
