"""Import and fallback hygiene of the PyTorch port.

- No file of os2d_torch, nor chip_smoke.py, nor a tool of the port
  (tools/*torch*.py, the mAP gate's twin among them) imports jax, jaxlib,
  optax, orbax or os2d_tpu; the HTTP app imports nothing outside the port
  and the standard library but fastapi.
- The kernel wrappers (the fp32 gather, the bf16 hat resample, the int8
  hat resample and the resample's backward) have no `except` that could turn
  a failed kernel into a silent CPU fallback; every CUDA source has one.
- Os2dModel targets CUDA unless told otherwise, and raises without it.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "os2d_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*torch*.py")))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "os2d_tpu")
# builds its model when imported (uvicorn imports it for `app`) and needs
# fastapi: tests/test_torch_app.py imports it with a stub fastapi
APP = ROOT / "os2d_torch" / "api" / "app.py"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _except_handlers(name):
    tree = ast.parse((ROOT / "os2d_torch" / "ops" / name).read_text())
    return [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]


def test_resample_wrapper_has_no_except():
    assert not _except_handlers("resample.py")


def test_hat_resample_wrapper_has_no_except():
    assert not _except_handlers("hat_resample.py")


def test_resample_backward_wrapper_has_no_except():
    assert not _except_handlers("resample_grad.py")


def test_int8_resample_wrapper_has_no_except():
    assert not _except_handlers("int8_resample.py")


def test_csrc_sources_have_wrappers():
    """Every CUDA source of the port has a CudaKernel that builds it."""
    from os2d_torch.ops import hat_resample, int8_resample, resample, resample_grad

    sources = {k.source for k in (resample.KERNEL, hat_resample.KERNEL, int8_resample.KERNEL,
                                  resample_grad.KERNEL)}
    assert sources == {p.name for p in (ROOT / "os2d_torch" / "csrc").glob("*.cu")}


def test_port_modules_import():
    """Every module of the package imports here, with no card and no nvcc:
    nothing is built at import time."""
    import importlib

    for path in PORT_FILES:
        if path.parent != ROOT and path != APP:
            name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
            importlib.import_module(name.removesuffix(".__init__"))


def test_app_imports_only_the_port_and_fastapi():
    import sys

    outside = {m.split(".")[0] for m in _imported_modules(APP)} - {"os2d_torch", "fastapi"}
    assert outside <= set(sys.stdlib_module_names), outside


def test_model_defaults_to_cuda():
    from os2d_torch.models import Os2dModel

    if torch.cuda.is_available():
        assert Os2dModel().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Os2dModel()
    assert Os2dModel(device="cpu").device.type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
