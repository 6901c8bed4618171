"""Import and fallback hygiene of the PyTorch port.

- No file of os2d_torch, nor chip_smoke.py, nor a tool of the port
  (tools/*torch*.py, the mAP gate's twin among them) imports jax, jaxlib or
  os2d_tpu.
- The kernel wrappers (the fp32 gather, the bf16 hat resample and the
  resample's backward) have no `except` that could turn a failed kernel into
  a silent CPU fallback.
- Os2dModel targets CUDA unless told otherwise, and raises without it.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "os2d_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*torch*.py")))
FORBIDDEN = ("jax", "jaxlib", "os2d_tpu")


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


def test_port_modules_import():
    """Every module of the package imports here, with no card and no nvcc:
    nothing is built at import time."""
    import importlib

    for path in PORT_FILES:
        if path.parent != ROOT:
            name = ".".join(path.relative_to(ROOT).with_suffix("").parts)
            importlib.import_module(name.removesuffix(".__init__"))


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
