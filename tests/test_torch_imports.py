"""Import and fallback hygiene of the PyTorch port.

- No file of os2d_torch, nor chip_smoke.py, nor demo_torch.py, nor a tool
  of the port (tools/*torch*.py, the mAP gate's, the class-scaling bench's,
  the dataset scales' and the release runbook's twins among them), nor a
  twin of an experiment launcher (experiments/*_torch.py) or of the
  baselines interface (baselines/*_torch.py) imports jax, jaxlib, optax,
  orbax or os2d_tpu; the HTTP app imports nothing outside the port and the standard
  library but fastapi. Every one of them but the app imports here; the
  pretrainer, the yuv420 wire and the checkpoint backends load none of
  those modules in a fresh process either.
- The kernel wrappers (the fp32 gather, the bf16 hat resample, the int8
  hat resample, the resample's backward, GroupNorm, the frozen BatchNorm
  and RoIAlign) have no `except` that could turn a failed kernel into a
  silent CPU fallback; every CUDA source has one.
- Os2dModel and CoaeModel target CUDA unless told otherwise, and raise
  without it.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "os2d_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "demo_torch.py"]
              + sorted((ROOT / "tools").glob("*torch*.py"))
              + sorted((ROOT / "experiments").glob("*_torch.py"))
              + sorted((ROOT / "baselines").glob("*_torch.py")))
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


def test_group_norm_wrapper_has_no_except():
    assert not _except_handlers("group_norm.py")


def test_frozen_bn_wrapper_has_no_except():
    assert not _except_handlers("frozen_bn.py")


def test_roi_align_wrapper_has_no_except():
    assert not _except_handlers("roi_align.py")


def test_csrc_sources_have_wrappers():
    """Every CUDA source of the port has a CudaKernel that builds it."""
    from os2d_torch.ops import (
        frozen_bn,
        group_norm,
        hat_resample,
        int8_resample,
        resample,
        resample_grad,
        roi_align,
    )

    sources = {k.source for k in (resample.KERNEL, hat_resample.KERNEL, int8_resample.KERNEL,
                                  resample_grad.KERNEL, group_norm.FORWARD, group_norm.BACKWARD,
                                  frozen_bn.KERNEL, roi_align.KERNEL)}
    assert sources == {p.name for p in (ROOT / "os2d_torch" / "csrc").glob("*.cu")}


def test_port_modules_import():
    """Every module of the package imports here, with no card and no nvcc:
    nothing is built at import time."""
    import importlib

    for path in PORT_FILES:
        if path != APP:
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


def test_coae_model_defaults_to_cuda():
    from os2d_torch.models.coae import CoaeModel

    if torch.cuda.is_available():
        assert CoaeModel().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CoaeModel()
    torch.backends.cudnn.allow_tf32 = True
    assert CoaeModel(device="cpu").device.type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


NEW_MODULES = ("os2d_torch.pretrain.train_imagenet", "os2d_torch.ops.pixel_format",
               "os2d_torch.utils.logger", "os2d_torch.models.checkpoint")
LOADED_WITHOUT_JAX = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
assert not bad, bad
"""


def test_pretrainer_wire_and_checkpoints_load_no_jax():
    """The pretrainer, the yuv420 wire and the checkpoint backends (with
    torch.distributed.checkpoint) import in a fresh process without loading
    jax, jaxlib, optax, orbax or os2d_tpu."""
    import os
    import subprocess
    import sys

    assert {ROOT / (m.replace(".", "/") + ".py") for m in NEW_MODULES} <= set(PORT_FILES)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", LOADED_WITHOUT_JAX.format(forbidden=set(FORBIDDEN)),
         *NEW_MODULES], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
