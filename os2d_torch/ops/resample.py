"""The correlation resample + masked pool, through the CUDA kernel
`csrc/resample.cu` on the card and through its plain PyTorch version
(`ops/sampling.resample_correlation_from_pxpy_reference`) on the CPU.

Contract (the head's t-major layout, os2d_tpu/models/head.py:294-299):
  corr   [B, C, H, W, T_full] float32, last-dim stride 1, rows of a uniform
         stride >= T (the full 225-channel tensor or a prefix view of it);
  px, py [B, C, T, A] float32 contiguous, A = H * W;
  mask_t [C, T] float32 contiguous.
Returns [B, C, H, W] float32.

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version. There is no path from one to the other. The kernel takes
any B*C and any map size (its grid is 1-D over B*C and the anchor tiles).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .sampling import resample_correlation_from_pxpy_reference

# the C signature of both resample kernels (this module's and
# ops/hat_resample.py's): corr, px, py, mask, out, bc_count, num_classes, h,
# w, t_count, t_full, stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64, ctypes.c_void_p]
KERNEL = CudaKernel("resample.cu", "os2d_resample_correlation", ARGTYPES)


def check_corr(corr, t: int):
    """Raise ValueError unless corr is a float32 [B, C, H, W, T_full] with
    T_full >= t, last-dim stride 1 and uniform row strides (the contract's
    corr, shared by every resample kernel's wrapper)."""
    if corr.dim() != 5:
        raise ValueError(f"corr must be [B, C, H, W, T_full], got {tuple(corr.shape)}")
    b, c, h, w, t_full = corr.shape
    if t > t_full:
        raise ValueError(f"corr has {t_full} channels, fewer than T={t}")
    if corr.dtype != torch.float32:
        raise ValueError(f"corr must be float32, got {corr.dtype}")
    # the kernels index corr as ((bc * H + y) * W + x) * row + t; the stride
    # of a dimension of size 1 is never used (a permuted single-class corr
    # keeps an odd one)
    row = corr.stride(3)
    outer = zip((b, c, h), corr.stride()[:3], (c * h * w * row, h * w * row, w * row))
    if corr.stride(4) != 1 or row < t or any(n > 1 and s != e for n, s, e in outer):
        raise ValueError(
            f"corr needs last-dim stride 1 and uniform row strides, got "
            f"strides {corr.stride()} for shape {tuple(corr.shape)}")


def check_operands(corr, named):
    """Raise ValueError unless each (name, tensor) is float32, contiguous and
    on corr's device."""
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != corr.device:
            raise ValueError(f"{name} is on {x.device}, corr on {corr.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_contract(corr, px, py, mask_t):
    """Raise ValueError unless the arguments meet the module's contract
    (shared by the hat and int8 resamples)."""
    if corr.dim() != 5:
        raise ValueError(f"corr must be [B, C, H, W, T_full], got {tuple(corr.shape)}")
    b, c, h, w, _ = corr.shape
    if px.dim() != 4:
        raise ValueError(f"px must be [B, C, T, A], got {tuple(px.shape)}")
    t = px.shape[2]
    if tuple(px.shape) != (b, c, t, h * w) or tuple(py.shape) != tuple(px.shape):
        raise ValueError(
            f"px/py must be [B, C, T, A] = {(b, c, t, h * w)}, got "
            f"{tuple(px.shape)} and {tuple(py.shape)}")
    if tuple(mask_t.shape) != (c, t):
        raise ValueError(f"mask_t must be [C, T] = {(c, t)}, got {tuple(mask_t.shape)}")
    check_corr(corr, t)
    check_operands(corr, (("px", px), ("py", py), ("mask_t", mask_t)))


def run(kernel, plain, corr, px, py, mask_t):
    """The dispatch of both resample wrappers (their kernels share
    ARGTYPES): check the contract, then the plain version on CPU tensors or
    the kernel on CUDA tensors."""
    check_contract(corr, px, py, mask_t)
    if corr.device.type == "cpu":
        return plain(corr, px, py, mask_t)
    if corr.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {corr.device}")
    b, c, h, w, _ = corr.shape
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=corr.device)
    with torch.cuda.device(corr.device):
        kernel.launch(
            corr.data_ptr(), px.data_ptr(), py.data_ptr(), mask_t.data_ptr(),
            out.data_ptr(), b * c, c, h, w, px.shape[2], corr.stride(3),
            torch.cuda.current_stream(corr.device).cuda_stream,
        )
    return out


def resample_correlation(corr, px, py, mask_t):
    """Scores [B, C, H, W]: the kernel on CUDA tensors, the plain version on
    CPU tensors (see the module docstring for the contract)."""
    return run(KERNEL, resample_correlation_from_pxpy_reference, corr, px, py, mask_t)
