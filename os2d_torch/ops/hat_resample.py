"""The `resample_precision="default"` tier of the correlation resample +
masked pool: the hat-weight product in bf16 with fp32 sums, through the CUDA
kernel `csrc/hat_resample.cu` on the card and through its plain PyTorch
version (`ops/sampling.hat_resample_reference`) on the CPU.

The contract is that of `ops/resample.py` (the head's t-major layout):
  corr   [B, C, H, W, T_full] float32, last-dim stride 1, rows of a uniform
         stride >= T (the full 225-channel tensor or a prefix view of it);
  px, py [B, C, T, A] float32 contiguous, A = H * W;
  mask_t [C, T] float32 contiguous.
Returns [B, C, H, W] float32.

On the card the wrapper first builds the kernel's operand
M = bf16(corr[..., :T] * mask_t) as a contiguous [B*C, T, H, W] tensor, in
one pass (`ops/sampling.hat_resample_operand`): read straight from the
prefix view, each t-plane would sit at a stride of 225 floats. A CUDA tensor
goes to the kernel, or the call raises; a CPU tensor goes to the plain
version. There is no path from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel
from .resample import check_contract
from .sampling import hat_resample_operand, hat_resample_reference

KERNEL = CudaKernel(
    "hat_resample.cu",
    "os2d_hat_resample_correlation",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)

_MAX_GRID_Y = 65535
# the kernel's hat rows live in registers, 16 per k-step, and it is compiled
# for 1..16 k-steps: the area-preserving eval resize gives portrait scenes
# feature maps taller than the bench protocol's 96 rows (a 3:4 portrait at
# image_size 1280 and pyramid scale 1.6 gives 148 rows, 10 k-steps)
_MAX_H = 256


def resample_correlation_hat(corr, px, py, mask_t):
    """Scores [B, C, H, W] at the bf16 `"default"` tier: the kernel on CUDA
    tensors, the plain version on CPU tensors (see the module docstring)."""
    check_contract(corr, px, py, mask_t)
    if corr.device.type == "cpu":
        return hat_resample_reference(corr, px, py, mask_t)
    if corr.device.type != "cuda":
        raise ValueError(f"no hat resample for device {corr.device}")
    b, c, h, w, _ = corr.shape
    if b * c > _MAX_GRID_Y:
        raise ValueError(f"B*C = {b * c} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    if h > _MAX_H:
        raise ValueError(f"feature-map height {h} exceeds the hat kernel's {_MAX_H}")
    m = hat_resample_operand(corr, mask_t)
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=corr.device)
    with torch.cuda.device(corr.device):
        KERNEL.launch(
            m.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            b * c, h, w, px.shape[2],
            torch.cuda.current_stream(corr.device).cuda_stream,
        )
    return out
