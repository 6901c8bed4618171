"""The `resample_precision="int8"` tier of the correlation resample + masked
pool: the hat-weight form with corr and the hat rows quantized to int8
steps of 1/127, exact integer row sums and fp32 columns and pool, through
the CUDA kernel `csrc/int8_hat_resample.cu` on the card and through its
plain PyTorch versions on the CPU. It replaces the int8 branch of
`os2d_tpu/ops/sampling.py: resample_correlation_from_pxpy`, which JAX runs
as XLA einsums.

One kernel, two sources of the sample coordinates:
- `resample_correlation_int8_theta` (the head's interior-first path): the
  kernel forms px/py from theta in registers, so the head builds no px/py
  tensor at this tier. Plain version
  `ops/sampling.int8_hat_resample_theta_reference`.
    corr    [B, C, H, W, T_full] float32, last-dim stride 1, rows of a
            uniform stride >= T (the full tensor or a prefix view of it);
    theta   [B, C, A, 6] float32 contiguous, A = H * W;
    boxes   [A, 4] float32 contiguous (the anchors' feature-map boxes);
    lattice [2, n] float32 contiguous, T = n * n, n <= 32;
    mask_t  [C, T] float32 contiguous.
- `resample_correlation_int8` (the grid path, the contract of
  `ops/resample.py`): px, py [B, C, T, A] float32 contiguous. Plain version
  `ops/sampling.int8_hat_resample_reference`.
Both return [B, C, H, W] float32.

The kernel reads the fp32 prefix view and quantizes what it reads, so no
int8 copy of corr is written; it takes any B*C and any map size. The tier
has no gradient (rounding): the head and `ops/resample_grad.py` run the
"default" tier in its place where a graph is recorded. A CUDA tensor goes
to the kernel, or the call raises; a CPU tensor goes to the plain version.
There is no path from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda import CudaKernel
from .resample import check_contract, check_corr, check_operands
from .sampling import int8_hat_resample_reference, int8_hat_resample_theta_reference

# corr, px, py, theta, boxes, lattice, mask, out, bc_count, num_classes, h, w,
# t_count, side, t_full, inv_w1, inv_h1, stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
KERNEL = CudaKernel("int8_hat_resample.cu", "os2d_int8_hat_resample_correlation", ARGTYPES)
MAX_LATTICE_SIDE = 32


def _reciprocal(n: int) -> float:
    """fp32(1 / fp32(n)), as ATen's CUDA division by a scalar forms its
    multiplier (inf for n = 0)."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(n))


def _launch(corr, mask_t, t, px=None, py=None, theta=None, boxes=None, lattice=None):
    if corr.device.type != "cuda":
        raise ValueError(f"no int8 resample kernel for device {corr.device}")
    b, c, h, w, _ = corr.shape
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=corr.device)

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    side = 0 if lattice is None else lattice.shape[1]
    with torch.cuda.device(corr.device):
        KERNEL.launch(
            ptr(corr), ptr(px), ptr(py), ptr(theta), ptr(boxes), ptr(lattice),
            mask_t.data_ptr(), out.data_ptr(), b * c, c, h, w, t, side, corr.stride(3),
            _reciprocal(w - 1), _reciprocal(h - 1),
            torch.cuda.current_stream(corr.device).cuda_stream,
        )
    return out


def resample_correlation_int8(corr, px, py, mask_t):
    """Scores [B, C, H, W] at the `"int8"` tier from px/py: the kernel on
    CUDA tensors, the plain version on CPU tensors (see the module
    docstring)."""
    check_contract(corr, px, py, mask_t)
    if corr.device.type == "cpu":
        return int8_hat_resample_reference(corr, px, py, mask_t)
    return _launch(corr, mask_t, px.shape[2], px=px, py=py)


def resample_correlation_int8_theta(corr, theta, boxes, lattice, mask_t):
    """Scores [B, C, H, W] at the `"int8"` tier from theta: the kernel on
    CUDA tensors, the plain version on CPU tensors (see the module
    docstring)."""
    if corr.dim() != 5:
        raise ValueError(f"corr must be [B, C, H, W, T_full], got {tuple(corr.shape)}")
    b, c, h, w, _ = corr.shape
    a = h * w
    side = lattice.shape[-1]
    if lattice.dim() != 2 or lattice.shape[0] != 2 or not 1 <= side <= MAX_LATTICE_SIDE:
        raise ValueError(f"lattice must be [2, n] with 1 <= n <= {MAX_LATTICE_SIDE}, "
                         f"got {tuple(lattice.shape)}")
    t = side * side
    for name, x, shape in (("theta", theta, (b, c, a, 6)), ("boxes", boxes, (a, 4)),
                           ("mask_t", mask_t, (c, t))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    check_corr(corr, t)
    check_operands(corr, (("theta", theta), ("boxes", boxes), ("lattice", lattice),
                          ("mask_t", mask_t)))
    if corr.device.type == "cpu":
        return int8_hat_resample_theta_reference(corr, theta, boxes, lattice, mask_t)
    return _launch(corr, mask_t, t, theta=theta, boxes=boxes, lattice=lattice)
