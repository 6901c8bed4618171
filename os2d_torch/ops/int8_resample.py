"""The `resample_precision="int8"` tier of the correlation resample + masked
pool: the hat-weight form with corr and the hat rows quantized to int8
steps of 1/127, exact integer row sums and fp32 columns and pool, through
the CUDA kernel `csrc/int8_hat_resample.cu` on the card and through its
plain PyTorch version (`ops/sampling.int8_hat_resample_reference`) on the
CPU. It replaces the int8 branch of `os2d_tpu/ops/sampling.py:
resample_correlation_from_pxpy`, which JAX runs as XLA einsums.

The contract is that of `ops/resample.py` (the head's t-major layout):
  corr   [B, C, H, W, T_full] float32, last-dim stride 1, rows of a uniform
         stride >= T (the full 225-channel tensor or a prefix view of it);
  px, py [B, C, T, A] float32 contiguous, A = H * W;
  mask_t [C, T] float32 contiguous.
Returns [B, C, H, W] float32.

The kernel reads the fp32 prefix view and quantizes each corner as it loads
it, so no int8 copy of corr is written; it takes any B*C and any map size.
The tier has no gradient (rounding): `ops/resample_grad.py` runs the
"default" tier in its place where a graph is recorded. A CUDA tensor goes to
the kernel, or the call raises; a CPU tensor goes to the plain version.
There is no path from one to the other.
"""

from __future__ import annotations

from .cuda import CudaKernel
from .resample import ARGTYPES, run
from .sampling import int8_hat_resample_reference

KERNEL = CudaKernel("int8_hat_resample.cu", "os2d_int8_hat_resample_correlation", ARGTYPES)


def resample_correlation_int8(corr, px, py, mask_t):
    """Scores [B, C, H, W] at the `"int8"` tier: the kernel on CUDA tensors,
    the plain version on CPU tensors (see the module docstring)."""
    return run(KERNEL, int8_hat_resample_reference, corr, px, py, mask_t)
