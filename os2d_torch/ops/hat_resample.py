"""The `resample_precision="default"` tier of the correlation resample +
masked pool: the hat-weight form with bf16 values and hat rows and fp32
sums, through the CUDA kernel `csrc/hat_resample.cu` on the card and through
its plain PyTorch version (`ops/sampling.hat_resample_reference`) on the CPU.

The contract is that of `ops/resample.py` (the head's t-major layout):
  corr   [B, C, H, W, T_full] float32, last-dim stride 1, rows of a uniform
         stride >= T (the full 225-channel tensor or a prefix view of it);
  px, py [B, C, T, A] float32 contiguous, A = H * W;
  mask_t [C, T] float32 contiguous.
Returns [B, C, H, W] float32.

The kernel reads the fp32 prefix view as it is and forms each value
bf16(corr * mask_t) as it loads it, so no operand tensor is built on the
card; it takes any B*C and any map size. A CUDA tensor goes to the kernel,
or the call raises; a CPU tensor goes to the plain version. There is no path
from one to the other.
"""

from __future__ import annotations

from .cuda import CudaKernel
from .resample import ARGTYPES, run
from .sampling import hat_resample_reference

KERNEL = CudaKernel("hat_resample.cu", "os2d_hat_resample_correlation", ARGTYPES)


def resample_correlation_hat(corr, px, py, mask_t):
    """Scores [B, C, H, W] at the bf16 `"default"` tier: the kernel on CUDA
    tensors, the plain version on CPU tensors (see the module docstring)."""
    return run(KERNEL, hat_resample_reference, corr, px, py, mask_t)
