"""os2d_torch: the PyTorch + CUDA (NVIDIA Hopper) port of os2d_tpu.

It imports torch and numpy, never JAX or os2d_tpu. Entry points run on the
card unless the caller passes device="cpu"; on the CPU every hand-written
kernel is replaced by its plain PyTorch version.
"""
