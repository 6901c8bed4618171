"""The benchmark of the PyTorch and CUDA port (`os2d_torch`) on an NVIDIA H100: see run.py."""
