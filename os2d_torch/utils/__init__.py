"""Logging, metric series and checkpoints (counterpart of os2d_tpu/utils)."""
