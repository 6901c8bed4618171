"""Host-side data layer of the eval path (counterpart of os2d_tpu/data)."""
