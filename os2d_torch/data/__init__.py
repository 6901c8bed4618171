"""Host-side data layer: datasets, eval and train dataloaders, transforms
(counterpart of os2d_tpu/data)."""
