"""ImageNet pretraining of the OS2D backbone (counterpart of os2d_tpu/pretrain)."""
