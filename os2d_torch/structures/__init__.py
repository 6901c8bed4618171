"""Box and feature-map size records (counterpart of os2d_tpu/structures)."""
