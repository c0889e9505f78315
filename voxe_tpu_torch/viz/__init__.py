"""Training feedback images (counterpart of voxe_tpu/viz)."""
