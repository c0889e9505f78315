"""Training feedback images, camera-path renders and the turntable video (counterpart of voxe_tpu/viz)."""
