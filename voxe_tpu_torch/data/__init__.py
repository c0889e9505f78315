"""Posed-image data: the dataset, its JSON keys and the synthetic scene
(counterpart of voxe_tpu/data)."""
