"""voxe_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of voxe_tpu.

The JAX package `voxe_tpu` is the reference; every module here mirrors its
counterpart's path and names (`voxe_tpu_torch/render/shearwarp.py` <->
`voxe_tpu/render/shearwarp.py`) and is held against it numerically by
`tests/test_torch_*.py`. This package imports torch only — never jax, flax,
optax or anything from `voxe_tpu`.

Entry points take an explicit `device` and default to "cuda"; the CPU runs
only when the caller asks for it (the tests do). Hand-written Hopper kernels
live in `csrc/` and are built with nvcc at first use (see `ops/`).
"""
