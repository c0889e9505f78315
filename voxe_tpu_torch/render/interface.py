"""Render configuration (counterpart of voxe_tpu/render/interface.py;
only `SHVoxGridRenderConfig` so far — the exact renderer is not ported yet)."""
import dataclasses

from voxe_tpu_torch.utils.camera import CameraBounds


@dataclasses.dataclass(frozen=True)
class SHVoxGridRenderConfig:
    """Static render configuration (same fields and defaults as voxe_tpu's)."""

    num_samples_per_ray: int
    camera_bounds: CameraBounds
    perturb_sampled_points: bool = True
    optimized_sampling: bool = False
    linear_disparity_sampling: bool = False

    stochastic_density_noise_std: float = 0.0
    white_bkgd: bool = False

    render_diffuse: bool = False
    render_num_samples_per_ray: int = 1024
    parallel_rays_chunk_size: int = 32768

    # the fused compositing kernel is not ported yet; setting it raises
    use_fused_kernel: bool = False

    def replace(self, **kwargs) -> "SHVoxGridRenderConfig":
        return dataclasses.replace(self, **kwargs)
