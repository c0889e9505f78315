"""Training losses: photometric, volumetric-correlation, and TV regularizers
(counterpart of voxe_tpu/train/losses.py; reference
thre3d_atom/modules/sds_trainer.py:494-567)."""
import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def density_correlation_loss(sds_density, regular_density):
    """1 - Pearson correlation of the two density grids, and the detached
    per-voxel correlation grid."""
    eps = 1e-7
    sds_var = torch.mean((sds_density - torch.mean(sds_density)) ** 2)
    regular_var = torch.mean((regular_density - torch.mean(regular_density)) ** 2)
    # eps inside the sqrt keeps the gradient finite for a constant grid
    denominator = torch.sqrt(sds_var * regular_var + eps * eps)
    covariance_grid = (sds_density - torch.mean(sds_density)) * (
        regular_density - torch.mean(regular_density)
    )
    correlation_grid = covariance_grid / (denominator + eps)
    correlation = torch.mean(correlation_grid)
    return 1.0 - correlation, correlation_grid.detach()


def density_correlation_loss_fn(
    sds_density, regular_density, l2_mode: bool = False, l1_mode: bool = False
):
    """DCL with the reference's L2/L1 ablation modes."""
    if l2_mode:
        return l2_loss(sds_density, regular_density), None
    if l1_mode:
        return l1_loss(sds_density, regular_density), None
    return density_correlation_loss(sds_density, regular_density)


def feature_correlation_loss(sds_features, regular_features):
    """Squared channel-summed difference of sigmoided features, summed over
    the grid (formula-exact to the reference despite the name)."""
    diffs = torch.sigmoid(sds_features) - torch.sigmoid(regular_features.detach())
    return torch.sum(torch.sum(diffs, dim=-1) ** 2)


def tv_loss_on_grid(grid_values):
    """Mean-absolute total variation over a [X, Y, Z, C] grid, averaged over
    the three axes."""
    tv0 = torch.mean(torch.abs(torch.diff(grid_values, dim=0)))
    tv1 = torch.mean(torch.abs(torch.diff(grid_values, dim=1)))
    tv2 = torch.mean(torch.abs(torch.diff(grid_values, dim=2)))
    return (tv0 + tv1 + tv2) / 3.0
