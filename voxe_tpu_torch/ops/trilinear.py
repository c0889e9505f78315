"""Trilinear interpolation of a dense voxel grid at continuous points
(counterpart of voxe_tpu/ops/trilinear.py).

`grid[x, y, z, c]` is interpolated with `points[:, 0] -> x`, `[:, 1] -> y`,
`[:, 2] -> z`, align_corners=False (voxel centres at i + 0.5) and zero
padding outside. The 8 corners are gathered from the flat table with
`index_select` (its backward is a scatter-add) and summed in float32 even
for a bfloat16 table.
"""
import torch


def trilinear_interpolate(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """grid [X, Y, Z, C], points [N, 3] in [-1, 1] -> [N, C] (float32 for a
    bfloat16 grid, else the grid's dtype)."""
    X, Y, Z, C = grid.shape
    sizes = torch.tensor([X, Y, Z], dtype=points.dtype, device=points.device)
    coords = ((points + 1.0) * sizes - 1.0) * 0.5
    base_f = torch.floor(coords)
    frac = coords - base_f
    base = base_f.to(torch.int64)
    flat_grid = grid.reshape(-1, C)

    out = torch.zeros((points.shape[0], C), dtype=torch.float32, device=points.device)
    for dx in (0, 1):
        wx = (1.0 - frac[:, 0]) if dx == 0 else frac[:, 0]
        ix = base[:, 0] + dx
        vx = (ix >= 0) & (ix < X)
        ixc = ix.clamp(0, X - 1)
        for dy in (0, 1):
            wy = (1.0 - frac[:, 1]) if dy == 0 else frac[:, 1]
            iy = base[:, 1] + dy
            vy = (iy >= 0) & (iy < Y)
            iyc = iy.clamp(0, Y - 1)
            for dz in (0, 1):
                wz = (1.0 - frac[:, 2]) if dz == 0 else frac[:, 2]
                iz = base[:, 2] + dz
                vz = (iz >= 0) & (iz < Z)
                izc = iz.clamp(0, Z - 1)
                weight = torch.where(vx & vy & vz, wx * wy * wz, torch.zeros((), device=points.device))
                corner = flat_grid.index_select(0, (ixc * Y + iyc) * Z + izc)
                out = out + weight.float()[:, None] * corner.float()
    return out if grid.dtype == torch.bfloat16 else out.to(grid.dtype)
