"""Plain shear-warp render of an SH-degree-0 voxel grid, in float32.

The volume is marched slice by slice along the axis the view is most
nearly parallel to; each slice is resampled onto the base-plane lattice by
two separable hat-function (linear interpolation) matrices, and the samples
are composited front to back with Beer-Lambert weights, the last interval
repeating the slice spacing ("slab"). One tail serves every caller: the
colour render, the attention render (the attention channels shaded in
place of the colour) and the recon targets' warp onto the base lattice.
`q` rounds what the configuration keeps in bfloat16 (the resample table,
the resample matrices and the resampled values, the weights and colours of
the weighted sum, and the gradients their products take back): float32
leaves them alone, the control rounds them to float8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Rounding

ACT = {"identity": lambda x: x, "relu": F.relu, "abs": torch.abs, "softplus": F.softplus, "sigmoid": torch.sigmoid}
C0 = 0.28209479177387814  # the degree-0 real spherical harmonic
# marching axis -> the world axes taken as (a, b, k)
PERMS = ((1, 2, 0), (2, 0, 1), (0, 1, 2))
VOLUME_PERMS = ((0, 1, 2, 3), (1, 2, 0, 3), (2, 0, 1, 3))


@dataclass(frozen=True)
class GridSpec:
    """A cubic grid of `res`^3 voxels spanning `world_size` in each axis,
    centred on the origin."""

    res: int
    world_size: float
    density_preactivation: str
    density_postactivation: str
    feature_preactivation: str = "identity"
    feature_postactivation: str = "identity"

    @staticmethod
    def from_config(grid: dict) -> "GridSpec":
        return GridSpec(
            int(grid["res"]), float(grid["world_size"]), grid["density_preactivation"],
            grid["density_postactivation"], grid.get("feature_preactivation", "identity"),
            grid.get("feature_postactivation", "identity"),
        )

    @property
    def voxel(self) -> float:
        return self.world_size / self.res

    @property
    def density_scale(self) -> float:
        """The reference Vox-E's expected density scale of a ReLU-field grid:
        (sqrt(27) * 100 / diagonal) / 3."""
        diagonal = math.sqrt(3.0 * self.world_size**2)
        return (math.sqrt(27.0) * 100.0 / diagonal) / 3.0


def _branch(rotation) -> Tuple[int, bool]:
    view = -np.asarray(torch.as_tensor(rotation).detach().cpu(), np.float32)[:, 2]
    axis = int(np.argmax(np.abs(view)))
    return axis, bool(view[axis] > 0.0)


def render(
    densities: torch.Tensor,  # [X, Y, Z, 1]
    channels: torch.Tensor,  # [X, Y, Z, C]: colour (degree-0 SH) or attention logits
    spec: GridSpec,
    rotation: torch.Tensor,  # [3, 3] camera to world
    translation: torch.Tensor,  # [3] or [3, 1]
    base_hw: Tuple[int, int],
    q: Rounding,
    background: float,
) -> torch.Tensor:
    """The base-plane image [U * V, C] of the grid, composited onto
    `background` (white background)."""
    dev = densities.device
    res = spec.res
    pre_d = ACT[spec.density_preactivation](densities * spec.density_scale)
    pre_f = ACT[spec.feature_preactivation](channels)
    table = q(torch.cat([pre_f, pre_d], dim=-1))
    C = channels.shape[-1]

    axis, positive = _branch(rotation)
    perm = PERMS[axis]
    vs = torch.full((3,), spec.voxel, dtype=torch.float32, device=dev)
    lo3 = torch.full((3,), -(res - 1) / 2.0 * spec.voxel, dtype=torch.float32, device=dev)
    if not positive:  # march toward -k: the far face becomes the origin
        lo3 = torch.stack([lo3[0], lo3[1], lo3[2] + (res - 1.0) * vs[2]])
        vs = torch.stack([vs[0], vs[1], -vs[2]])
    eye_w = torch.as_tensor(translation, dtype=torch.float32, device=dev).reshape(3)
    eye_g = (eye_w[list(perm)] - lo3) / vs
    vol = table.permute(*VOLUME_PERMS[axis])
    if not positive:
        vol = vol.flip(0)
    S, A, B, C1 = vol.shape
    U, V = base_hw

    e_a, e_b = eye_g[0], eye_g[1]
    e_k = torch.clamp(eye_g[2], max=-0.5)
    tau = (torch.arange(S, dtype=torch.float32, device=dev) - e_k) / (0.0 - e_k)
    a_c = torch.tensor([0.0, A - 1.0], device=dev)
    b_c = torch.tensor([0.0, B - 1.0], device=dev)
    a_p = e_a + (a_c - e_a) / tau[-1]
    b_p = e_b + (b_c - e_b) / tau[-1]
    lo = torch.stack([torch.minimum(a_c.min(), a_p.min()), torch.minimum(b_c.min(), b_p.min())])
    hi = torch.stack([torch.maximum(a_c.max(), a_p.max()), torch.maximum(b_c.max(), b_p.max())])
    alpha = lo[0] + (torch.arange(U, dtype=torch.float32, device=dev) + 0.5) * (hi[0] - lo[0]) / U
    beta = lo[1] + (torch.arange(V, dtype=torch.float32, device=dev) + 0.5) * (hi[1] - lo[1]) / V
    src_a = e_a + (alpha[None] - e_a) * tau[:, None]  # [S, U]
    src_b = e_b + (beta[None] - e_b) * tau[:, None]  # [S, V]
    Wa = torch.clamp(1.0 - (src_a[..., None] - torch.arange(A, device=dev)).abs(), min=0.0)  # [S, U, A]
    Wb = torch.clamp(1.0 - (src_b[..., None] - torch.arange(B, device=dev)).abs(), min=0.0)  # [S, V, B]

    # ray lengths to each slice crossing
    pa = lo3[0] + alpha * vs[0]
    pb = lo3[1] + beta * vs[1]
    eye_c = lo3 + torch.stack([e_a, e_b, e_k]) * vs
    v = torch.stack([
        (pa[:, None] - eye_c[0]).expand(U, V), (pb[None, :] - eye_c[1]).expand(U, V),
        (lo3[2] - eye_c[2]).expand(U, V),
    ], dim=-1).reshape(U * V, 3)
    depth = torch.linalg.norm(v, dim=-1)[:, None] * tau[None, :]  # [N, S]
    inside = (((src_a >= -0.5) & (src_a <= A - 0.5))[:, :, None] & ((src_b >= -0.5) & (src_b <= B - 0.5))[:, None, :])
    inside = inside.permute(1, 2, 0).reshape(U * V, S)

    tmp = q.grads(torch.bmm(q(Wa), q(vol.reshape(S, A, B * C1)))).reshape(S, U, B, C1)
    resampled = q(q.grads(torch.einsum("svb,subc->suvc", q(Wb), q(tmp))))  # [S, U, V, C+1]
    resampled = resampled.permute(1, 2, 0, 3).reshape(U * V, S, C1)
    sigma = torch.where(inside, ACT[spec.density_postactivation](resampled[..., -1]), torch.zeros((), device=dev))
    colour = torch.sigmoid(C0 * ACT[spec.feature_postactivation](resampled[..., :C]))
    colour = torch.where(inside[..., None], colour, torch.zeros((), device=dev))

    deltas = depth[:, 1:] - depth[:, :-1]
    deltas = torch.cat([deltas, deltas[:, -1:]], dim=-1)
    optical = torch.cumsum(sigma * deltas, dim=-1)
    t_incl = torch.exp(-optical)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=-1)
    weights = t_excl - t_incl
    out = q.grads(torch.einsum("ns,nsc->nc", q(weights), q(colour)))
    return out + (t_incl[:, -1:]) * background


def orient(img: torch.Tensor, rotation) -> torch.Tensor:
    """A square base image [U, U, ...] turned to the camera's frame (rows
    down the camera's -up, columns along its right) by a transpose and
    flips."""
    rot = np.asarray(torch.as_tensor(rotation).detach().cpu(), np.float32)
    axis, _ = _branch(rotation)
    a_ax, b_ax, _ = PERMS[axis]
    right, up = rot[:, 0], rot[:, 1]
    transpose = abs(right[a_ax]) > abs(right[b_ax])
    if transpose:
        img = img.transpose(0, 1)
    row_up = up[b_ax] if transpose else up[a_ax]
    col_right = right[a_ax] if transpose else right[b_ax]
    if row_up > 0:
        img = img.flip(0)
    if col_right < 0:
        img = img.flip(1)
    return img


def pose_from_angles(pitch_deg: torch.Tensor, yaw_deg: torch.Tensor, radius: float):
    """Camera-to-world (rotation [3, 3], translation [3, 1]) of a hemisphere
    camera: yaw about z after pitch about x, `radius` along the camera's z."""
    p, y = pitch_deg * (math.pi / 180.0), yaw_deg * (math.pi / 180.0)
    cp, sp, cy, sy = torch.cos(p), torch.sin(p), torch.cos(y), torch.sin(y)
    one, zero = torch.ones_like(cp), torch.zeros_like(cp)
    rp = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cp, -sp]), torch.stack([zero, sp, cp])])
    ry = torch.stack([torch.stack([cy, -sy, zero]), torch.stack([sy, cy, zero]), torch.stack([zero, zero, one])])
    rotation = ry @ rp
    return rotation, rotation @ torch.tensor([[0.0], [0.0], [radius]], device=rotation.device)


def direction_index(pitch_deg: float, yaw_deg: float) -> int:
    """The prompt's view word: 0 side, 1 overhead, 2 back, 3 front."""
    idx = 3
    if 45.0 < yaw_deg < 315.0:
        idx = 0
    if 120.0 < yaw_deg < 240.0:
        idx = 2
    if pitch_deg < 25.0:
        idx = 1
    return idx


def warp_to_base(image: torch.Tensor, rotation: np.ndarray, translation: np.ndarray, focal: float,
                 spec: GridSpec, base_hw: Tuple[int, int]):
    """A screen image [H, W, 3] splatted onto its pose's base lattice with
    bilinear weights: (target [U, V, 3], coverage mask [U, V])."""
    H, W = image.shape[:2]
    U, V = base_hw
    res, vox = spec.res, spec.voxel
    rot = np.asarray(rotation, np.float64)
    eye = np.asarray(translation, np.float64).reshape(3)
    axis, positive = _branch(torch.as_tensor(rotation))
    perm = list(PERMS[axis])
    vs = np.full(3, vox)
    lo3 = np.full(3, -(res - 1) / 2.0 * vox)
    if not positive:
        lo3[2] += (res - 1.0) * vs[2]
        vs[2] = -vs[2]
    eye_g = (eye[perm] - lo3) / vs
    e_k = min(eye_g[2], -0.5)
    far = (res - 1.0 - e_k) / (0.0 - e_k)
    corners = np.array([0.0, res - 1.0])
    a_p = eye_g[0] + (corners - eye_g[0]) / far
    b_p = eye_g[1] + (corners - eye_g[1]) / far
    lo = np.array([min(corners.min(), a_p.min()), min(corners.min(), b_p.min())], np.float32)
    hi = np.array([max(corners.max(), a_p.max()), max(corners.max(), b_p.max())], np.float32)

    # pinhole rays through the pixel centres, camera looking down -z, +y up
    x, y = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    d_cam = np.stack([(x - W * 0.5) / focal, -(y - H * 0.5) / focal, -np.ones_like(x)], -1).reshape(-1, 3)
    d = (d_cam @ rot.T)[:, perm] / vs
    o = (eye[perm] - lo3) / vs
    t = (0.0 - o[2]) / d[:, 2]
    a0, b0 = o[0] + t * d[:, 0], o[1] + t * d[:, 1]
    ui = (a0 - lo[0]) / (hi[0] - lo[0]) * U - 0.5
    vi = (b0 - lo[1]) / (hi[1] - lo[1]) * V - 0.5
    ui = np.where(t <= 0.0, -10.0, ui)
    vi = np.where(t <= 0.0, -10.0, vi)

    dev = image.device
    ui = torch.as_tensor(ui, dtype=torch.float32, device=dev)
    vi = torch.as_tensor(vi, dtype=torch.float32, device=dev)
    px = image.reshape(-1, 3).float()
    u0, v0 = torch.floor(ui).long(), torch.floor(vi).long()
    acc = torch.zeros((U * V, 3), device=dev)
    wsum = torch.zeros((U * V,), device=dev)
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0 + du, v0 + dv
            w = torch.clamp(1.0 - (ui - uu).abs(), min=0.0) * torch.clamp(1.0 - (vi - vv).abs(), min=0.0)
            w = torch.where((uu >= 0) & (uu < U) & (vv >= 0) & (vv < V), w, torch.zeros((), device=dev))
            flat = uu.clamp(0, U - 1) * V + vv.clamp(0, V - 1)
            acc.index_add_(0, flat, w[:, None] * px)
            wsum.index_add_(0, flat, w)
    target = acc / torch.clamp(wsum, min=1e-8)[:, None]
    return target.reshape(U, V, 3), (wsum > 1e-6).reshape(U, V).float()
