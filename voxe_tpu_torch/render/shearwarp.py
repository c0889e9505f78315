"""Shear-warp volumetric renderer, cubic one-trace path
(counterpart of voxe_tpu/render/shearwarp.py).

The volume is marched slice by slice along its principal axis; every
slice -> base-plane resample is separable, so it is two banded interpolation
matrices contracted with batched matmuls (cuBLAS here, as XLA's dots were on
the TPU). Compositing streams over slices: pass 1 resamples density only and
builds the Beer-Lambert weights with a triangular-matrix cumulative sum;
pass 2 shades and composites blocks of slices under
`torch.utils.checkpoint`, so the [N, S, C] radiance is never kept for the
backward. Gradients reach the grid through matmuls only.

What is ported: `render_shear_warp` for cubic grids (the trainers' case), on
the streamed path, one card. The marching branch is decided on the host from
the pose, which is the same arithmetic the JAX package does with a traced
permutation matrix and a traced `flip_k`. The non-cubic six-branch path, the
pose guards, density noise, the monolithic/fused-kernel path and the
attention/diffuse render modes of the refinement stage are not ported yet;
the first three raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from voxe_tpu_torch.grid.voxels import ACTIVATIONS, VoxelGrid
from voxe_tpu_torch.render.accumulate import RenderOut, safe_disparity
from voxe_tpu_torch.render.sh import evaluate_spherical_harmonics
from voxe_tpu_torch.utils.camera import CameraPose
from voxe_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DISPARITY,
    NUM_COLOUR_CHANNELS,
)

# the 3 marching-axis permutations: world axes (0, 1, 2) -> (a, b, k)
_PERMS = ((1, 2, 0), (2, 0, 1), (0, 1, 2))
# canonical_vec = _PERM_MATS_NP[axis] @ world_vec
_PERM_MATS_NP = [
    [[1.0 if _PERMS[axis][c] == w else 0.0 for w in range(3)] for c in range(3)]
    for axis in range(3)
]
# volume transposes that put the marching axis first: (k, a, b, C)
_VOLUME_PERMS = ((0, 1, 2, 3), (1, 2, 0, 3), (2, 0, 1, 3))
SLICE_BLOCK = 32  # slices per checkpointed shading block


class BaseImageGeometry(NamedTuple):
    eye: torch.Tensor  # [3] camera center (world)
    dirs: torch.Tensor  # [U*V, 3] unit ray dir per base pixel (world order)
    lo: torch.Tensor  # [2] base window lower corner (grid coords, a/b)
    hi: torch.Tensor  # [2]
    perm_index: int  # which of the 6 marching branches ran


def lane_aligned_res(n: int, tol: float = 0.10) -> int:
    """Round a base-lattice side to the nearest multiple of 128 when that
    changes it by <= `tol` (else return it unchanged). Kept for parity with
    the JAX package's default base lattice (400 -> 384)."""
    m = max(128, int(round(n / 128.0)) * 128)
    return m if abs(m - n) <= tol * n else n


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _principal_branch(view_dir) -> int:
    """view_dir [3] (world) -> branch index in [0, 6): axis * 2 + (dir > 0).
    Ties go to the lowest axis, as jnp.argmax breaks them."""
    vd = _host_f32(view_dir).reshape(3)
    axis = int(np.argmax(np.abs(vd)))
    return axis * 2 + int(vd[axis] > 0.0)


def _interp_matrices(src: torch.Tensor, size: int) -> torch.Tensor:
    """src [S, U] continuous grid coords -> [S, U, size] hat-function weights
    (linear interpolation with zero padding outside [0, size-1])."""
    p = torch.arange(size, dtype=src.dtype, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - p), min=0.0)


def _streamed_composite(
    vol: torch.Tensor,  # [S, A, B, C+1] pre-activated (features..., density)
    Wa: torch.Tensor,  # [S, U, A] f32 hat weights
    Wb: torch.Tensor,  # [S, V, B]
    t_sn: torch.Tensor,  # [S, N] depth of each slice crossing
    dirs: torch.Tensor,  # [N, 3] unit ray dirs (world order)
    inside_sn: torch.Tensor,  # [S, N] bool in-volume mask
    grid_config,
    white_bkgd: bool,
    flip_k: bool,
) -> RenderOut:
    """Slice-streamed resample + composite; every per-sample tensor is
    slice-major ([S, N] / [S, U, V, C]). With `flip_k` the s axis runs in
    volume order while marching runs s descending: the triangular matrix and
    the deltas flip instead of the volume."""
    S, A, B, C1 = vol.shape
    U, V = Wa.shape[1], Wb.shape[1]
    N = U * V
    dt = vol.dtype
    f_post = ACTIVATIONS[grid_config.feature_postactivation]
    d_post = ACTIVATIONS[grid_config.density_postactivation]
    Wa_dt, Wb_dt = Wa.to(dt), Wb.to(dt)

    # ---- pass 1: density-only resample -> weights. Matmuls in the volume
    # dtype accumulate in f32 (cuBLAS); a bf16 result is rounded once
    tmp_d = torch.bmm(Wa_dt, vol[..., -1])  # [S, U, B]
    dens_rs = torch.bmm(tmp_d, Wb_dt.transpose(1, 2)).float()  # [S, U, V]
    dens = d_post(dens_rs).reshape(S, N)
    dens = torch.where(inside_sn, dens, torch.zeros((), device=dens.device))

    dd = t_sn[1:] - t_sn[:-1]  # [S-1, N]
    if flip_k:
        deltas = -torch.cat([dd[:1], dd], dim=0)
    else:
        deltas = torch.cat([dd, dd[-1:]], dim=0)
    x = dens * deltas  # [S, N] optical thickness per sample
    ones_ss = torch.ones((S, S), dtype=torch.float32, device=x.device)
    tri = torch.tril(ones_ss) if flip_k else torch.triu(ones_ss)
    optical = tri.t() @ x  # "st,sn->tn": inclusive optical depth
    t_incl = torch.exp(-optical)
    t_excl = torch.exp(x - optical)
    weights = t_excl - t_incl  # [S, N]
    acc_render = 1.0 - (t_incl[:1] if flip_k else t_incl[-1:]).reshape(N, 1)

    # ---- pass 2: blockwise weighted shading
    feats_pre = vol[..., :-1]
    num_channels = NUM_COLOUR_CHANNELS if C1 > 2 else 1
    n_coeffs = (C1 - 1) // num_channels
    sh_degree = int(math.isqrt(n_coeffs)) - 1
    w_dt = weights.to(dt)
    dirs_b = dirs[None, :, :]
    zero = torch.zeros((), dtype=dt, device=vol.device)

    def shade_block(vol_b, Wa_b, Wb_b, w_b, in_b):
        Sb, Cf = vol_b.shape[0], vol_b.shape[-1]
        tmp = torch.bmm(Wa_b, vol_b.reshape(Sb, A, B * Cf)).reshape(Sb, U, B, Cf)
        res = torch.einsum("svb,subc->suvc", Wb_b, tmp)  # [Sb, U, V, Cf]
        feats = f_post(res).reshape(Sb, N, num_channels, n_coeffs)
        raw_rad = evaluate_spherical_harmonics(sh_degree, feats, dirs_b)  # [Sb, N, C]
        colour_b = torch.where(in_b[..., None], torch.sigmoid(raw_rad), zero)
        return (w_b.float()[..., None] * colour_b.float()).sum(0)  # f32 accumulation

    colour_render = torch.zeros((N, num_channels), dtype=torch.float32, device=vol.device)
    for start in range(0, S, SLICE_BLOCK):
        stop = min(S, start + SLICE_BLOCK)
        colour_render = colour_render + checkpoint(
            shade_block,
            feats_pre[start:stop], Wa_dt[start:stop], Wb_dt[start:stop],
            w_dt[start:stop], inside_sn[start:stop],
            use_reentrant=False,
        )
    if white_bkgd:
        colour_render = colour_render + (1.0 - acc_render)

    depth_render = torch.sum(t_sn * weights, dim=0).reshape(N, 1)
    extra = {
        EXTRA_DISPARITY: safe_disparity(depth_render, acc_render),
        EXTRA_ACCUMULATED_WEIGHTS: acc_render,
    }
    return RenderOut(colour=colour_render, depth=depth_render, extra=extra)


def _render_canonical(
    vol: torch.Tensor,  # [S, A, B, C+1] pre-activated, marching axis first
    eye_g: torch.Tensor,  # [3] eye in (a, b, k) grid coords; eye_k < 0
    voxel_sizes_g: torch.Tensor,  # [3] world units per voxel along (a, b, k)
    aabb_lo_g: torch.Tensor,  # [3] world coords of voxel center (0, 0, 0)
    base_hw: Tuple[int, int],
    config,
    grid_config,
    unpermute_mat: torch.Tensor,  # [3, 3], world = canonical @ M
    flip_k: bool,
):
    """Core shear-warp in canonical orientation (streamed branch). Returns
    (RenderOut over [U*V] base pixels, dirs, lo, hi)."""
    S, A, B, _ = vol.shape
    U, V = base_hw
    f, dev = torch.float32, vol.device

    e_a, e_b = eye_g[0], eye_g[1]
    # keep the eye strictly below slice 0 (only protects the math)
    e_k = torch.clamp(eye_g[2], max=-0.5)

    j = torch.arange(S, dtype=f, device=dev)
    tau = (j - e_k) / (0.0 - e_k)  # [S] >= 1

    a_corners = torch.tensor([0.0, A - 1.0], dtype=f, device=dev)
    b_corners = torch.tensor([0.0, B - 1.0], dtype=f, device=dev)
    far = tau[-1]
    a_proj = e_a + (a_corners - e_a) / far
    b_proj = e_b + (b_corners - e_b) / far
    lo = torch.stack(
        [torch.minimum(a_corners.min(), a_proj.min()),
         torch.minimum(b_corners.min(), b_proj.min())]
    )
    hi = torch.stack(
        [torch.maximum(a_corners.max(), a_proj.max()),
         torch.maximum(b_corners.max(), b_proj.max())]
    )

    alpha = lo[0] + (torch.arange(U, dtype=f, device=dev) + 0.5) * (hi[0] - lo[0]) / U
    beta = lo[1] + (torch.arange(V, dtype=f, device=dev) + 0.5) * (hi[1] - lo[1]) / V

    tau_o = tau.flip(0) if flip_k else tau  # slice-index order of `vol`
    src_a = e_a + (alpha[None, :] - e_a) * tau_o[:, None]  # [S, U]
    src_b = e_b + (beta[None, :] - e_b) * tau_o[:, None]  # [S, V]
    Wa = _interp_matrices(src_a, A)
    Wb = _interp_matrices(src_b, B)

    w_a, w_b, w_k = voxel_sizes_g[0], voxel_sizes_g[1], voxel_sizes_g[2]
    pa = aabb_lo_g[0] + alpha * w_a
    pb = aabb_lo_g[1] + beta * w_b
    eye_w = torch.stack(
        [aabb_lo_g[0] + e_a * w_a, aabb_lo_g[1] + e_b * w_b, aabb_lo_g[2] + e_k * w_k]
    )
    va = (pa[:, None] - eye_w[0]).expand(U, V)
    vb = (pb[None, :] - eye_w[1]).expand(U, V)
    vk = (aabb_lo_g[2] - eye_w[2]).expand(U, V)
    v = torch.stack([va, vb, vk], dim=-1).reshape(U * V, 3)
    v_norm = torch.linalg.norm(v, dim=-1)
    dirs = (v / v_norm[:, None]) @ unpermute_mat  # world component order

    in_a = (src_a >= -0.5) & (src_a <= A - 0.5)
    in_b = (src_b >= -0.5) & (src_b <= B - 0.5)
    inside_sn = (in_a[:, :, None] & in_b[:, None, :]).reshape(S, U * V)
    t_sn = tau_o[:, None] * v_norm[None, :]
    out = _streamed_composite(
        vol, Wa, Wb, t_sn, dirs, inside_sn, grid_config, config.white_bkgd, flip_k
    )
    return out, dirs, lo, hi


def render_shear_warp(
    voxel_grid: VoxelGrid,
    pose: CameraPose,
    config,
    base_hw: Tuple[int, int] = (256, 256),
) -> Tuple[RenderOut, BaseImageGeometry]:
    """Render the base-plane image of a cubic `voxel_grid` seen from `pose`.

    Returns (RenderOut with [U*V, ...] leaves, BaseImageGeometry). The grid's
    tensors may require grad; gradients flow through matmuls only."""
    if getattr(config, "use_fused_kernel", False):
        raise NotImplementedError("the fused compositing kernel is not ported yet")
    if getattr(config, "stochastic_density_noise_std", 0.0) > 0.0:
        raise NotImplementedError("stochastic density noise is not ported yet")
    grid_dims = tuple(int(d) for d in voxel_grid.grid_dims)
    if len(set(grid_dims)) != 1:
        raise NotImplementedError("only cubic grids are ported (six-branch path waits)")

    cfg = voxel_grid.config
    pre_density = ACTIVATIONS[cfg.density_preactivation](
        voxel_grid.densities * cfg.expected_density_scale
    )
    pre_features = ACTIVATIONS[cfg.feature_preactivation](voxel_grid.features)
    unified = torch.cat([pre_features, pre_density], dim=-1)
    if cfg.gather_dtype == "bfloat16":
        unified = unified.to(torch.bfloat16)
    dev = unified.device

    def vec(values):
        return torch.tensor(list(values), dtype=torch.float32, device=dev)

    dims = vec(grid_dims)
    vsizes = vec(cfg.voxel_size)
    aabb_lo = vec(cfg.grid_location) - (dims - 1.0) / 2.0 * vsizes
    eye_w = torch.as_tensor(pose.translation, dtype=torch.float32, device=dev).reshape(3)
    rot = torch.as_tensor(pose.rotation, dtype=torch.float32, device=dev)

    branch = _principal_branch(-rot[:, 2])
    axis, positive = branch // 2, branch % 2 == 1
    M = torch.tensor(_PERM_MATS_NP[axis], dtype=torch.float32, device=dev)
    vs = M @ vsizes
    lo3 = M @ aabb_lo
    if not positive:  # march toward -k: far face becomes the origin
        S_k = float(grid_dims[0])
        lo3 = torch.stack([lo3[0], lo3[1], lo3[2] + (S_k - 1.0) * vs[2]])
        vs = torch.stack([vs[0], vs[1], -vs[2]])
    eye_g = (M @ eye_w - lo3) / vs
    volp = unified.permute(*_VOLUME_PERMS[axis]).contiguous()

    out, dirs_w, lo2, hi2 = _render_canonical(
        volp, eye_g, vs, lo3, base_hw, config, cfg, unpermute_mat=M, flip_k=not positive
    )
    geom = BaseImageGeometry(eye=eye_w, dirs=dirs_w, lo=lo2, hi=hi2, perm_index=branch)
    return out, geom


def orient_base_image(img: torch.Tensor, rotation) -> torch.Tensor:
    """Orient a base-plane image ([U, V, C] or [U, V]) to the camera's
    up/right frame with a transpose and flips only (differentiable). Rows
    run down the camera's -up, columns along camera right; non-square
    images only flip."""
    U, V = img.shape[0], img.shape[1]
    rot = _host_f32(rotation)
    branch = _principal_branch(-rot[:, 2])
    a_ax, b_ax, _ = _PERMS[branch // 2]
    right, up = rot[:, 0], rot[:, 1]
    a_r, b_r = right[a_ax], right[b_ax]
    a_u, b_u = up[a_ax], up[b_ax]
    if U == V:
        do_t = abs(a_r) > abs(b_r)  # row axis more horizontal: transpose
        if do_t:
            img = img.transpose(0, 1)
        row_up = b_u if do_t else a_u
        col_right = a_r if do_t else b_r
    else:
        row_up, col_right = a_u, b_r
    if row_up > 0:
        img = img.flip(0)
    if col_right < 0:
        img = img.flip(1)
    return img
