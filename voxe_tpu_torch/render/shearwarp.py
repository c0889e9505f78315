"""Shear-warp volumetric renderer (counterpart of
voxe_tpu/render/shearwarp.py).

The volume is marched slice by slice along its principal axis; every
slice -> base-plane resample is separable, so it is two banded interpolation
matrices contracted with batched matmuls (cuBLAS here, as XLA's dots were on
the TPU). Two compositing tails, as in the JAX package:

- streamed (the default): pass 1 resamples density only and builds the
  Beer-Lambert weights with a triangular-matrix cumulative sum; pass 2 shades
  and composites blocks of slices under `torch.utils.checkpoint`, so the
  [N, S, C] radiance is never kept for the backward;
- monolithic (with `config.use_fused_kernel`): every slice is resampled into one
  [U*V, S, C+1] tensor, shaded, and composited by
  `accumulate_radiance_density_on_rays(final_delta="slab")` — through the
  hand-written compositing kernel when the config asks for it.

The marching branch (axis and direction) is picked on the host from the
pose, which is the arithmetic the JAX package does with a traced
permutation (cubic grids) or a six-way switch (any grid); one code path
serves every grid shape. On the streamed tail negative branches reverse the
[S]-row matrices (`flip_k`); on the monolithic tail they reverse the volume
with `.flip(0)`, as the JAX static branches do. Gradients reach the grid
through matmuls only. Host-side helpers: the pose guards, the base-window
geometry, `screen_to_base` and the target warp `warp_image_to_base`.

`diffuse_only` shades the colour as the degree-0 (diffuse) version, and
`background_value` is what an empty ray composites onto with white_bkgd.
`attn_mode` renders the grid's attention field in place of the colour: its
C channels, each shaded at degree 0, composite against the density field
(the frozen copy with `use_orig_densities`) on both tails, so the
refinement stage's edit and object grids render as one two-channel pass.
`render_shear_warp_to_screen` finishes the factorization for screen-space
output: the base composite, then a bilinear gather at each screen pixel's
base coordinates (`sample_base_image`).

With a `mesh` (voxe_tpu_torch.parallel) each rank renders only its share of
the base rows u: `_render_canonical` takes its rows of the row resample
matrices `Wa`, of the ray directions, masks and density noise before either
composite, so both composites (and the compositing kernel) see rows_local x V
rays and need no mesh of their own. The render returns the rank's rows; a
caller that needs the whole image gathers them with `gather_axis`. The JAX
package constrains the same rows to the mesh (`shard_axis`) and lets GSPMD
split the work. With a bf16 table (`gather_dtype="bfloat16"`) the mesh path
keeps the table f32 and casts it inside the row resample
(`_BF16RowResample`), whose backward contracts this rank's rows in f32: the
rank's share of the table's gradient then enters the f32 all-reduce
unrounded, as GSPMD sums the f32 partial products before the bf16 rounding.
Without a mesh, or on a mesh of one rank (which holds every row), the
table is cast once and its gradient is bf16, as in JAX.

Density noise (`config.stochastic_density_noise_std > 0`) adds std times one
standard-normal draw per sample to the masked density, before the weights:
an [N, S] draw in marching order, from a `torch.Generator` or passed in as
`density_noise`, which both tails read the same way (the streamed tail
reverses it into volume order under `flip_k`), and which the diffuse
composite shares, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from voxe_tpu_torch.grid.voxels import ACTIVATIONS, VoxelGrid
from voxe_tpu_torch.parallel.mesh import shard_axis
from voxe_tpu_torch.render.accumulate import (
    RenderOut,
    accumulate_radiance_density_on_rays,
    safe_disparity,
)
from voxe_tpu_torch.render.rays import Rays, cast_rays
from voxe_tpu_torch.render.sh import evaluate_spherical_harmonics
from voxe_tpu_torch.utils.camera import CameraIntrinsics, CameraPose
from voxe_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DISPARITY,
    INFINITY,
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
    dirs: Optional[torch.Tensor]  # [U*V, 3] unit ray dir per base pixel (world order); None from compute_base_geometry
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


def _shade_channels(c1: int, num_shade_channels: Optional[int]) -> int:
    """Shaded channels of a [..., C+1] volume: the attention field's count
    when given, else 3 colour channels (1 for a one-feature volume)."""
    if num_shade_channels is not None:
        return num_shade_channels
    return NUM_COLOUR_CHANNELS if c1 > 2 else 1


class _BF16RowResample(torch.autograd.Function):
    """bmm(Wa, x.to(bf16)) for an f32 `x` (the mesh path's table): the same
    forward as a bf16 table, and a backward that contracts this rank's rows
    of `Wa` in f32 and returns an f32 gradient, where autograd through the
    cast would round the rank's partial sum to bf16 before the all-reduce."""

    @staticmethod
    def forward(ctx, Wa, x):
        ctx.save_for_backward(Wa)
        return torch.bmm(Wa, x.to(Wa.dtype))

    @staticmethod
    def backward(ctx, grad):
        (Wa,) = ctx.saved_tensors
        return None, torch.bmm(Wa.transpose(1, 2).float(), grad.float())


def _resample_rows(Wa: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[S, U, A] @ [S, A, K] in Wa's dtype (the table dtype)."""
    if x.dtype == Wa.dtype:
        return torch.bmm(Wa, x)
    return _BF16RowResample.apply(Wa, x)


def _table(unified: torch.Tensor, gather_dtype: str, mesh) -> torch.Tensor:
    """The resample table: cast to bf16 once under a bf16 table, unless a
    mesh of 2 or more ranks splits its rows, whose resample casts it
    (`_resample_rows`). A one-rank mesh holds every row: its sum is the
    whole sum."""
    if gather_dtype == "bfloat16" and (mesh is None or mesh.size == 1):
        return unified.to(torch.bfloat16)
    return unified


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
    with_diffuse: bool = False,
    background_value: float = 1.0,
    diffuse_only: bool = False,
    num_shade_channels: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Slice-streamed resample + composite; every per-sample tensor is
    slice-major ([S, N] / [S, U, V, C]). With `flip_k` the s axis runs in
    volume order while marching runs s descending: the triangular matrix and
    the deltas flip instead of the volume. `with_diffuse` also composites the
    degree-0 (diffuse) shading into extra["diffuse_colour"]; `diffuse_only`
    shades the colour itself at degree 0. `num_shade_channels` overrides the
    channel count (the attention field's C; 3 or 1 by default). `noise`
    ([N, S] in marching order, scaled) is added to the masked density.
    The resample runs in the table's dtype; an f32 `vol` under a bf16 table
    is the mesh path's (`_table`, `_resample_rows`)."""
    S, A, B, C1 = vol.shape
    U, V = Wa.shape[1], Wb.shape[1]
    N = U * V
    dt = torch.bfloat16 if grid_config.gather_dtype == "bfloat16" else vol.dtype
    f_post = ACTIVATIONS[grid_config.feature_postactivation]
    d_post = ACTIVATIONS[grid_config.density_postactivation]
    Wa_dt, Wb_dt = Wa.to(dt), Wb.to(dt)

    # ---- pass 1: density-only resample -> weights. Matmuls in the volume
    # dtype accumulate in f32 (cuBLAS); a bf16 result is rounded once
    tmp_d = _resample_rows(Wa_dt, vol[..., -1])  # [S, U, B]
    dens_rs = torch.bmm(tmp_d, Wb_dt.transpose(1, 2)).float()  # [S, U, V]
    dens = d_post(dens_rs).reshape(S, N)
    dens = torch.where(inside_sn, dens, torch.zeros((), device=dens.device))
    if noise is not None:  # after the mask, as the exact path noises in accumulate
        dens = dens + (noise.flip(1) if flip_k else noise).t()

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
    num_channels = _shade_channels(C1, num_shade_channels)
    n_coeffs = (C1 - 1) // num_channels
    sh_degree = int(math.isqrt(n_coeffs)) - 1
    w_dt = weights.to(dt)
    dirs_b = dirs[None, :, :]
    zero = torch.zeros((), dtype=dt, device=vol.device)

    def composite(w_b, raw_rad, in_b):
        colour_b = torch.where(in_b[..., None], torch.sigmoid(raw_rad), zero)
        return (w_b.float()[..., None] * colour_b.float()).sum(0)  # f32 accumulation

    def shade_block(vol_b, Wa_b, Wb_b, w_b, in_b):
        Sb, Cf = vol_b.shape[0], vol_b.shape[-1]
        tmp = _resample_rows(Wa_b, vol_b.reshape(Sb, A, B * Cf)).reshape(Sb, U, B, Cf)
        res = torch.einsum("svb,subc->suvc", Wb_b, tmp)  # [Sb, U, V, Cf]
        feats = f_post(res).reshape(Sb, N, num_channels, n_coeffs)
        degree, coeffs = (0, feats[..., :1]) if diffuse_only else (sh_degree, feats)
        raw_rad = evaluate_spherical_harmonics(degree, coeffs, dirs_b)  # [Sb, N, C]
        out = composite(w_b, raw_rad, in_b)
        if not with_diffuse:
            return out, out.new_zeros(())
        if sh_degree == 0:  # degree 0 is the diffuse shading already
            return out, out
        diff = evaluate_spherical_harmonics(0, feats[..., :1], dirs_b)
        return out, composite(w_b, diff, in_b)

    colour_render = torch.zeros((N, num_channels), dtype=torch.float32, device=vol.device)
    diffuse_render = torch.zeros_like(colour_render)
    for start in range(0, S, SLICE_BLOCK):
        stop = min(S, start + SLICE_BLOCK)
        c_b, d_b = checkpoint(
            shade_block,
            feats_pre[start:stop], Wa_dt[start:stop], Wb_dt[start:stop],
            w_dt[start:stop], inside_sn[start:stop],
            use_reentrant=False,
        )
        colour_render = colour_render + c_b
        diffuse_render = diffuse_render + d_b
    if white_bkgd:
        bg = (1.0 - acc_render) * background_value
        colour_render = colour_render + bg
        diffuse_render = diffuse_render + bg

    depth_render = torch.sum(t_sn * weights, dim=0).reshape(N, 1)
    extra = {
        EXTRA_DISPARITY: safe_disparity(depth_render, acc_render),
        EXTRA_ACCUMULATED_WEIGHTS: acc_render,
    }
    if with_diffuse:
        extra["diffuse_colour"] = diffuse_render
    return RenderOut(colour=colour_render, depth=depth_render, extra=extra)


def _monolithic_composite(
    vol: torch.Tensor,  # [S, A, B, C+1] pre-activated, marching order
    Wa: torch.Tensor,  # [S, U, A]
    Wb: torch.Tensor,  # [S, V, B]
    t_slices: torch.Tensor,  # [N, S] depth of each slice crossing
    dirs: torch.Tensor,  # [N, 3] unit ray dirs (world order)
    eye_w: torch.Tensor,  # [3]
    inside: torch.Tensor,  # [N, S] bool in-volume mask
    config,
    grid_config,
    with_diffuse: bool,
    background_value: float = 1.0,
    diffuse_only: bool = False,
    num_shade_channels: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Resample every slice onto the base lattice ([U*V, S, C+1]), shade,
    and composite with accumulate(final_delta="slab"), through the fused
    kernel when `config.use_fused_kernel`. The density stays f32 through the
    weights math; the radiance stays in the volume dtype. `noise` ([N, S],
    scaled) is added to the masked density that both composites read.
    The resample's dtype as in `_streamed_composite`."""
    S, A, B, C1 = vol.shape
    U, V = Wa.shape[1], Wb.shape[1]
    N = U * V
    dt = torch.bfloat16 if grid_config.gather_dtype == "bfloat16" else vol.dtype
    tmp = _resample_rows(Wa.to(dt), vol.reshape(S, A, B * C1)).reshape(S, U, B, C1)
    res = torch.einsum("svb,subc->suvc", Wb.to(dt), tmp)  # [S, U, V, C+1]
    resampled = res.permute(1, 2, 0, 3).reshape(N, S, C1)
    feats = ACTIVATIONS[grid_config.feature_postactivation](resampled[..., :-1])
    dens = ACTIVATIONS[grid_config.density_postactivation](resampled[..., -1].float())
    dens = torch.where(inside, dens, torch.zeros((), device=dens.device))
    if noise is not None:
        dens = dens + noise

    num_channels = _shade_channels(C1, num_shade_channels)
    sh_coeffs = feats.reshape(N, S, num_channels, -1)
    sh_degree = int(math.isqrt(sh_coeffs.shape[-1])) - 1
    if diffuse_only:  # shade the colour as the degree-0 diffuse version
        sh_degree, sh_coeffs = 0, sh_coeffs[..., :1]
    rays_c = Rays(origins=eye_w.expand(N, 3), directions=dirs)

    def tail(degree, coeffs):
        raw_radiance = evaluate_spherical_harmonics(degree, coeffs, dirs[:, None, :])
        raw_radiance = torch.where(
            inside[..., None], raw_radiance, torch.full((), -INFINITY, dtype=raw_radiance.dtype, device=dens.device)
        )
        return accumulate_radiance_density_on_rays(
            (raw_radiance, dens), t_slices, rays_c,
            white_bkgd=config.white_bkgd, background_value=background_value,
            final_delta="slab", use_fused_kernel=getattr(config, "use_fused_kernel", False),
        )

    out = tail(sh_degree, sh_coeffs)
    if with_diffuse:
        out_diff = tail(0, sh_coeffs[..., :1])
        out = RenderOut(out.colour, out.depth, {**out.extra, "diffuse_colour": out_diff.colour})
    return out


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
    with_diffuse: bool = False,
    stream_composite: bool = True,
    background_value: float = 1.0,
    diffuse_only: bool = False,
    num_shade_channels: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
    mesh=None,
):
    """Core shear-warp in canonical orientation. Returns (RenderOut over
    [U*V] base pixels, dirs [U*V, 3], lo, hi). With `mesh` the RenderOut
    covers this rank's base rows only (`noise` is the whole [U*V, S] draw)."""
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
    dirs_all = dirs
    if mesh is not None:  # this rank's base rows u: DP over the rows, as JAX shards them
        Wa, in_a = shard_axis(mesh, Wa, 1), shard_axis(mesh, in_a, 1)
        U = Wa.shape[1]
        dirs = shard_axis(mesh, dirs.reshape(-1, V, 3), 0).reshape(U * V, 3)
        v_norm = shard_axis(mesh, v_norm.reshape(-1, V), 0).reshape(U * V)
        if noise is not None:
            noise = shard_axis(mesh, noise.reshape(-1, V, noise.shape[-1]), 0).reshape(U * V, -1)
    if stream_composite:
        inside_sn = (in_a[:, :, None] & in_b[:, None, :]).reshape(S, U * V)
        t_sn = tau_o[:, None] * v_norm[None, :]
        out = _streamed_composite(
            vol, Wa, Wb, t_sn, dirs, inside_sn, grid_config, config.white_bkgd, flip_k,
            with_diffuse=with_diffuse, background_value=background_value, diffuse_only=diffuse_only,
            num_shade_channels=num_shade_channels, noise=noise,
        )
    else:
        inside = (in_a[:, :, None] & in_b[:, None, :]).permute(1, 2, 0).reshape(U * V, S)
        t_slices = v_norm[:, None] * tau_o[None, :]
        out = _monolithic_composite(
            vol, Wa, Wb, t_slices, dirs, eye_w, inside, config, grid_config, with_diffuse,
            background_value=background_value, diffuse_only=diffuse_only,
            num_shade_channels=num_shade_channels, noise=noise,
        )
    return out, dirs_all, lo, hi


def render_shear_warp(
    voxel_grid: VoxelGrid,
    pose: CameraPose,
    config,
    base_hw: Tuple[int, int] = (256, 256),
    with_diffuse: bool = False,
    background_value: float = 1.0,
    diffuse_only: bool = False,
    attn_mode: bool = False,
    use_orig_densities: bool = False,
    generator: Optional[torch.Generator] = None,
    density_noise: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[RenderOut, BaseImageGeometry]:
    """Render the base-plane image of `voxel_grid` seen from `pose`.

    Returns (RenderOut with [U*V, ...] leaves, BaseImageGeometry). The grid's
    tensors may require grad; gradients flow through matmuls only.
    `with_diffuse` also renders the degree-0 shading into
    extra["diffuse_colour"] from the same resample; `diffuse_only` renders
    the degree-0 shading as the colour. With `config.white_bkgd`, empty rays
    composite onto `background_value`. `config.use_fused_kernel` selects the
    monolithic tail, where the compositing kernel lives. `attn_mode` renders
    the attention field's C channels (each at degree 0) as the colour, over
    the frozen densities with `use_orig_densities`; the refinement stage
    passes `background_value=0.0`. With `config.stochastic_density_noise_std
    > 0` the density noise is `density_noise` ([U*V, S] standard normals in
    marching order) or a draw from `generator`. With `mesh` the RenderOut
    holds this rank's rows of the base image ([rows_local*V, ...]; the noise
    is still drawn for the whole image, so every rank draws the same)."""
    if with_diffuse and diffuse_only:
        raise ValueError("with_diffuse renders both colours; diffuse_only renders the degree-0 one as the colour")
    stream_composite = not getattr(config, "use_fused_kernel", False)
    noise_std = getattr(config, "stochastic_density_noise_std", 0.0)
    grid_dims = tuple(int(d) for d in voxel_grid.grid_dims)

    cfg = voxel_grid.config
    densities, features, num_shade_channels = voxel_grid.densities, voxel_grid.features, None
    if attn_mode:
        if voxel_grid.attn is None:
            raise ValueError("attn_mode: grid has no attn channel")
        if use_orig_densities:
            if voxel_grid.orig_densities is None:
                raise ValueError("use_orig_densities: grid has no frozen orig_densities")
            densities = voxel_grid.orig_densities
        features, num_shade_channels = voxel_grid.attn, int(voxel_grid.attn.shape[-1])
    pre_density = ACTIVATIONS[cfg.density_preactivation](densities * cfg.expected_density_scale)
    pre_features = ACTIVATIONS[cfg.feature_preactivation](features)
    unified = _table(torch.cat([pre_features, pre_density], dim=-1), cfg.gather_dtype, mesh)
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
        S_k = float(grid_dims[_PERMS[axis][2]])
        lo3 = torch.stack([lo3[0], lo3[1], lo3[2] + (S_k - 1.0) * vs[2]])
        vs = torch.stack([vs[0], vs[1], -vs[2]])
    eye_g = (M @ eye_w - lo3) / vs
    volp = unified.permute(*_VOLUME_PERMS[axis])
    if not (positive or stream_composite):
        volp = volp.flip(0)  # the monolithic tail marches the reversed volume
    volp = volp.contiguous()

    noise = None
    if noise_std > 0.0:
        shape = (base_hw[0] * base_hw[1], volp.shape[0])
        if density_noise is None:
            if generator is None:
                raise ValueError("density noise needs a torch.Generator or density_noise")
            density_noise = torch.randn(shape, generator=generator, device=generator.device)
        if tuple(density_noise.shape) != shape:
            raise ValueError(f"density_noise must be {list(shape)}, got {list(density_noise.shape)}")
        noise = density_noise.to(dev, torch.float32) * noise_std

    out, dirs_w, lo2, hi2 = _render_canonical(
        volp, eye_g, vs, lo3, base_hw, config, cfg, unpermute_mat=M,
        flip_k=stream_composite and not positive,
        with_diffuse=with_diffuse, stream_composite=stream_composite,
        background_value=background_value, diffuse_only=diffuse_only,
        num_shade_channels=num_shade_channels, noise=noise, mesh=mesh,
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


# ----------------------------------------------------------------------------------
# host-side pose guards (NumPy)
# ----------------------------------------------------------------------------------


def _all_axis_margins(voxel_grid: VoxelGrid, eyes: np.ndarray, view_dirs: np.ndarray) -> np.ndarray:
    """[N, 3] eye-outside-AABB margin in voxels along every axis, marching
    toward sign(view_dirs[axis]): toward +k the eye must clear the low face,
    toward -k the high one."""
    cfg = voxel_grid.config
    dims = np.array(voxel_grid.grid_dims, np.float64)
    vsizes = np.array(list(cfg.voxel_size), np.float64)
    loc = np.array(list(cfg.grid_location), np.float64)
    aabb_lo = loc - (dims - 1.0) / 2.0 * vsizes
    aabb_hi = loc + (dims - 1.0) / 2.0 * vsizes
    return np.where(view_dirs > 0.0, (aabb_lo - eyes) / vsizes, (eyes - aabb_hi) / vsizes)


def shear_warp_pose_margins(voxel_grid: VoxelGrid, eyes, view_dirs) -> np.ndarray:
    """Per pose, the margin in voxels by which the eye sits outside the grid
    AABB along its marching axis; >= 0.5 means the renderer's e_k clamp is a
    no-op and the rendered geometry is right."""
    eyes = np.asarray(eyes, np.float64).reshape(-1, 3)
    view_dirs = np.asarray(view_dirs, np.float64).reshape(-1, 3)
    all_m = _all_axis_margins(voxel_grid, eyes, view_dirs)
    k = np.argmax(np.abs(view_dirs), axis=1)
    return np.take_along_axis(all_m, k[:, None], axis=1)[:, 0]


def shear_warp_supports_pose(voxel_grid: VoxelGrid, pose: CameraPose, min_margin: float = 0.5) -> bool:
    """True when `pose`'s eye clears the grid AABB along its marching axis by
    at least `min_margin` voxels."""
    eye = _host_f32(pose.translation).astype(np.float64).reshape(1, 3)
    view = -_host_f32(pose.rotation).astype(np.float64)[:, 2].reshape(1, 3)
    return bool(shear_warp_pose_margins(voxel_grid, eye, view)[0] >= min_margin)


def check_shear_warp_hemisphere(voxel_grid: VoxelGrid, radius: float, context: str, min_margin: float = 0.5) -> None:
    """Raise ValueError when some hemisphere pose at `radius` (pitch in
    [15, 90], yaw in [0, 360): the `get_random_pose` domain) would put the
    camera inside the grid AABB along its marching axis.

    Checks a 0.25-degree pitch/yaw lattice with a Lipschitz slack (the eye
    moves at most `radius` world units a radian, so a margin can fall by at
    most radius * h * sqrt(2) / min voxel size between lattice points), and
    takes each sample's margin as the least over every axis that could be
    the marching axis anywhere in its lattice cell."""
    h_deg = 0.25
    h = math.radians(h_deg)
    pitch = np.radians(np.arange(15.0, 90.0 + h_deg, h_deg))
    yaw = np.radians(np.arange(0.0, 360.0, h_deg))
    sp, cp = np.sin(pitch), np.cos(pitch)
    sy, cy = np.sin(yaw), np.cos(yaw)
    # eye(yaw, pitch) = r * (sy sp, -cy sp, cp), as pose_spherical composes it
    eyes = np.empty((len(pitch), len(yaw), 3))
    eyes[..., 0] = radius * sp[:, None] * sy[None, :]
    eyes[..., 1] = -radius * sp[:, None] * cy[None, :]
    eyes[..., 2] = radius * cp[:, None] * np.ones((1, len(yaw)))
    eyes = eyes.reshape(-1, 3)
    views = -eyes / radius  # spherical poses look at the origin
    all_m = _all_axis_margins(voxel_grid, eyes, views)
    absv = np.abs(views)
    candidate = absv >= absv.max(axis=1, keepdims=True) - 2.0 * h * math.sqrt(2.0)
    margins = np.where(candidate, all_m, np.inf).min(axis=1)
    slack = radius * h * math.sqrt(2.0) / float(min(voxel_grid.config.voxel_size))
    if float(margins.min()) - slack < min_margin:
        raise ValueError(
            f"{context}: random hemisphere poses at radius {radius:.4f} can put the camera inside "
            f"(or within {min_margin} voxels of) the voxel grid's AABB along the marching axis (min "
            f"sampled margin {margins.min():.2f} voxels, lattice slack {slack:.2f}) — the shear-warp "
            "path cannot render from inside the volume. Use the exact renderer (use_shear_warp=False), "
            "shrink the grid's world size, or increase the camera radius."
        )


def check_shear_warp_poses(voxel_grid: VoxelGrid, poses, context: str, min_margin: float = 0.5) -> None:
    """Raise ValueError when any [N, 3, 4] pose puts the camera inside (or
    within `min_margin` voxels of) the grid AABB along its marching axis."""
    poses = np.asarray(poses, np.float64)
    margins = shear_warp_pose_margins(voxel_grid, poses[:, :, 3], -poses[:, :, 2])
    bad = np.flatnonzero(margins < min_margin)
    if bad.size:
        worst = int(bad[np.argmin(margins[bad])])
        raise ValueError(
            f"{context}: {bad.size}/{len(poses)} camera pose(s) sit inside or "
            f"within {min_margin} voxels of the voxel grid's AABB along their "
            f"marching axis (worst: pose {worst}, margin {margins[worst]:.2f} "
            "voxels) — the shear-warp path cannot render from inside the volume. "
            "Use the exact renderer, shrink the grid's world size, or move the "
            "cameras outside the grid."
        )


# ----------------------------------------------------------------------------------
# base-plane geometry and the target warp (data preparation, no gradient)
# ----------------------------------------------------------------------------------


def compute_base_geometry(voxel_grid: VoxelGrid, pose: CameraPose) -> BaseImageGeometry:
    """Host-side base-window geometry (lo/hi + branch) of `pose`, without
    rendering; it mirrors `render_shear_warp`'s branch and window math.
    `dirs` is None."""
    cfg = voxel_grid.config
    dims = np.array(voxel_grid.grid_dims, np.float64)
    vsizes = np.array(list(cfg.voxel_size), np.float64)
    loc = np.array(list(cfg.grid_location), np.float64)
    aabb_lo = loc - (dims - 1.0) / 2.0 * vsizes

    eye_w = _host_f32(pose.translation).astype(np.float64).reshape(3)
    rot = _host_f32(pose.rotation).astype(np.float64)
    view_dir = -rot[:, 2]
    axis = int(np.argmax(np.abs(view_dir)))
    positive = int(view_dir[axis] > 0.0)
    a_ax, b_ax, k_ax = _PERMS[axis]

    vs = np.array([vsizes[a_ax], vsizes[b_ax], vsizes[k_ax]])
    lo3 = np.array([aabb_lo[a_ax], aabb_lo[b_ax], aabb_lo[k_ax]])
    dimp = np.array([dims[a_ax], dims[b_ax], dims[k_ax]])
    if not positive:
        lo3[2] += (dimp[2] - 1.0) * vs[2]
        vs[2] = -vs[2]
    eye_g = (np.array([eye_w[a_ax], eye_w[b_ax], eye_w[k_ax]]) - lo3) / vs

    S, A, B = int(dimp[2]), int(dimp[0]), int(dimp[1])
    e_a, e_b = eye_g[0], eye_g[1]
    e_k = min(eye_g[2], -0.5)
    far = (S - 1.0 - e_k) / (0.0 - e_k)
    a_corners = np.array([0.0, A - 1.0])
    b_corners = np.array([0.0, B - 1.0])
    a_proj = e_a + (a_corners - e_a) / far
    b_proj = e_b + (b_corners - e_b) / far
    lo = np.array([min(a_corners.min(), a_proj.min()), min(b_corners.min(), b_proj.min())], np.float32)
    hi = np.array([max(a_corners.max(), a_proj.max()), max(b_corners.max(), b_proj.max())], np.float32)
    return BaseImageGeometry(
        eye=torch.from_numpy(eye_w.astype(np.float32)), dirs=None,
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi), perm_index=axis * 2 + positive,
    )


def screen_to_base(
    pose: CameraPose,
    intrinsics: CameraIntrinsics,
    geom: BaseImageGeometry,
    voxel_grid: VoxelGrid,
    base_hw: Tuple[int, int],
) -> torch.Tensor:
    """[H, W, 2] fractional base-pixel coords of every screen pixel (f32 on
    the CPU); pixels whose base plane lies behind the camera get -10."""
    cfg = voxel_grid.config
    dims = np.array(voxel_grid.grid_dims, np.float32)
    vsizes = np.array(list(cfg.voxel_size), np.float32)
    loc = np.array(list(cfg.grid_location), np.float32)
    aabb_lo = loc - (dims - 1.0) / 2.0 * vsizes

    rays = cast_rays(intrinsics, _host_f32(pose.rotation), _host_f32(pose.translation))
    d = rays.directions.reshape(-1, 3)
    o = rays.origins.reshape(-1, 3)
    U, V = base_hw
    axis, positive = geom.perm_index // 2, geom.perm_index % 2
    sel = list(_PERMS[axis])
    vs = torch.from_numpy(vsizes[sel].copy())
    lo3 = torch.from_numpy(aabb_lo[sel].copy())
    if not positive:
        lo3[2] = lo3[2] + (float(dims[sel[2]]) - 1.0) * vs[2]
        vs[2] = -vs[2]
    d_g = d[:, sel] / vs
    o_g = (o[:, sel] - lo3) / vs
    t = (0.0 - o_g[:, 2]) / d_g[:, 2]  # intersect the base plane k = 0
    a0 = o_g[:, 0] + t * d_g[:, 0]
    b0 = o_g[:, 1] + t * d_g[:, 1]
    lo, hi = geom.lo.cpu(), geom.hi.cpu()
    ui = (a0 - lo[0]) / (hi[0] - lo[0]) * U - 0.5
    vi = (b0 - lo[1]) / (hi[1] - lo[1]) * V - 0.5
    behind = t <= 0.0
    ui = torch.where(behind, torch.full_like(ui, -10.0), ui)
    vi = torch.where(behind, torch.full_like(vi, -10.0), vi)
    return torch.stack([ui, vi], dim=-1).reshape(intrinsics.height, intrinsics.width, 2)


def warp_image_to_base(
    image: torch.Tensor,  # [H, W, C] screen-space image (data)
    coords: torch.Tensor,  # [H, W, 2] from screen_to_base
    base_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splat a screen image onto the base lattice with bilinear weights.
    Returns (base image [U, V, C], coverage mask [U, V] in {0, 1})."""
    U, V = base_hw
    C = image.shape[-1]
    ui = coords[..., 0].reshape(-1)
    vi = coords[..., 1].reshape(-1)
    px = image.reshape(-1, C).float()
    u0 = torch.floor(ui).to(torch.int64)
    v0 = torch.floor(vi).to(torch.int64)
    acc = torch.zeros((U * V, C), dtype=torch.float32, device=image.device)
    wacc = torch.zeros((U * V,), dtype=torch.float32, device=image.device)
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0 + du, v0 + dv
            w = torch.clamp(1.0 - torch.abs(ui - uu), min=0.0) * torch.clamp(1.0 - torch.abs(vi - vv), min=0.0)
            valid = (uu >= 0) & (uu < U) & (vv >= 0) & (vv < V)
            w = torch.where(valid, w, torch.zeros((), device=w.device))
            flat = uu.clamp(0, U - 1) * V + vv.clamp(0, V - 1)
            acc.index_add_(0, flat, w[:, None] * px)
            wacc.index_add_(0, flat, w)
    base = acc / torch.clamp(wacc, min=1e-8)[:, None]
    return base.reshape(U, V, C), (wacc > 1e-6).reshape(U, V).float()


# ----------------------------------------------------------------------------------
# screen-space render: base composite + the final 2D warp
# ----------------------------------------------------------------------------------


def sample_base_image(base: torch.Tensor, coords: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Bilinear gather of a base-plane image [U, V, C] at per-screen-pixel
    base coordinates [H, W, 2] (`screen_to_base`); screen pixels whose rays
    miss the base window blend toward `fill`. Returns [H, W, C]."""
    U, V, C = base.shape
    ui, vi = coords[..., 0], coords[..., 1]
    u0 = torch.floor(ui).to(torch.int64)
    v0 = torch.floor(vi).to(torch.int64)
    out = torch.zeros((*ui.shape, C), dtype=base.dtype, device=base.device)
    wsum = torch.zeros(ui.shape, dtype=base.dtype, device=base.device)
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    for du in (0, 1):
        for dv in (0, 1):
            uu, vv = u0 + du, v0 + dv
            w = torch.clamp(1.0 - torch.abs(ui - uu), min=0.0) * torch.clamp(1.0 - torch.abs(vi - vv), min=0.0)
            valid = (uu >= 0) & (uu < U) & (vv >= 0) & (vv < V)
            w = torch.where(valid, w.to(base.dtype), zero)
            out = out + w[..., None] * base[uu.clamp(0, U - 1), vv.clamp(0, V - 1)]
            wsum = wsum + w
    return out + (1.0 - wsum)[..., None] * fill


def render_shear_warp_to_screen(
    voxel_grid: VoxelGrid,
    pose: CameraPose,
    intrinsics: CameraIntrinsics,
    config,
    base_hw: Optional[Tuple[int, int]] = None,
    background_value: Optional[float] = None,
    attn_mode: bool = False,
    use_orig_densities: bool = False,
) -> RenderOut:
    """Screen-space render: the shear-warp base composite, then
    `sample_base_image` at `screen_to_base` coordinates. Returns RenderOut
    with [H, W, C] leaves. `base_hw` defaults to a square lattice at twice
    the screen's long side; `config.render_diffuse` renders the colour as
    the degree-0 version (shaded once, through `diffuse_only`). `attn_mode`
    renders the attention field (on black unless `background_value` says
    otherwise)."""
    if base_hw is None:
        side = 2 * max(int(intrinsics.height), int(intrinsics.width))
        base_hw = (side, side)
    base_hw = tuple(base_hw)
    if background_value is None:
        background_value = 0.0 if attn_mode else (1.0 if config.white_bkgd else 0.0)
    out, geom = render_shear_warp(
        voxel_grid, pose, config, base_hw=base_hw, background_value=background_value,
        diffuse_only=bool(getattr(config, "render_diffuse", False)) and not attn_mode,
        attn_mode=attn_mode, use_orig_densities=use_orig_densities,
    )
    coords = screen_to_base(pose, intrinsics, geom, voxel_grid, base_hw).to(out.colour.device)

    def as_screen(t, fill):
        return sample_base_image(t.reshape(*base_hw, -1).float(), coords, fill=fill)

    return RenderOut(
        colour=as_screen(out.colour, background_value),
        depth=as_screen(out.depth, 0.0),
        extra={k: as_screen(v, 0.0) for k, v in out.extra.items()},
    )
