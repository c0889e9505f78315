"""Parity of the port's reconstruction path against voxe_tpu on the CPU:
grid query and rescale, rays, sampling and point processing, the exact
full-image render, the six-branch monolithic shear-warp with the fused
compositing kernel's plain version, the base-plane target warp, whole recon
steps (shear-warp and exact) with their Adam updates, the tester's metrics,
the dataset, checkpoints across packages, and the train CLI at tiny size.

Inputs are made with numpy from a seed and fed to both packages; draws that
JAX makes with `jax.random` are replayed into the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voxe_tpu.data.dataset import PosedImagesDataset as JDataset
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models import volumetric as jvol
from voxe_tpu.render import process as jproc
from voxe_tpu.render import rays as jrays
from voxe_tpu.render import sample as jsample
from voxe_tpu.render import shearwarp as jsw
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import recon as jrecon
from voxe_tpu.utils import camera as jcam
from voxe_tpu.utils import metrics as jmetrics
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as tcli
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.render import process as tproc
from voxe_tpu_torch.render import rays as trays
from voxe_tpu_torch.render import sample as tsample
from voxe_tpu_torch.render import shearwarp as tsw
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import recon as trecon
from voxe_tpu_torch.train import sds as tsds
from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images as t_tester
from voxe_tpu_torch.utils import camera as tcam
from voxe_tpu_torch.utils import metrics as tmetrics

# eyes near each of the six axis directions (z up; pitch 90 is level):
# every (marching axis, direction) pair
SIX_POSES = [(10.0, 85.0), (100.0, 85.0), (190.0, 85.0), (280.0, 85.0), (10.0, 5.0), (10.0, 175.0)]
GRID_KW = dict(density_preactivation="identity", density_postactivation="softplus", expected_density_scale=3.0)


def _grids(dims, sh_degree=1, seed=0, gather_dtype="float32", world=3.0):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(-1.0, 1.0, (*dims, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (*dims, 3 * (sh_degree + 1) ** 2)).astype(np.float32)
    vs = [world / d for d in dims]
    jg = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats),
                        jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs), gather_dtype=gather_dtype, **GRID_KW))
    tg = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats),
                        tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), gather_dtype=gather_dtype, **GRID_KW))
    return jg, tg


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_grid_query(gather_dtype):
    jg, tg = _grids((7, 9, 8), gather_dtype=gather_dtype)
    pts = np.random.default_rng(1).uniform(-1.8, 1.8, (300, 3)).astype(np.float32)  # some outside
    # f32: float rounding of the 8-corner sum; bf16: both gather the same
    # bf16 table and sum in f32, so the same rounding up to summation order
    _close(tvox.grid_query(tg, torch.from_numpy(pts)), jvox.grid_query(jg, jnp.asarray(pts)), rtol=1e-5, atol=1e-5)
    _close(tvox.test_inside_volume(tg.aabb, torch.from_numpy(pts)), jvox.test_inside_volume(jg.aabb, jnp.asarray(pts)), 0, 0)
    assert tuple(tg.aabb) == tuple(jg.aabb)


@pytest.mark.parametrize("size", [(16, 14, 12), (4, 5, 3)])
def test_scale_voxel_grid(size):
    """Upsampling (the stage ladder) and antialiased downsampling."""
    jg, tg = _grids((8, 7, 6))
    js, ts = jvox.scale_voxel_grid(jg, size), tvox.scale_voxel_grid(tg, size)
    # jax.image.resize's weights in f32, the port's in f64 rounded to f32
    _close(ts.densities, js.densities, rtol=1e-5, atol=2e-6)
    _close(ts.features, js.features, rtol=1e-5, atol=2e-6)
    assert ts.config.to_json_dict() == js.config.to_json_dict()


# ---------------------------------------------------------------------------
# rays, sampling, processing
# ---------------------------------------------------------------------------


def _rays(n=40, seed=2):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.2, -3.2, 0.5]], np.float32), (n, 1))
    d = (rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 1.0, 0.0])).astype(np.float32)
    return o, d


def test_cast_rays():
    pose = jcam.pose_spherical(30.0, 50.0, 4.0)
    intr = jcam.CameraIntrinsics(6, 9, 7.5)
    jr = jrays.cast_rays(intr, jnp.asarray(pose.rotation), jnp.asarray(pose.translation))
    tr = trays.cast_rays(tcam.CameraIntrinsics(6, 9, 7.5), pose.rotation, pose.translation, device="cpu")
    _close(tr.origins, jr.origins, 0, 0)
    _close(tr.directions, jr.directions, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["uniform", "disparity", "aabb"])
def test_sampling_with_replayed_jitter(mode):
    o, d = _rays()
    jg, tg = _grids((8, 8, 8))
    key = jax.random.PRNGKey(5)
    S = 24
    t_rand = np.array(jax.random.uniform(key, (len(o), S), dtype=jnp.float32))
    jr, tr = jrays.Rays(jnp.asarray(o), jnp.asarray(d)), trays.Rays(torch.from_numpy(o), torch.from_numpy(d))
    if mode == "aabb":
        js = jsample.sample_aabb_bound_uniform_points_on_rays(jr, jcam.CameraBounds(1.0, 7.0), S, jg.aabb, key=key)
        ts = tsample.sample_aabb_bound_uniform_points_on_rays(
            tr, tcam.CameraBounds(1.0, 7.0), S, tg.aabb, t_rand=torch.from_numpy(t_rand)
        )
        jb, jhit = jsample.ray_aabb_intersection(jr, jcam.CameraBounds(1.0, 7.0), jg.aabb)
        tb, thit = tsample.ray_aabb_intersection(tr, tcam.CameraBounds(1.0, 7.0), tg.aabb)
        _close(tb, jb, rtol=1e-6, atol=1e-6)
        _close(thit, jhit, 0, 0)
    else:
        lin = mode == "disparity"
        js = jsample.sample_uniform_points_on_rays(jr, jcam.CameraBounds(1.0, 7.0), S, linear_disparity_sampling=lin, key=key)
        ts = tsample.sample_uniform_points_on_rays(
            tr, tcam.CameraBounds(1.0, 7.0), S, linear_disparity_sampling=lin, t_rand=torch.from_numpy(t_rand)
        )
    _close(ts.depths, js.depths, rtol=1e-6, atol=1e-6)
    _close(ts.points, js.points, rtol=1e-6, atol=1e-5)
    # processing the same points: query + SH + outside mask
    for diffuse in (False, True):
        _close(
            tproc.process_points_with_sh_voxel_grid(ts, tr, tg, render_diffuse=diffuse),
            jproc.process_points_with_sh_voxel_grid(js, jr, jg, render_diffuse=diffuse),
            rtol=1e-4, atol=1e-5,
        )


# ---------------------------------------------------------------------------
# exact full-image render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_exact_render_full_image(fused):
    """VolumetricModel.render: 16x12 image in chunks of 50 rays (the last one
    padded), AABB-bounded sampling, no jitter."""
    jg, tg = _grids((10, 10, 10), world=2.5)
    pose = jcam.pose_spherical(40.0, 60.0, 4.0)
    kw = dict(num_samples_per_ray=32, render_num_samples_per_ray=48, white_bkgd=True,
              parallel_rays_chunk_size=50, use_fused_kernel=fused)
    jout = jvol.VolumetricModel(jg, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **kw)).render(
        jcam.CameraIntrinsics(16, 12, 14.0), pose)
    tout = tvol.VolumetricModel(tg, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **kw)).render(
        tcam.CameraIntrinsics(16, 12, 14.0), pose)
    assert tout.colour.shape == (16, 12, 3)
    assert float(tout.extra["accumulated_weight"].max()) > 0.5
    _close(tout.colour, jout.colour, rtol=1e-4, atol=1e-5)
    _close(tout.depth, jout.depth, rtol=1e-4, atol=1e-4)
    _close(tout.extra["accumulated_weight"], jout.extra["accumulated_weight"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# shear-warp: six branches, target warp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def noncubic_grids():
    return _grids((16, 14, 12), sh_degree=1, seed=3)


@pytest.mark.parametrize("fused", [True, False])
def test_shearwarp_six_branches_noncubic(noncubic_grids, fused):
    """Every marching branch on a non-cubic grid: the monolithic tail with
    the fused kernel (volume reversed for negative branches), and the
    streamed tail; colour, diffuse colour, depth and acc."""
    jg, tg = noncubic_grids
    base = (20, 20)
    jcfg = JRenderConfig(num_samples_per_ray=64, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True, use_fused_kernel=fused)
    tcfg = TRenderConfig(num_samples_per_ray=64, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True, use_fused_kernel=fused)
    seen = set()
    for yaw, pitch in SIX_POSES:
        pose = jcam.pose_spherical(yaw, pitch, 4.0)
        jout, jgeom = jsw.render_shear_warp(jg, pose, jcfg, base_hw=base, with_diffuse=True)
        tout, tgeom = tsw.render_shear_warp(tg, tcam.CameraPose(*pose), tcfg, base_hw=base, with_diffuse=True)
        assert tgeom.perm_index == int(jgeom.perm_index)
        seen.add(tgeom.perm_index)
        # f32 resample + composite in another summation order
        for t, j in ((tout.colour, jout.colour), (tout.extra["diffuse_colour"], jout.extra["diffuse_colour"]),
                     (tout.depth, jout.depth), (tout.extra["accumulated_weight"], jout.extra["accumulated_weight"])):
            _close(t, j, rtol=1e-4, atol=1e-4)
        _close(tgeom.lo, jgeom.lo, rtol=1e-6, atol=1e-5)
        _close(tgeom.hi, jgeom.hi, rtol=1e-6, atol=1e-5)
    assert seen == set(range(6))


def test_pose_guards_and_target_warp():
    jg, tg = _grids((16, 16, 16), seed=4)
    rng = np.random.default_rng(5)
    poses, imgs = [], rng.uniform(0, 1, (6, 12, 12, 3)).astype(np.float32)
    for yaw, pitch in SIX_POSES:
        p = jcam.pose_spherical(yaw, pitch, 4.0)
        poses.append(np.concatenate([p.rotation, p.translation], 1))
    poses = np.stack(poses).astype(np.float32)
    intr = (12, 12, 14.0)
    base = (24, 24)
    jt, jm = jrecon.warp_dataset_to_base(jnp.asarray(imgs), jnp.asarray(poses), jcam.CameraIntrinsics(*intr), jg, base)
    tt, tm = trecon.warp_dataset_to_base(torch.from_numpy(imgs), torch.from_numpy(poses), tcam.CameraIntrinsics(*intr), tg, base)
    # screen->base coords in f32 on both sides, then a scatter in another order
    _close(tt, jt, rtol=1e-4, atol=1e-4)
    _close(tm, jm, 0, 0)
    assert float(tm.mean()) > 0.05
    eyes, views = poses[:, :, 3], -poses[:, :, 2]
    np.testing.assert_allclose(tsw.shear_warp_pose_margins(tg, eyes, views), jsw.shear_warp_pose_margins(jg, eyes, views))
    inside = jcam.pose_spherical(10.0, 85.0, 1.0)  # the eye sits inside the grid
    assert tsw.shear_warp_supports_pose(tg, tcam.CameraPose(*inside)) == jsw.shear_warp_supports_pose(jg, inside) is False
    bad = np.concatenate([poses, np.concatenate([inside.rotation, inside.translation], 1)[None]])
    with pytest.raises(ValueError):
        tsw.check_shear_warp_poses(tg, bad, "test")


# ---------------------------------------------------------------------------
# whole recon steps against optax.adam
# ---------------------------------------------------------------------------


def _capture():
    """An optax stage that passes updates through and keeps them as its
    state: chained before adam it hands back the step's gradients."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda updates, state, params=None: (updates, updates),
    )


LR, DECAY_STEPS, GAMMA = 0.03, 1, 0.1  # the lr changes between the two steps


def _jax_optimizer():
    return optax.chain(_capture(), optax.adam(optax.exponential_decay(LR, DECAY_STEPS, GAMMA, staircase=True)))


def _check_update(t_new, j_new, j_old, j_grad, t_grad=None):
    """Adam's first steps are ~lr * sign(g) and, for |g| near eps, follow
    g / (|g| + eps), so rounding of a small gradient moves its update: compare
    the two packages' new values where |g| > 1e-2 of its max (there the
    update is insensitive to the 1e-4 gradient tolerance); everywhere the
    update is at most 2 lr apart. With `t_grad`, the port's first update must
    equal optax.adam applied to the port's own gradient (eps placement, bias
    correction), to f32 rounding."""
    jg, diff = np.asarray(j_grad), np.abs(t_new.detach().numpy() - np.asarray(j_new))
    clear = np.abs(jg) > 1e-2 * np.abs(jg).max()
    assert clear.mean() > 0.05
    assert diff[clear].max() < 1e-6, diff[clear].max()
    assert diff.max() <= 2 * LR + 1e-6
    assert np.abs(np.asarray(j_new) - np.asarray(j_old)).max() > 0.0
    if t_grad is not None:
        adam = optax.adam(LR)
        g = jnp.asarray(t_grad.numpy())
        upd, _ = adam.update(g, adam.init(jnp.asarray(j_old)))
        np.testing.assert_allclose(t_new.detach().numpy(), np.asarray(j_old) + np.asarray(upd), rtol=0, atol=1e-6)


def _check_grads(t_grad, j_grad):
    scale = float(np.abs(np.asarray(j_grad)).max())
    assert scale > 0.0
    err = float(np.abs(t_grad.numpy() - np.asarray(j_grad)).max())
    assert err <= 1e-4 * scale, (err, scale)  # f32 on both sides, relative to the largest entry


@pytest.fixture(scope="module")
def sw_step_setup():
    res, base = 16, (32, 32)
    jg, tg = _grids((res,) * 3, sh_degree=1, seed=6)
    rng = np.random.default_rng(7)
    targets = rng.uniform(0, 1, (6, *base, 3)).astype(np.float32)
    masks = (rng.random((6, *base)) > 0.2).astype(np.float32)
    poses = np.stack([
        np.concatenate(jcam.pose_spherical(yaw, pitch, 4.0), axis=1) for yaw, pitch in SIX_POSES
    ]).astype(np.float32)
    cfg = dict(num_samples_per_ray=64, white_bkgd=True, use_fused_kernel=True)
    jopt = _jax_optimizer()
    jstep = jrecon.make_recon_train_step_shearwarp(
        JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, base, True
    )
    return dict(jg=jg, tg=tg, targets=targets, masks=masks, poses=poses, jopt=jopt, jstep=jstep,
                tcfg=TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), base=base)


def _t_grid(tg):
    return tg.replace(densities=tg.densities.clone(), features=tg.features.clone())


@pytest.mark.parametrize("branch", range(6))
def test_shearwarp_recon_step_each_branch(sw_step_setup, branch):
    """One whole shear-warp recon step (16^3, 32^2 base, fused compositing,
    diffuse regularisation) from each marching branch: loss, gradients and
    the Adam update against the jitted JAX step with optax.adam."""
    s = sw_step_setup
    jg = s["jg"]
    new, state, jm = s["jstep"](jg, s["jopt"].init(jg), jnp.asarray(s["targets"]), jnp.asarray(s["masks"]),
                                jnp.asarray(s["poses"]), jnp.asarray(branch), jax.random.PRNGKey(0))
    grads = state[0]
    grid = _t_grid(s["tg"])
    opt = tsds.make_adam(grid, LR)
    step = trecon.make_recon_train_step_shearwarp(
        s["tcfg"], opt, s["base"], True, lr_schedule=trecon.exponential_decay_staircase(LR, DECAY_STEPS, GAMMA)
    )
    tm = step(grid, torch.from_numpy(s["targets"]), torch.from_numpy(s["masks"]), torch.from_numpy(s["poses"]), branch)
    for k in ("total_loss", "specular_loss", "diffuse_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    assert float(tm["specular_loss"]) != float(tm["diffuse_loss"])  # SH degree 1: not the same render
    _check_grads(grid.densities.grad, grads.densities)
    _check_grads(grid.features.grad, grads.features)
    _check_update(grid.densities, new.densities, jg.densities, grads.densities, grid.densities.grad)
    _check_update(grid.features, new.features, jg.features, grads.features, grid.features.grad)


def test_shearwarp_recon_two_steps_schedule(sw_step_setup):
    """Two steps on one pose: the staircase lr (0.03, then 0.003) and Adam's
    moments carried across steps."""
    s = sw_step_setup
    args = (jnp.asarray(s["targets"]), jnp.asarray(s["masks"]), jnp.asarray(s["poses"]), jnp.asarray(2), jax.random.PRNGKey(0))
    jg1, st1, _ = s["jstep"](s["jg"], s["jopt"].init(s["jg"]), *args)
    jg2, st2, _ = s["jstep"](jg1, st1, *args)
    grid = _t_grid(s["tg"])
    opt = tsds.make_adam(grid, LR)
    step = trecon.make_recon_train_step_shearwarp(
        s["tcfg"], opt, s["base"], True, lr_schedule=trecon.exponential_decay_staircase(LR, DECAY_STEPS, GAMMA)
    )
    t_args = (torch.from_numpy(s["targets"]), torch.from_numpy(s["masks"]), torch.from_numpy(s["poses"]), 2)
    step(grid, *t_args)
    step(grid, *t_args)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * GAMMA)
    _check_update(grid.densities, jg2.densities, jg1.densities, st2[0].densities)


def test_exact_recon_step_with_replayed_draws():
    """The exact ray-batch step: JAX draws the pixel indices and the jitter
    from its key; the port gets the same draws injected. Loss, gradients and
    the Adam update."""
    jg, tg = _grids((12, 12, 12), seed=8)
    rng = np.random.default_rng(9)
    images = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    poses = np.stack([np.concatenate(jcam.pose_spherical(y, p, 4.0), 1) for y, p in ((20, 50), (140, 70), (250, 30))]).astype(np.float32)
    intr, R, S = (8, 8, 9.0), 64, 32
    cfg = dict(num_samples_per_ray=S, white_bkgd=True)
    jopt = _jax_optimizer()
    jstep = jrecon.make_recon_train_step(jcam.CameraIntrinsics(*intr), JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, R)
    key, batch = jax.random.PRNGKey(11), np.array([2, 0], np.int32)
    new, state, jm = jstep(jg, jopt.init(jg), jnp.asarray(images), jnp.asarray(poses), jnp.asarray(batch), key)
    k_idx, k_render = jax.random.split(key)  # train/recon.py:130
    flat_idx = np.array(jax.random.randint(k_idx, (R,), 0, 2 * 8 * 8))
    t_rand = np.array(jax.random.uniform(k_render, (R, S), dtype=jnp.float32))

    grid = _t_grid(tg)
    opt = tsds.make_adam(grid, LR)
    step = trecon.make_recon_train_step(
        tcam.CameraIntrinsics(*intr), TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt, R,
        lr_schedule=trecon.exponential_decay_staircase(LR, DECAY_STEPS, GAMMA),
    )
    tm = step(grid, torch.from_numpy(images), torch.from_numpy(poses), batch,
              flat_idx=torch.from_numpy(flat_idx), t_rand=torch.from_numpy(t_rand))
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5, atol=1e-6)
    _check_grads(grid.densities.grad, state[0].densities)
    _check_grads(grid.features.grad, state[0].features)
    _check_update(grid.features, new.features, jg.features, state[0].features, grid.features.grad)


# ---------------------------------------------------------------------------
# metrics, dataset, checkpoints, CLI
# ---------------------------------------------------------------------------


def test_psnr_and_ssim():
    rng = np.random.default_rng(12)
    a = rng.uniform(0, 1, (20, 18, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b))), float(jmetrics.psnr(a, b)), rtol=1e-6)
    # separable 11-tap blur as two convolutions on both sides
    np.testing.assert_allclose(float(tmetrics.ssim(a, b)), float(jmetrics.ssim(a, b)), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """A 32^2 synthetic scene made by the port (on the CPU), in the split
    layout the CLI reads by default."""
    root = tmp_path_factory.mktemp("scene")
    generate_synthetic_scene(root, num_train=4, num_test=2, image_size=32, focal=32.0, grid_res=24, device="cpu")
    for split in ("train", "test"):
        (root / split).mkdir()
        for p in (root / "images").glob(f"{split}_*.png"):
            p.rename(root / split / p.name)
    return root


@pytest.mark.parametrize("factor", [1.0, 2.0, 4.0])
def test_dataset_matches_jax(tiny_scene, factor):
    """Pillow decodes and (Image.BILINEAR) resizes in both packages."""
    kw = dict(images_dir=tiny_scene / "train", camera_params_json=tiny_scene / "train_camera_params.json",
              downsample_factor=factor, rgba_white_bkgd=True)
    j, t = JDataset(**kw), TDataset(device="cpu", **kw)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)
    assert tuple(t.camera_intrinsics) == tuple(j.camera_intrinsics)
    assert tuple(t.camera_bounds) == tuple(j.camera_bounds)
    assert t.get_hemispherical_radius_estimate() == j.get_hemispherical_radius_estimate()
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    bj, bt = j.iter_batches(3, rj), t.iter_batches(3, rt)
    for _ in range(4):
        np.testing.assert_array_equal(next(bt), next(bj))


def test_checkpoints_load_across_packages(tmp_path):
    jg, tg = _grids((6, 5, 4), seed=13)
    jcfg = JRenderConfig(num_samples_per_ray=33, camera_bounds=jcam.CameraBounds(1.5, 5.5), white_bkgd=True, use_fused_kernel=True)
    tcfg = TRenderConfig(num_samples_per_ray=33, camera_bounds=tcam.CameraBounds(1.5, 5.5), white_bkgd=True, use_fused_kernel=True)
    info = {"hemispherical_radius": 4.0, "camera_bounds": [1.5, 5.5]}
    jvol.VolumetricModel(jg, jcfg).save(tmp_path / "from_jax.pth", extra_info=info)
    tvol.VolumetricModel(tg, tcfg).save(tmp_path / "from_torch.pth", extra_info=info)
    t_loaded, t_info = tvol.load_volumetric_model(tmp_path / "from_jax.pth", device="cpu")
    j_loaded, j_info = jvol.load_volumetric_model(tmp_path / "from_torch.pth")
    for src, loaded in ((jg, t_loaded.grid), (j_loaded.grid, tg)):
        np.testing.assert_array_equal(np.asarray(loaded.densities), np.asarray(src.densities))
        np.testing.assert_array_equal(np.asarray(loaded.features), np.asarray(src.features))
    assert t_loaded.grid.config.to_json_dict() == jg.config.to_json_dict()
    assert j_loaded.grid.config.to_json_dict() == tg.config.to_json_dict()
    assert dataclasses.asdict(j_loaded.render_config) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(t_loaded.render_config) == dataclasses.asdict(tcfg)
    assert t_info == j_info == info


def test_cli_tiny_end_to_end(tiny_scene, tmp_path):
    """The CLI module on the CPU: 2 stages x 3 shear-warp iterations with
    the fused kernel's plain version, ending in model_final.pth, which both
    packages read back; the tester's PSNR/SSIM on the held-out split; a run
    at the default fast_debug_mode; two steps a call."""
    out = tmp_path / "out"
    tcli.main([
        "-d", str(tiny_scene), "-o", str(out), "--grid_dims", "16", "16", "16", "--num_stages", "2",
        "--num_iterations_per_stage", "3", "--fast_debug_mode", "True", "--use_fused_kernel", "True",
        "--render_num_samples_per_ray", "64", "--device", "cpu",
    ])
    final = out / "saved_models" / "model_final.pth"
    model, info = tvol.load_volumetric_model(final, device="cpu")
    assert model.grid.grid_dims == (16, 16, 16) and model.render_config.use_fused_kernel
    assert info["hemispherical_radius"] == pytest.approx(4.0311, abs=1e-3)
    assert (out / "saved_models" / "model_stage_1_iter_1.pth").exists()
    assert (out / "saved_models" / "training_state_latest.pth").exists()
    j_model, _ = jvol.load_volumetric_model(final)
    np.testing.assert_array_equal(np.asarray(j_model.grid.densities), model.grid.densities.numpy())
    test_set = TDataset(tiny_scene / "test", tiny_scene / "test_camera_params.json", rgba_white_bkgd=True, device="cpu")
    metrics = t_tester(model, test_set)
    assert np.isfinite(metrics["psnr"]) and 0.0 < metrics["ssim"] <= 1.0
    # at its default fast_debug_mode False the CLI also draws the camera rays
    # and writes feedback (the file names are held in test_torch_recon_outputs.py)
    tcli.main(["-d", str(tiny_scene), "-o", str(tmp_path / "default"), "--num_stages", "1", "--grid_dims", "8", "8",
               "8", "--num_iterations_per_stage", "1", "--render_num_samples_per_ray", "64", "--device", "cpu"])
    assert (tmp_path / "default" / "camera_rays.png").exists()
    assert (tmp_path / "default" / "training_logs" / "rendered_output" / "default_iter_1.png").exists()
    # two steps a call: 3 iterations are a call of 2 and one of 1, each
    # ending in a snapshot (the first call and the last)
    kstep = tmp_path / "kstep"
    tcli.main(["-d", str(tiny_scene), "-o", str(kstep), "--num_stages", "1", "--grid_dims", "8", "8", "8",
               "--num_iterations_per_stage", "3", "--fast_debug_mode", "True", "--steps_per_call", "2",
               "--device", "cpu"])
    assert sorted(p.name for p in (kstep / "saved_models").glob("model_stage_*")) == [
        "model_stage_1_iter_2.pth", "model_stage_1_iter_3.pth"]
