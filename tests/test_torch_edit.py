"""Parity of the port's edit CLI path against voxe_tpu on the CPU: the host
pose draw and dataset directions, the hemisphere guard, the shear-warp
screen render (both tails, diffuse-only) and its use in
`VolumetricModel.render`, the feedback images, the dataset-pose and exact
edit steps (gradients, draws replayed), the editing loop (random-pose and
uncoupled modes, SDS off, so both runs are deterministic), and the CLI's
flags and a tiny run. The loop's steps_per_call > 1 branches are in
test_torch_edit_fused.py.

Inputs are made with numpy from a seed and fed to both packages; draws that
JAX makes with `jax.random` are replayed into the port."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_recon import _capture
from tests.test_torch_sd import _numpy_params
from voxe_tpu.data.dataset import PosedImagesDataset as JDataset
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models import volumetric as jvol
from voxe_tpu.models.sd.config import tiny_test_config as j_tiny
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.render import shearwarp as jsw
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.render.rays import cast_rays as j_cast_rays
from voxe_tpu.render.rays import flatten_rays as j_flatten_rays
from voxe_tpu.train import sds as jsds
from voxe_tpu.utils import camera as jcam
from voxe_tpu.viz import static as jstatic
from voxe_tpu_torch.cli import edit_pretrained_relu_field as tcli
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as trecon_cli
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.models.sd.config import tiny_test_config as t_tiny
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.render import shearwarp as tsw
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.render.rays import cast_rays as t_cast_rays
from voxe_tpu_torch.render.rays import flatten_rays as t_flatten_rays
from voxe_tpu_torch.train import sds as tsds
from voxe_tpu_torch.utils import camera as tcam
from voxe_tpu_torch.viz import static as tstatic

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRID_KW = dict(density_preactivation="identity", density_postactivation="softplus", expected_density_scale=3.0)


def _grids(dims, sh_degree=0, seed=0, world=3.0):
    """The same f32 grid in both packages (values uniform in [-1, 1])."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(-1, 1, (*dims, 1)).astype(np.float32)
    feats = rng.uniform(-1, 1, (*dims, 3 * (sh_degree + 1) ** 2)).astype(np.float32)
    vs = [world / d for d in dims]
    jg = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats), jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs), **GRID_KW))
    # copies: the port trains in place, and a jax array may share numpy's buffer
    tg = tvox.VoxelGrid(torch.tensor(dens), torch.tensor(feats), tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), **GRID_KW))
    return jg, tg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_host_pose_draw_and_dataset_directions_match_jax():
    """The same numpy seed draws the same hemisphere poses (bitwise) and
    labels; dataset poses bucket into the same directions."""
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    poses = []
    for _ in range(30):
        (jp, jd, jpi, jy), (tp, td, tpi, ty) = jcam.get_random_pose(4.0311, rj), tcam.get_random_pose(4.0311, rt)
        np.testing.assert_array_equal(tp.rotation, jp.rotation)
        np.testing.assert_array_equal(tp.translation, jp.translation)
        assert (td, tpi, ty) == (jd, jpi, jy)
        poses.append(np.concatenate([tp.rotation, tp.translation], 1))
    poses = np.stack(poses)
    assert tsds.get_dir_batch_from_poses(poses) == jsds.get_dir_batch_from_poses(poses)
    assert len(set(tsds.get_dir_batch_from_poses(poses))) >= 3


@pytest.mark.parametrize("world,radius", [(3.0, 4.0311), (6.5, 4.0311), ((3.0, 3.0, 7.5), 4.0311), (3.0, 2.5)])
def test_hemisphere_guard_matches_jax(world, radius):
    """Raises exactly when the JAX guard raises: a grid that fits inside the
    camera sphere, a wide one, a tall one, a camera sphere that is too small."""
    world = (world,) * 3 if isinstance(world, float) else world
    dims = (16, 16, 16)
    vs = [w / d for w, d in zip(world, dims)]
    jg = jvox.VoxelGrid(jnp.zeros((*dims, 1)), jnp.zeros((*dims, 3)), jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs)))
    tg = tvox.VoxelGrid(torch.zeros((*dims, 1)), torch.zeros((*dims, 3)), tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs)))
    outcomes = []
    for fn, g in ((jsw.check_shear_warp_hemisphere, jg), (tsw.check_shear_warp_hemisphere, tg)):
        try:
            fn(g, radius, "test")
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e).split(" voxels")[0])  # the margin the message reports
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (world == (3.0,) * 3 and radius > 4.0)


INTR = (20, 24, 24.0)  # H, W, focal: a non-square screen (base lattice 48^2 by default)
SCREEN_CFG = dict(num_samples_per_ray=48, white_bkgd=True, render_num_samples_per_ray=48)


@pytest.mark.parametrize("fused,diffuse", [(False, False), (False, True), (True, True)])
def test_screen_render_matches_jax(fused, diffuse):
    """`render_shear_warp_to_screen` (streamed and monolithic tails,
    `render_diffuse` through diffuse_only) and `VolumetricModel.render(
    use_shear_warp=True)` against JAX's model render, f32, SH degree 1; a
    pose inside the AABB falls back to the exact renderer in both."""
    jg, tg = _grids((16, 16, 16), sh_degree=1, seed=1)
    cfg = dict(SCREEN_CFG, use_fused_kernel=fused, render_diffuse=diffuse)
    jm = jvol.VolumetricModel(jg, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg))
    tm = tvol.VolumetricModel(tg, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg))
    pose = jcam.pose_spherical(130.0, 60.0, 4.0)
    jo = jm.render(jcam.CameraIntrinsics(*INTR), pose, use_shear_warp=True)
    for to in (tsw.render_shear_warp_to_screen(tg, pose, tcam.CameraIntrinsics(*INTR), tm.render_config),
               tm.render(tcam.CameraIntrinsics(*INTR), pose, use_shear_warp=True)):
        assert to.colour.shape == (20, 24, 3)
        # f32 both sides: resample matmuls and the composite in other orders
        np.testing.assert_allclose(to.colour.numpy(), np.asarray(jo.colour), atol=1e-5)
        np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), atol=1e-4)
        acc = np.asarray(jo.extra["accumulated_weight"])
        np.testing.assert_allclose(to.extra["accumulated_weight"].numpy(), acc, atol=1e-5)
        # disparity runs to ~1e9 on empty base pixels and the screen warp blends
        # that into their neighbours: compare where it is an inverse depth
        jd = np.asarray(jo.extra["disparity"])
        real = jd < 100.0
        assert real.mean() > 0.5
        np.testing.assert_allclose(to.extra["disparity"].numpy()[real], jd[real], rtol=1e-4)
        assert set(to.extra) == set(jo.extra)
    if diffuse:  # the diffuse render differs from the full-SH one
        full = tsw.render_shear_warp_to_screen(tg, pose, tcam.CameraIntrinsics(*INTR), tm.render_config.replace(render_diffuse=False))
        assert float((full.colour - to.colour).abs().max()) > 1e-3
    if not (fused or diffuse):
        inside = jcam.pose_spherical(40.0, 70.0, 1.0)  # the eye is inside the grid
        jr = jm.render(jcam.CameraIntrinsics(*INTR), inside, use_shear_warp=True)
        tr = tm.render(tcam.CameraIntrinsics(*INTR), inside, use_shear_warp=True)
        np.testing.assert_allclose(tr.colour.numpy(), np.asarray(jr.colour), atol=1e-4)


def test_feedback_images_match_jax(tmp_path):
    """`postprocess_depth_map` is bitwise JAX's (the magma table is
    matplotlib's); the feedback PNGs have JAX's names and pixels within one
    8-bit level on the colour panel."""
    rng = np.random.default_rng(2)
    depth = rng.uniform(2, 6, (12, 10, 1)).astype(np.float32)
    acc = rng.uniform(0, 1, (12, 10, 1)).astype(np.float32)
    np.testing.assert_array_equal(tstatic.postprocess_depth_map(depth, acc), jstatic.postprocess_depth_map(depth, acc))
    np.testing.assert_array_equal(tstatic.postprocess_depth_map(depth), jstatic.postprocess_depth_map(depth))

    from PIL import Image

    jg, tg = _grids((16, 16, 16), sh_degree=1, seed=1)  # the screen test's grid: its JAX programs are reused
    pose = jcam.pose_spherical(30.0, 50.0, 4.0)
    for pkg, vis, cam, model in (
        ("jax", jstatic, jcam, jvol.VolumetricModel(jg, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **SCREEN_CFG))),
        ("torch", tstatic, tcam, tvol.VolumetricModel(tg, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **SCREEN_CFG))),
    ):
        vis.visualize_sh_vox_grid_vol_mod_rendered_feedback(
            model, "sds", pose, cam.CameraIntrinsics(*INTR), 7, tmp_path / pkg, use_shear_warp=True,
        )
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "torch")) == [
        "sds_diffuse_iter_7.png", "sds_iter_7.png"]
    for name in ("sds_diffuse_iter_7.png", "sds_iter_7.png"):
        j = np.asarray(Image.open(tmp_path / "jax" / name), np.int32)
        t = np.asarray(Image.open(tmp_path / "torch" / name), np.int32)
        assert j.shape == t.shape
        assert np.abs(t[:, :24] - j[:, :24]).max() <= 1


# ---------------------------------------------------------------------------
# edit steps, gradients with replayed draws
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd_pair():
    """The JAX tiny SD at 32^2 (16^2 latents) in f32 (shape-only init) and
    the port with the same seeded numpy parameters."""
    jsd = JSD(config=j_tiny(image_size=32), unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=11)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD(config=t_tiny(image_size=32), unet_dtype=torch.float32, device="cpu")
    tsd.load_flax_params(params)
    return jsd, tsd


def _jax_grads(jstep, jopt, jg, *args):
    new, state, jm = jstep(jg, jopt.init(jg), *args)
    return state[0], jm


def _check_grads(tgrid, jgrad, tol):
    for t, j in ((tgrid.densities.grad, jgrad.densities), (tgrid.features.grad, jgrad.features)):
        assert float(np.abs(np.asarray(j)).max()) > 0.0
        assert _rel(t.numpy(), j) < tol, _rel(t.numpy(), j)


def _t_grid(tg):
    return tg.replace(densities=tg.densities.clone(), features=tg.features.clone())


@pytest.mark.parametrize("uncoupled", [False, True])
def test_data_pose_step_gradients_match_jax(sd_pair, uncoupled):
    """`make_sds_train_step_shearwarp_data` with 2 dataset poses a step:
    data-pose mode with SDS (both frames in one SD batch, its draws
    replayed) and density correlation; uncoupled mode with the masked L1
    against base-plane targets averaged over the frames (SDS off: its route
    is the one data-pose mode holds)."""
    jsd, tsd = sd_pair
    jg, tg = _grids((16, 16, 16), seed=4)
    rng = np.random.default_rng(5)
    base = (24, 24)
    poses = np.stack([np.concatenate(jcam.pose_spherical(y, p, 4.0311), 1) for y, p in ((30, 60), (200, 75))])
    pix = rng.uniform(0, 1, (2, *base, 3)).astype(np.float32)
    msk = (rng.random((2, *base)) > 0.3).astype(np.float32)
    ref_d = (np.asarray(jg.densities) + 0.1 * rng.standard_normal((16, 16, 16, 1))).astype(np.float32)
    cfg = dict(num_samples_per_ray=48, white_bkgd=True)
    kw = dict(do_sds=not uncoupled, guidance_scale=100.0, density_correlation_weight=200.0, uncoupled_mode=uncoupled)
    jopt = optax.chain(_capture(), optax.adam(0.03))
    jstep = jsds.make_sds_train_step_shearwarp_data(
        jsd, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, base, 2, **kw
    )
    prompt, key, t = "a dog wearing a hat, side view", jax.random.PRNGKey(6), 600
    text = jsd.get_text_embeds(prompt)
    jgrad, jm = _jax_grads(
        jstep, jopt, jg, jsd.params, text, jnp.asarray(poses[:, :, :3]), jnp.asarray(poses[:, :, 3:]),
        jnp.asarray(pix), jnp.asarray(msk), jnp.asarray(ref_d), jg.features, key, jnp.asarray(t),
    )
    _, k_sds = jax.random.split(key)
    k_enc, k_noise = jax.random.split(k_sds)
    vae_eps = torch.from_numpy(np.asarray(jax.random.normal(k_enc, (2, 16, 16, 4), jnp.float32)))
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_noise, (2, 16, 16, 4), jnp.float32)))

    grid = _t_grid(tg)
    opt = tsds.make_adam(grid, 0.03)
    step = tsds.make_sds_train_step_shearwarp_data(
        tsd, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt, base, 2, **kw
    )
    tp = torch.from_numpy(poses.astype(np.float32))
    tm = step(grid, tsd.get_text_embeds(prompt), tp[:, :, :3], tp[:, :, 3:], torch.from_numpy(pix),
              torch.from_numpy(msk), torch.from_numpy(ref_d), tg.features, t, noise=noise, vae_eps=vae_eps)
    name = "specular_loss" if uncoupled else "density_correlation_loss"
    np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, atol=1e-6)
    # f32 both sides; guidance 100 scales the UNet's rounding: 1e-3 of max
    _check_grads(grid, jgrad, 1e-4 if uncoupled else 1e-3)


def test_exact_step_gradients_match_jax(sd_pair):
    """`make_sds_train_step` on the exact renderer in uncoupled mode: one
    8x8 frame, the sampling jitter replayed. SDS is off here (its route
    from the frames is the one the shear-warp steps above hold)."""
    jsd, tsd = sd_pair
    jg, tg = _grids((12, 12, 12), seed=7)
    rng = np.random.default_rng(8)
    intr, S = (8, 8, 9.0), 32
    pose = jcam.pose_spherical(70.0, 55.0, 4.0)
    pixels = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    cfg = dict(num_samples_per_ray=S, white_bkgd=True)
    kw = dict(do_sds=False, density_correlation_weight=200.0, uncoupled_mode=True)
    jopt = optax.chain(_capture(), optax.adam(0.03))
    jstep = jsds.make_sds_train_step(
        jsd, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, intr[:2], **kw
    )
    rays = j_flatten_rays(j_cast_rays(jcam.CameraIntrinsics(*intr), jnp.asarray(pose.rotation), jnp.asarray(pose.translation)))
    prompt, key, t = "a dog wearing a hat, front view", jax.random.PRNGKey(9), 300
    jgrad, jm = _jax_grads(
        jstep, jopt, jg, jsd.params, jsd.get_text_embeds(prompt), rays, jnp.asarray(pixels),
        jg.densities, jg.features, key, jnp.asarray(t),
    )
    k_render, _ = jax.random.split(key)
    sample_key, _ = jax.random.split(k_render)  # render/interface.py: sample key, noise key
    t_rand = torch.from_numpy(np.array(jax.random.uniform(sample_key, (64, S), dtype=jnp.float32)))

    grid = _t_grid(tg)
    opt = tsds.make_adam(grid, 0.03)
    step = tsds.make_sds_train_step(tsd, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt, intr[:2], **kw)
    trays = t_flatten_rays(t_cast_rays(tcam.CameraIntrinsics(*intr), pose.rotation, pose.translation))
    tm = step(grid, tsd.get_text_embeds(prompt), trays, torch.from_numpy(pixels), tg.densities, tg.features, t,
              t_rand=t_rand)
    np.testing.assert_allclose(float(tm["specular_loss"]), float(jm["specular_loss"]), rtol=1e-5, atol=1e-6)
    _check_grads(grid, jgrad, 1e-4)  # f32 render and L1 only


# ---------------------------------------------------------------------------
# the editing loop and the CLI
# ---------------------------------------------------------------------------


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


def _run_drivers(out, scene, sd_pair, **overrides):
    """Both editing loops on the tiny scene with SDS off and density
    correlation weight 200, from the same grids; returns (JAX model, port
    model, starting densities)."""
    jsd, tsd = sd_pair
    ds_kw = dict(images_dir=scene / "train", camera_params_json=scene / "train_camera_params.json",
                 rgba_white_bkgd=True)
    jds, tds = JDataset(**ds_kw), TDataset(device="cpu", **ds_kw)
    # the edited grid starts away from the reference: at the reference the
    # correlation gradient is zero and Adam's first step would follow its rounding
    jref, tref = _grids((16, 16, 16), seed=10)
    jsds_g, tsds_g = _grids((16, 16, 16), seed=12)
    cfg = dict(num_samples_per_ray=48, white_bkgd=True)
    kw = dict(
        num_iterations=4, ray_batch_size=2 * 32 * 32, learning_rate=0.03, lr_decay_start=1, lr_freq=1, lr_gamma=0.5, save_freq=2,
        summary_freq=1, sds_prompt="a dog wearing a hat", new_frame_frequency=2, density_correlation_weight=200.0,
        do_sds=False, seed=5, fast_debug_mode=True, shear_warp_base_res=32,
    )
    kw.update(overrides)
    jout = jsds.train_sh_vox_grid_vol_mod_with_posed_images_and_sds(
        jvol.VolumetricModel(jsds_g, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg)),
        jvol.VolumetricModel(jref, JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg)),
        jds, (32, 32), out / "jax", sd_model=jsd, **kw,
    )
    tout = tsds.train_sh_vox_grid_vol_mod_with_posed_images_and_sds(
        tvol.VolumetricModel(tsds_g, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg)),
        tvol.VolumetricModel(tref, TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg)),
        tds, (32, 32), out / "torch", sd_model=tsd, **kw,
    )
    return jout, tout, np.asarray(jsds_g.densities)


def _check_driver_outputs(out, jout, tout, start, snapshots):
    names = sorted(os.listdir(out / "jax" / "saved_models"))
    assert names == sorted(os.listdir(out / "torch" / "saved_models")) == snapshots
    for j, t in ((jout.grid.densities, tout.grid.densities), (jout.grid.features, tout.grid.features)):
        # Adam steps of up to lr = 0.03 each from f32 gradients. Adam's
        # update lr * g / (|g| + eps) amplifies the rounding of a small
        # gradient entry, so a few entries drift further than the rest:
        # 1e-4 (1e-3 of the ~0.1 move) everywhere, 1e-5 on 99.9 % of entries
        diff = np.abs(t.numpy() - np.asarray(j))
        assert diff.max() <= 1e-4 and (diff > 1e-5).mean() <= 1e-3, (diff.max(), (diff > 1e-5).mean())
    assert np.abs(np.asarray(jout.grid.densities) - start).max() > 0.01


@pytest.mark.parametrize("mode", ["random", "uncoupled"])
def test_edit_loop_matches_jax(tmp_path, tiny_scene, sd_pair, mode):
    """The editing loop in both packages with SDS off and density
    correlation weight 200: the same seed draws the same hemisphere poses
    (random mode) or dataset batches (uncoupled mode: the masked L1 of 2
    shear-warp frames a step), so the runs are deterministic. 4 steps with
    the lr halving after step 1 and a new frame every 2 steps; the final
    grids agree, the same snapshots are written, and the port's
    model_final.pth loads in the JAX package."""
    jout, tout, start = _run_drivers(tmp_path, tiny_scene, sd_pair, uncoupled_mode=mode == "uncoupled")
    _check_driver_outputs(tmp_path, jout, tout, start,
                          ["model_final.pth", "model_iter_1.pth", "model_iter_2.pth", "model_iter_4.pth"])
    loaded, info = jvol.load_volumetric_model(tmp_path / "torch" / "saved_models" / "model_final.pth")
    np.testing.assert_array_equal(np.asarray(loaded.grid.densities), tout.grid.densities.numpy())
    tds = TDataset(images_dir=tiny_scene / "train", camera_params_json=tiny_scene / "train_camera_params.json",
                   rgba_white_bkgd=True, device="cpu")
    assert info["hemispherical_radius"] == pytest.approx(tds.get_hemispherical_radius_estimate())


def test_cli_flags_match_click_command():
    """Every flag of edit_pretrained_relu_field.py with its short name and
    default; the port adds `--device` only."""
    import edit_pretrained_relu_field as jcli

    click_opts = {p.name: (sorted(p.opts), p.required, None if p.required else p.default) for p in jcli.main.params}
    port_opts = {
        a.dest: (sorted(a.option_strings), a.required, a.default)
        for a in tcli.build_parser()._actions if a.dest != "help"
    }
    assert port_opts.pop("device") == (["--device"], False, "cuda")
    for name in ("grid_dims", "grid_location", "grid_world_size"):
        port_opts[name] = (*port_opts[name][:2], tuple(port_opts[name][2]))
    assert port_opts == click_opts


def test_cli_tiny_end_to_end(tmp_path, tiny_scene):
    """The recon CLI then the edit CLI on the CPU with the tiny SD: feedback
    PNGs and checkpoints written, a model_final.pth that both packages read;
    refinement without its token indices or SD 1.4 weights is refused
    before the edit; with `--steps_per_call 2` the refinement runs two
    iterations a call; the multi-device flags raise."""
    trecon_cli.main([
        "-d", str(tiny_scene), "-o", str(tmp_path / "recon"), "--grid_dims", "16", "16", "16", "--num_stages", "1",
        "--num_iterations_per_stage", "2", "--fast_debug_mode", "True", "--use_fused_kernel", "True", "--device", "cpu",
    ])
    ref = tmp_path / "recon" / "saved_models" / "model_final.pth"
    args = ["-i", str(ref), "-o", str(tmp_path / "edit"), "-p", "a dog wearing a hat", "-d", str(tiny_scene),
            "--data_downsample_factor", "1", "--sd_version", "tiny", "--device", "cpu"]
    model = tcli.main(args + ["--num_iterations_edit", "3", "--feedback_frequency", "2", "--save_frequency", "2",
                              "--fast_debug_mode", "False"])
    renders = sorted(os.listdir(tmp_path / "edit" / "training_logs" / "rendered_output"))
    assert renders == [f"sds_{kind}iter_{i}.png" for kind in ("diffuse_", "") for i in (1, 2, 3)]
    final, _ = tvol.load_volumetric_model(tmp_path / "edit" / "saved_models" / "model_final.pth", device="cpu")
    assert final.render_config.use_fused_kernel and torch.equal(final.grid.densities, model.grid.densities)
    before, _ = tvol.load_volumetric_model(ref, device="cpu")
    assert float((final.grid.densities - before.grid.densities).abs().max()) > 0.0
    j_model, _ = jvol.load_volumetric_model(tmp_path / "edit" / "saved_models" / "model_final.pth")
    np.testing.assert_array_equal(np.asarray(j_model.grid.densities), final.grid.densities.numpy())
    assert dataclasses.asdict(j_model.render_config)["use_fused_kernel"]
    # refinement needs the edit tokens and, with real SD weights, an SD 1.4
    # snapshot: both are refused before the edit starts (the refinement runs
    # themselves are in test_torch_refine_seg.py)
    for extra in (["--do_refinement", "True"],
                  ["--do_refinement", "True", "-eidx", "4", "--sd_version", "2.0", "--sd_weights_dir", str(tmp_path)]):
        with pytest.raises(SystemExit):
            tcli.main(args + extra)
    assert not (tmp_path / "edit" / "saved_models" / "model_final_refined.pth").exists()
    # --steps_per_call reaches the refinement, as in the JAX CLI: 3 refinement
    # iterations are calls ending at 2 and 3, and the K-step cadence
    # snapshots both, never iteration 1
    fused = ["-i", str(ref), "-o", str(tmp_path / "edit_fused"), "-p", "a dog wearing a hat", "-d", str(tiny_scene),
             "--data_downsample_factor", "1", "--sd_version", "tiny", "--device", "cpu", "--do_refinement", "True",
             "-eidx", "4", "--steps_per_call", "2", "--num_iterations_edit", "1", "--num_iterations_refine", "3",
             "--save_frequency", "2", "--fast_debug_mode", "True", "--min_num_edit_voxels", "10"]
    tcli.main(fused)
    saved = tmp_path / "edit_fused" / "saved_models"
    assert sorted(p.name for p in saved.glob("model_edit_iter_*")) == ["model_edit_iter_2.pth", "model_edit_iter_3.pth"]
    assert (saved / "model_final_refined.pth").exists()
    with pytest.raises(NotImplementedError, match="num_devices"):
        tcli.main(args + ["--num_devices", "2"])
