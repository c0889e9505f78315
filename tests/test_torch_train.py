"""Parity of the PyTorch port's edit step against voxe_tpu on the CPU: the
losses, the camera draw, Adam, and the whole shear-warp SDS step at tiny
size (tiny SD, 16^3 grid, fixed pose, t and random draws replayed)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_sd import _numpy_params
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import losses as jl
from voxe_tpu.train.sds import make_sds_train_step_shearwarp as j_make_step
from voxe_tpu.utils import camera as jcam
from voxe_tpu.utils.misc import compute_expected_density_scale_for_relu_field_grid as j_scale
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.sd.weights import voxel_grid_from_numpy
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import losses as tl
from voxe_tpu_torch.train import sds as tsds
from voxe_tpu_torch.utils import camera as tcam
from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid as t_scale

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

RES, BASE = 16, (24, 24)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def test_density_correlation_loss_value_and_grad():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 6, 5, 4, 1)).astype(np.float32)
    (jv, jgrid), jg = jax.value_and_grad(jl.density_correlation_loss, has_aux=True)(jnp.asarray(a), jnp.asarray(b))
    ta = _t(a, True)
    tv, tgrid = tl.density_correlation_loss(ta, _t(b))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-7)
    for mode in ("l2_mode", "l1_mode"):
        jm, _ = jl.density_correlation_loss_fn(jnp.asarray(a), jnp.asarray(b), **{mode: True})
        tm, _ = tl.density_correlation_loss_fn(_t(a), _t(b), **{mode: True})
        np.testing.assert_allclose(float(tm), float(jm), rtol=1e-5)


def test_tv_and_feature_correlation_losses():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    for jf, tf, args in (
        (jl.tv_loss_on_grid, tl.tv_loss_on_grid, (a,)),
        (jl.feature_correlation_loss, tl.feature_correlation_loss, (a, b)),
    ):
        jv, jg = jax.value_and_grad(jf)(*map(jnp.asarray, args))
        ta = _t(args[0], True)
        tv = tf(ta, *map(_t, args[1:]))
        tv.backward()
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_camera_pose_math_and_direction_bucket():
    for yaw, pitch in ((0.0, 30.0), (123.0, 70.0), (250.0, 20.0)):
        jp, tp = jcam.pose_spherical(yaw, pitch, 4.0), tcam.pose_spherical(yaw, pitch, 4.0)
        np.testing.assert_array_equal(jp.rotation, tp.rotation)
        np.testing.assert_array_equal(jp.translation, tp.translation)
    key = jax.random.PRNGKey(3)
    for k in jax.random.split(key, 8):
        rot, trans, pitch, yaw = jcam.random_pose_jax(k, 4.0311)
        trot, ttrans = tcam.pose_from_angles(_t(pitch), _t(yaw), 4.0311)
        np.testing.assert_allclose(trot.numpy(), np.asarray(rot), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ttrans.numpy(), np.asarray(trans), rtol=1e-5, atol=1e-5)
    # the JAX bucket (voxe_tpu/train/sds.py:498-501) on a lattice of angles
    for pitch in (10.0, 24.9, 25.1, 60.0, 89.0):
        for yaw in (0.0, 44.0, 46.0, 119.0, 121.0, 200.0, 239.0, 241.0, 314.0, 316.0):
            idx = 3
            idx = 0 if 45.0 < yaw < 315.0 else idx
            idx = 2 if 120.0 < yaw < 240.0 else idx
            idx = 1 if pitch < 25.0 else idx
            assert tcam.direction_index(pitch, yaw) == idx
    g = torch.Generator().manual_seed(0)
    draws = [tcam.random_pose(g, 4.0311, device="cpu") for _ in range(64)]
    pitches = np.array([float(d[2]) for d in draws])
    yaws = np.array([float(d[3]) for d in draws])
    assert pitches.min() >= 15.0 and pitches.max() < 90.0
    assert yaws.min() >= 0.0 and yaws.max() < 360.0
    assert t_scale((3.0, 3.0, 3.0)) == j_scale((3.0, 3.0, 3.0))


def test_adam_matches_optax_over_two_steps():
    """Bias correction and eps placement: two steps, gradients that include
    values near eps (first-step updates are ~lr*sign(g))."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((4, 4, 4, 1)).astype(np.float32)
    f0 = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    grads = []
    for s in range(2):
        gd, gf = rng.standard_normal((2, 4, 4, 4, 1)).astype(np.float32), None
        gd = gd[0] * np.where(rng.random((4, 4, 4, 1)) < 0.3, 1e-8, 1.0).astype(np.float32)
        gf = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
        grads.append((gd, gf))
    opt = optax.adam(0.03)
    params = (jnp.asarray(p0), jnp.asarray(f0))
    state = opt.init(params)
    grid = tvox.VoxelGrid(_t(p0), _t(f0))
    topt = tsds.make_adam(grid, 0.03)
    for gd, gf in grads:
        upd, state = opt.update((jnp.asarray(gd), jnp.asarray(gf)), state, params)
        params = optax.apply_updates(params, upd)
        grid.densities.grad, grid.features.grad = _t(gd), _t(gf)
        topt.step()
        # a few f32 ulps; eps inside the sqrt would be off by ~lr/2 on the
        # 1e-8 entries
        np.testing.assert_allclose(grid.densities.detach().numpy(), np.asarray(params[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grid.features.detach().numpy(), np.asarray(params[1]), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def edit_setup():
    jsd = JSD("tiny", unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=7)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD("tiny", unet_dtype=torch.float32, device="cpu")
    tsd.load_flax_params(params)
    rng = np.random.default_rng(8)
    dens = rng.uniform(-1.0, 1.0, (RES, RES, RES, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (RES, RES, RES, 3)).astype(np.float32)
    kw = dict(
        density_preactivation="identity", density_postactivation="softplus",
        expected_density_scale=3.0,
    )
    jg = jvox.VoxelGrid(
        jnp.asarray(dens), jnp.asarray(feats),
        jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*[3.0 / RES] * 3), **kw),
    )
    tcfg = tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*[3.0 / RES] * 3), **kw)
    return jsd, tsd, jg, dens, feats, tcfg


def test_edit_step_gradient_matches(edit_setup):
    """The whole edit step's grid gradient: render -> orient -> SDS (tiny
    SD, replayed draws) + 200 x density correlation. The JAX step runs with
    an optimizer that applies 1e6 x the gradient, which reads the gradient
    back out of the real jitted step."""
    jsd, tsd, jg, dens, feats, tcfg = edit_setup
    rng = np.random.default_rng(9)
    ref_d = dens + 0.1 * rng.standard_normal(dens.shape).astype(np.float32)
    pose = jcam.pose_spherical(40.0, 60.0, 4.0311)
    key, t, gs, w_dcl = jax.random.PRNGKey(21), 500, 100.0, 200.0
    prompt = "a dog made of yarn, side view"

    big = 1e6
    jopt = optax.scale(big)
    jstep = j_make_step(
        jsd, JRenderConfig(num_samples_per_ray=64, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True),
        jopt, BASE, guidance_scale=gs, density_correlation_weight=w_dcl,
    )
    text = jsd.get_text_embeds(prompt)
    new, _, jm = jstep(
        jg, jopt.init(jg), jsd.params, text, jnp.asarray(pose.rotation),
        jnp.asarray(pose.translation), jnp.asarray(ref_d), jg.features, key, jnp.asarray(t),
    )
    jgd = (np.asarray(new.densities, np.float64) - dens) / big
    jgf = (np.asarray(new.features, np.float64) - feats) / big

    k_render, k_sds = jax.random.split(key)  # train/sds.py:253
    k_enc, k_noise = jax.random.split(k_sds)  # models/sd/sds.py:242
    lat = (1, 32, 32, 4)
    vae_eps = torch.from_numpy(np.asarray(jax.random.normal(k_enc, lat, jnp.float32)))
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_noise, lat, jnp.float32)))

    grid = voxel_grid_from_numpy(dens, feats, tcfg, device="cpu")
    grid.densities.requires_grad_(True)
    grid.features.requires_grad_(True)
    rcfg = TRenderConfig(num_samples_per_ray=64, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True)
    total, tm = tsds.sds_edit_loss(
        grid, tsd, rcfg, BASE, tsd.get_text_embeds(prompt), _t(pose.rotation), _t(pose.translation),
        _t(ref_d), _t(feats), t, guidance_scale=gs, density_correlation_weight=w_dcl,
        noise=noise, vae_eps=vae_eps,
    )
    total.backward()
    # 1 - correlation: absolute error at the f32 ulp of 1
    np.testing.assert_allclose(
        float(tm["density_correlation_loss"]), float(jm["density_correlation_loss"]), atol=1e-6
    )
    for tg, jgrad in ((grid.densities.grad, jgd), (grid.features.grad, jgf)):
        scale = np.abs(jgrad).max()
        assert scale > 0.0
        # f32 on both sides; guidance 100 scales UNet rounding: 1e-3 of max
        assert np.abs(tg.numpy() - jgrad).max() < 1e-3 * scale


def test_multi_step_runs_and_updates(edit_setup):
    """K=2 steps through the entry point on the CPU: finite losses, the grid
    moves, and each step picks a direction bucket and t in bounds."""
    _, tsd, _, dens, feats, tcfg = edit_setup
    grid = tvox.VoxelGrid(_t(dens), _t(feats), tcfg)
    opt = tsds.make_adam(grid, 0.03)
    rcfg = TRenderConfig(num_samples_per_ray=64, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True)
    multi = tsds.make_sds_train_multi_step(
        tsd, rcfg, opt, tcam.CameraIntrinsics(*BASE, 24.0), 2,
        density_correlation_weight=200.0, use_shear_warp=True, sw_base_hw=BASE,
    )
    text_by_dir = torch.stack([tsd.get_text_embeds(f"a dog, {d} view") for d in ("side", "overhead", "back", "front")])
    before = grid.densities.detach().clone()
    m = multi(grid, text_by_dir, _t(dens), _t(feats), torch.tensor([[400, 600]] * 2), torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["total_loss"]))
    assert 400 <= m["t"] <= 600 and 0 <= m["dir_idx"] <= 3
    assert float((grid.densities.detach() - before).abs().max()) > 0.0
    assert dataclasses.is_dataclass(grid)
