"""Parity of the PyTorch port's render path against voxe_tpu on the CPU:
spherical harmonics, the cubic shear-warp path and orient_base_image.

Inputs are made with numpy from a seed and fed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxe_tpu.grid import voxels as jvox
from voxe_tpu.render import sh as jsh
from voxe_tpu.render import shearwarp as jsw
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.utils.camera import CameraBounds as JBounds
from voxe_tpu.utils.camera import CameraPose as JPose
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.render import sh as tsh
from voxe_tpu_torch.render import shearwarp as tsw
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.utils.camera import CameraBounds as TBounds
from voxe_tpu_torch.utils.camera import CameraPose as TPose
from voxe_tpu_torch.utils.camera import pose_spherical

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

RES = 16
BASE = (24, 24)
# eyes near each of the six axis directions (z is up; pitch 90 is level) (slightly off-axis so the
# dominant axis is unambiguous): every (marching axis, direction) pair
SIX_POSES = [(10.0, 85.0), (100.0, 85.0), (190.0, 85.0), (280.0, 85.0), (10.0, 5.0), (10.0, 175.0)]


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics_parity(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.standard_normal((7, 5, 3, (degree + 1) ** 2)).astype(np.float32)
    dirs = rng.standard_normal((7, 5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = np.asarray(jsh.evaluate_spherical_harmonics(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    out = tsh.evaluate_spherical_harmonics(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs)).numpy()
    # same polynomial, same order of operations in f32: float rounding only
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _grids(gather_dtype, sh_degree=1, seed=0):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(-1.0, 1.0, (RES, RES, RES, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (RES, RES, RES, 3 * (sh_degree + 1) ** 2)).astype(np.float32)
    kw = dict(
        density_preactivation="identity", density_postactivation="softplus",
        gather_dtype=gather_dtype, expected_density_scale=3.0,
    )
    jcfg = jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*[3.0 / RES] * 3), **kw)
    tcfg = tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*[3.0 / RES] * 3), **kw)
    jg = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats), jcfg)
    tg = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats), tcfg)
    return jg, tg


JCFG = JRenderConfig(num_samples_per_ray=64, camera_bounds=JBounds(0.5, 10.0), white_bkgd=True)
TCFG = TRenderConfig(num_samples_per_ray=64, camera_bounds=TBounds(0.5, 10.0), white_bkgd=True)


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_shearwarp_parity_all_branches(gather_dtype):
    """Colour, depth, acc and the grid gradient of a weighted colour sum,
    for poses that hit all six marching orientations (both flip_k)."""
    jg, tg = _grids(gather_dtype)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((BASE[0] * BASE[1], 3)).astype(np.float32)
    # f32: same arithmetic in another summation order -> float rounding.
    # bf16 gather: both sides resample a bf16 table, but XLA:CPU keeps the
    # density resample's f32 result while torch rounds each bf16 matmul
    # output once more (relative 2^-8), so allow bf16-level error.
    tol = dict(rtol=1e-4, atol=1e-4) if gather_dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    seen = set()
    for yaw, pitch in SIX_POSES:
        pose = pose_spherical(yaw, pitch, 4.0)
        jout, jgeom = jsw.render_shear_warp(jg, JPose(*pose), JCFG, base_hw=BASE)

        def jloss(d, f):
            o, _ = jsw.render_shear_warp(jg.replace(densities=d, features=f), JPose(*pose), JCFG, base_hw=BASE)
            return jnp.sum(o.colour * w)

        jgd, jgf = jax.grad(jloss, argnums=(0, 1))(jg.densities, jg.features)

        d = tg.densities.clone().requires_grad_(True)
        f = tg.features.clone().requires_grad_(True)
        tout, tgeom = tsw.render_shear_warp(tg.replace(densities=d, features=f), TPose(*pose), TCFG, base_hw=BASE)
        (tout.colour * torch.from_numpy(w)).sum().backward()
        seen.add(tgeom.perm_index)
        assert tgeom.perm_index == int(jgeom.perm_index)

        np.testing.assert_allclose(tout.colour.detach().numpy(), np.asarray(jout.colour), **tol)
        np.testing.assert_allclose(tout.depth.detach().numpy(), np.asarray(jout.depth), **tol)
        np.testing.assert_allclose(
            tout.extra["accumulated_weight"].detach().numpy(),
            np.asarray(jout.extra["accumulated_weight"]), **tol,
        )
        np.testing.assert_allclose(tgeom.dirs.numpy(), np.asarray(jgeom.dirs), rtol=1e-5, atol=1e-5)
        for tgrad, jgrad in ((d.grad, jgd), (f.grad, jgf)):
            scale = float(np.abs(np.asarray(jgrad)).max())
            assert scale > 0.0
            err = float(np.abs(tgrad.numpy() - np.asarray(jgrad)).max())
            # gradients compared relative to their largest entry
            assert err <= tol["atol"] * scale, (yaw, pitch, err, scale)
    assert seen == set(range(6)), seen


@pytest.mark.parametrize("hw", [(6, 6), (6, 4)])
def test_orient_base_image_each_branch(hw):
    """Square images may transpose, non-square only flip: every branch."""
    img = np.arange(hw[0] * hw[1] * 3, dtype=np.float32).reshape(*hw, 3)
    poses = SIX_POSES + [(55.0, 30.0), (235.0, 40.0), (145.0, 70.0)]
    for yaw, pitch in poses:
        rot = pose_spherical(yaw, pitch, 4.0).rotation
        ref = np.asarray(jsw.orient_base_image(jnp.asarray(img), jnp.asarray(rot)))
        out = tsw.orient_base_image(torch.from_numpy(img), torch.from_numpy(rot)).numpy()
        np.testing.assert_array_equal(out, ref)


def test_lane_aligned_res_matches():
    for n in (24, 100, 384, 400, 512, 1000):
        assert tsw.lane_aligned_res(n) == jsw.lane_aligned_res(n)


def test_config_fields_match():
    """The port's configs carry the same fields and defaults."""
    assert [f.name for f in dataclasses.fields(tvox.VoxelGridConfig)] == [
        f.name for f in dataclasses.fields(jvox.VoxelGridConfig)
    ]
    assert [f.name for f in dataclasses.fields(TRenderConfig)] == [
        f.name for f in dataclasses.fields(JRenderConfig)
    ]


@pytest.mark.parametrize("fused", [False, True])
def test_density_noise_matches_jax(fused):
    """Density noise (std 0.5) on the streamed tail and the monolithic tail
    (fused compositing): the JAX key's [N, S] draw passed in as
    `density_noise`, from a positive and a negative marching direction (the
    streamed tail reads the draw reversed there). Colour, the diffuse colour
    (which shares the draw), depth and acc in f32; the noise changes the
    render, and without a draw or a generator the call raises."""
    jg, tg = _grids("float32")
    jcfg = JCFG.replace(stochastic_density_noise_std=0.5, use_fused_kernel=fused)
    tcfg = TCFG.replace(stochastic_density_noise_std=0.5, use_fused_kernel=fused)
    directions = set()
    for i, (yaw, pitch) in enumerate(SIX_POSES[:3:2]):  # the same axis, both directions
        pose = pose_spherical(yaw, pitch, 4.0)
        key = jax.random.PRNGKey(10 + i)
        jout, jgeom = jsw.render_shear_warp(jg, JPose(*pose), jcfg, base_hw=BASE, key=key, with_diffuse=True)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (BASE[0] * BASE[1], RES), jnp.float32)))
        tout, tgeom = tsw.render_shear_warp(tg, TPose(*pose), tcfg, base_hw=BASE, with_diffuse=True,
                                            density_noise=noise)
        assert tgeom.perm_index == int(jgeom.perm_index)
        directions.add(tgeom.perm_index % 2)
        for name, t, j in (("colour", tout.colour, jout.colour),
                           ("diffuse", tout.extra["diffuse_colour"], jout.extra["diffuse_colour"]),
                           ("depth", tout.depth, jout.depth),
                           ("acc", tout.extra["accumulated_weight"], jout.extra["accumulated_weight"])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=name)
        clean, _ = tsw.render_shear_warp(tg, TPose(*pose), TCFG.replace(use_fused_kernel=fused), base_hw=BASE)
        assert float((clean.colour - tout.colour).abs().max()) > 1e-2
    assert directions == {0, 1}
    with pytest.raises(ValueError, match="Generator"):
        tsw.render_shear_warp(tg, TPose(*pose), tcfg, base_hw=BASE)
    gen_out, _ = tsw.render_shear_warp(tg, TPose(*pose), tcfg, base_hw=BASE, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(gen_out.colour).all()
