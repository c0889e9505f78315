"""The port's feature-voxel model family (grid + MLP head) against voxe_tpu
on the CPU: the counterparts of tests/test_feature_voxels.py (query under an
identity head, MLP init, the densitynet gate, the render, training, scaling,
the checkpoint), each held against the JAX package where the two can be
compared: the query and the render with JAX's jitter replayed (1e-5), one
training step's gradients (1e-5 of their max), the resample (2e-6), and the
checkpoint files read in both directions bitwise."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxe_tpu.grid import feature_voxels as jfv
from voxe_tpu.render import interface as jif
from voxe_tpu.render.rays import Rays as JRays
from voxe_tpu.render.rays import cast_rays as j_cast_rays
from voxe_tpu.render.rays import flatten_rays as j_flatten_rays
from voxe_tpu.utils import camera as jcam
from voxe_tpu_torch.grid import feature_voxels as tfv
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize, grid_query
from voxe_tpu_torch.render import interface as tif
from voxe_tpu_torch.render.rays import Rays, cast_rays, flatten_rays
from voxe_tpu_torch.utils import camera as tcam

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_grid(res=6, num_features=4, seed=0, **cfg_kwargs):
    cfg = jfv.FeatureVoxelGridConfig(voxel_size=jfv.VoxelSize(*[3.0 / res] * 3), **cfg_kwargs)
    return jfv.create_feature_voxel_grid(jax.random.PRNGKey(seed), (res, res, res), num_features, cfg)


def _carry(jgrid) -> tfv.FeatureVoxelGrid:
    """The JAX grid's leaves and config in the port."""
    return tfv.feature_grid_from_leaves(
        jgrid.densities, jgrid.features, jgrid.rgbnet, jgrid.densitynet, jgrid.config.to_json_dict()
    )


def _port_grid(res=6, num_features=4, seed=0, **cfg_kwargs):
    cfg = tfv.FeatureVoxelGridConfig(voxel_size=VoxelSize(*[3.0 / res] * 3), **cfg_kwargs)
    return tfv.create_feature_voxel_grid(torch.Generator().manual_seed(seed), (res, res, res), num_features, cfg)


def test_identity_head_matches_plain_grid_query():
    """A one-layer identity rgbnet decodes to the plain VoxelGrid query on
    the same tensors (interpolation placement, pre/post activation order)."""
    res, F = 5, 3
    fv = _port_grid(res, F).replace(rgbnet=[(torch.eye(F), torch.zeros(F))])
    vg = VoxelGrid(fv.densities, fv.features, VoxelGridConfig(voxel_size=fv.config.voxel_size))
    pts = torch.from_numpy(np.random.default_rng(7).uniform(-1.2, 1.2, (64, 3)).astype(np.float32))
    torch.testing.assert_close(tfv.feature_grid_query(fv, pts), grid_query(vg, pts), rtol=0, atol=1e-6)


def test_mlp_init_shapes_and_zero_final_bias():
    params = tfv.init_mlp_params(torch.Generator().manual_seed(0), in_dim=8, width=64, depth=4, out_dim=3)
    assert [tuple(k.shape) for k, _ in params] == [(8, 64), (64, 64), (64, 64), (64, 3)]
    assert torch.count_nonzero(params[-1][1]) == 0
    assert float(params[0][0].abs().max()) <= 1.0 / np.sqrt(8)
    assert tfv.apply_mlp(params, torch.ones(10, 8)).shape == (10, 3)


@pytest.mark.parametrize("gather_dtype,use_densitynet", [("float32", False), ("float32", True), ("bfloat16", False)])
def test_query_matches_jax(gather_dtype, use_densitynet):
    """`feature_grid_query` on the JAX grid's leaves, inside and outside the
    AABB, with softplus / sigmoid activations; the bf16 table too."""
    kw = dict(gather_dtype=gather_dtype, use_densitynet=use_densitynet, density_postactivation="softplus",
              feature_postactivation="sigmoid", expected_density_scale=2.0)
    jgrid = _jax_grid(7, 5, seed=3, **kw)
    pts = np.random.default_rng(8).uniform(-1.8, 1.8, (300, 3)).astype(np.float32)
    ref = np.asarray(jfv.feature_grid_query(jgrid, jnp.asarray(pts)))
    out = tfv.feature_grid_query(_carry(jgrid), torch.from_numpy(pts)).numpy()
    assert _rel(out, ref) < 1e-5


def test_densitynet_gate():
    """use_densitynet routes the interpolated density through the head (a
    2x scaling head doubles it)."""
    fv = _port_grid(use_densitynet=True).replace(densitynet=[(torch.full((1, 1), 2.0), torch.zeros(1))])
    off = fv.replace(config=tfv.FeatureVoxelGridConfig(voxel_size=fv.config.voxel_size, use_densitynet=False))
    pts = torch.zeros(4, 3)
    torch.testing.assert_close(
        tfv.feature_grid_query(fv, pts)[..., -1], 2.0 * tfv.feature_grid_query(off, pts)[..., -1], rtol=1e-5, atol=0
    )


def _rays(size=16, focal=10.0):
    pose = jcam.pose_spherical(30.0, 45.0, 4.0)
    jrays = j_flatten_rays(j_cast_rays(jcam.CameraIntrinsics(size, size, focal), jnp.asarray(pose.rotation),
                                       jnp.asarray(pose.translation)))
    trays = flatten_rays(cast_rays(tcam.CameraIntrinsics(size, size, focal), torch.from_numpy(np.asarray(pose.rotation)),
                                   torch.from_numpy(np.asarray(pose.translation))))
    return jrays, trays


def test_render_end_to_end_and_matches_jax():
    """A 16^2 render: finite colour in [0, 1] on a white background; against
    JAX's with its jitter draw replayed (`t_rand`), colour and depth within
    1e-5."""
    jgrid = _jax_grid(8, 4, seed=1)
    jrays, trays = _rays()
    np.testing.assert_allclose(trays.origins.numpy(), np.asarray(jrays.origins), atol=1e-6)
    cfg = dict(num_samples_per_ray=48, white_bkgd=True)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda g, r: jif.render_feature_voxel_grid(
        g, r, jif.SHVoxGridRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), key=key))(jgrid, jrays)
    t_rand = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key)[0], (16 * 16, 48))))
    out = tif.render_feature_voxel_grid(
        _carry(jgrid), trays, tif.SHVoxGridRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), t_rand=t_rand)
    img = out.colour.numpy()
    assert img.shape == (256, 3) and np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    for name in ("colour", "depth"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=1e-5)


def _train_rays():
    return (np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (64, 1)),
            np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (64, 1)))


def test_one_training_step_gradients_match_jax():
    """The gradient of an MSE render loss with respect to the grid and both
    heads' tensors, against `jax.grad` of the same loss, within 1e-5 of each
    leaf's max; densitynet (off) gets none in either."""
    jgrid = _jax_grid(6, 4, seed=2)
    o, d = _train_rays()
    jcfg = jif.SHVoxGridRenderConfig(num_samples_per_ray=32, camera_bounds=jcam.CameraBounds(2.0, 6.0))
    target = np.full((64, 3), 0.8, np.float32)

    def jloss(g):
        return jnp.mean((jif.render_feature_voxel_grid(g, JRays(jnp.asarray(o), jnp.asarray(d)), jcfg).colour - target) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(jgrid)
    grid = _carry(jgrid)
    for t in grid.parameters():
        t.requires_grad_(True)
    tcfg = tif.SHVoxGridRenderConfig(num_samples_per_ray=32, camera_bounds=tcam.CameraBounds(2.0, 6.0))
    out = tif.render_feature_voxel_grid(grid, Rays(torch.from_numpy(o), torch.from_numpy(d)), tcfg)
    torch.mean((out.colour - torch.from_numpy(target)) ** 2).backward()
    leaves = [jgrads.densities, jgrads.features] + [x for layer in jgrads.rgbnet for x in layer]
    for t, j in zip(grid.parameters(), leaves):
        assert _rel(t.grad.numpy(), j) < 1e-5
    assert all(t.grad is None for layer in grid.densitynet for t in layer)
    assert all(float(np.abs(np.asarray(x)).max()) == 0.0 for layer in jgrads.densitynet for x in layer)


def test_feature_grid_trains():
    """Adam on every tensor: 15 steps cut the loss by 20 % and move the
    rgbnet head."""
    grid = _port_grid(6, 4, seed=0)
    params = grid.parameters()
    for t in params:
        t.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=1e-2)
    o, d = _train_rays()
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    cfg = tif.SHVoxGridRenderConfig(num_samples_per_ray=32, camera_bounds=tcam.CameraBounds(2.0, 6.0))
    head0 = grid.rgbnet[0][0].detach().clone()
    losses = []
    for _ in range(15):
        opt.zero_grad()
        loss = torch.mean((tif.render_feature_voxel_grid(grid, rays, cfg).colour - 0.8) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.8 * losses[0]
    assert not torch.equal(head0, grid.rgbnet[0][0].detach())


def test_scale_preserves_aabb_and_matches_jax():
    jgrid = _jax_grid(4, 4, seed=4)
    grid = _carry(jgrid)
    scaled = tfv.scale_feature_voxel_grid(grid, (8, 8, 8))
    assert scaled.grid_dims == (8, 8, 8)
    np.testing.assert_allclose(np.asarray(scaled.aabb), np.asarray(grid.aabb), rtol=1e-6)
    assert scaled.rgbnet is grid.rgbnet and scaled.densitynet is grid.densitynet
    for size in ((8, 8, 8), (3, 5, 7)):
        ref = jfv.scale_feature_voxel_grid(jgrid, size)
        out = tfv.scale_feature_voxel_grid(grid, size)
        np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features), rtol=0, atol=2e-6)
        np.testing.assert_allclose(out.densities.numpy(), np.asarray(ref.densities), rtol=0, atol=2e-6)
        assert out.config.to_json_dict() == ref.config.to_json_dict()


def _write(path, arrays, meta):
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def _read(path):
    data = np.load(path)
    return data, json.loads(bytes(data["__meta__"].tobytes()).decode())


def test_checkpoint_round_trip_and_cross_package(tmp_path):
    """A port-written file loads in the port and in JAX, a JAX-written file
    in the port: every leaf bitwise, the config equal, and the loaded grid
    queries bitwise as the saved one."""
    grid = _port_grid(5, 4, seed=6, density_postactivation="softplus")
    _write(tmp_path / "port.npz", *tfv.feature_grid_save_arrays(grid))
    data, meta = _read(tmp_path / "port.npz")
    with data:
        back = tfv.feature_grid_from_saved(data, meta)
        jback = jfv.feature_grid_from_saved(data, meta)
    assert back.config == grid.config and jback.config.to_json_dict() == grid.config.to_json_dict()
    jleaves = [jback.densities, jback.features] + [x for layer in jback.rgbnet + jback.densitynet for x in layer]
    for a, b, j in zip(grid.parameters(), back.parameters(), jleaves):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
        np.testing.assert_array_equal(np.asarray(j), a.numpy())
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (32, 3)).astype(np.float32))
    np.testing.assert_array_equal(tfv.feature_grid_query(back, pts).numpy(), tfv.feature_grid_query(grid, pts).numpy())

    jgrid = _jax_grid(5, 4, seed=7)
    _write(tmp_path / "jax.npz", *jfv.feature_grid_save_arrays(jgrid))
    data, meta = _read(tmp_path / "jax.npz")
    with data:
        port = tfv.feature_grid_from_saved(data, meta)
    jleaves = [jgrid.densities, jgrid.features] + [x for layer in jgrid.rgbnet + jgrid.densitynet for x in layer]
    for t, j in zip(port.parameters(), jleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert port.config.to_json_dict() == jgrid.config.to_json_dict()
    arrays, meta2 = tfv.feature_grid_save_arrays(port)
    assert sorted(arrays) == sorted(jfv.feature_grid_save_arrays(jgrid)[0]) and meta2 == json.loads(json.dumps(meta))
