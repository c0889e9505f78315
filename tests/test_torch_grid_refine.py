"""The port's legacy iterate-and-refine loop (`train/grid_refine.py`) against
voxe_tpu's on the CPU: the legacy direction buckets bitwise; `refine_model`
with the attention re-learn off (the reference's default), whose periodic
graph cuts and merges give bitwise the JAX package's grids and the same
files; with the re-learn on, the tiny SD's draws replayed from JAX's keys,
both attention grids within 1e-4; and two stages, all four models scaled
together. Both sides start from the same numpy arrays and the same synthetic
scene."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sd import _numpy_params
from voxe_tpu.data.dataset import PosedImagesDataset as JDataset
from voxe_tpu.data.synthetic import generate_synthetic_scene
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models.sd.config import tiny_test_config as j_tiny
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.models.volumetric import VolumetricModel as JModel
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import grid_refine as jgr
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models.sd.config import tiny_test_config as t_tiny
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.volumetric import VolumetricModel as TModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import grid_refine as tgr

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False

RES = 12
CUT_KW = dict(min_num_edit_voxels=5, num_obj_voxels_thresh=20, top_k_edit_thresh=5, top_k_obj_thresh=5)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    scene = generate_synthetic_scene(
        tmp_path_factory.mktemp("scene"), num_train=4, num_test=1, image_size=24, focal=24.0, grid_res=16
    )
    args = (scene / "images", scene / "train_camera_params.json")
    return JDataset(*args, rgba_white_bkgd=True), TDataset(*args, rgba_white_bkgd=True, device="cpu")


def _arrays(edit_attn=None, obj_attn=None, seed=0):
    """(densities, features, {role: (features offset, attn)}): the JAX
    test's models — a dense 6^3 box, random SH features; the edit attention
    high in a sub-box, the object's its negative; sds features +1, ref -1."""
    rng = np.random.default_rng(seed)
    dens = np.full((RES, RES, RES, 1), -5.0, np.float32)
    dens[3:9, 3:9, 3:9] = 10.0
    feats = rng.standard_normal((RES, RES, RES, 3)).astype(np.float32)
    if edit_attn is None:
        edit_attn = np.full((RES, RES, RES, 1), -6.0, np.float32)
        edit_attn[3:6, 3:9, 3:9] = 6.0
    obj_attn = -edit_attn if obj_attn is None else obj_attn
    zero = np.zeros_like(edit_attn)
    roles = {"edit": (0.0, edit_attn), "object": (0.0, obj_attn), "sds": (1.0, zero), "ref": (-1.0, zero)}
    return dens, feats, roles


def _models(dataset, dens, feats, roles, pkg):
    """The four models of one package, from copies of the arrays."""
    grid_kw = dict(voxel_size=[3.0 / RES] * 3, density_preactivation="identity", density_postactivation="softplus")
    rcfg = dict(num_samples_per_ray=24, camera_bounds=dataset.camera_bounds, white_bkgd=True,
                render_num_samples_per_ray=24, parallel_rays_chunk_size=2048)
    out = {}
    for role, (offset, attn) in roles.items():
        if pkg == "jax":
            cfg = jvox.VoxelGridConfig(**{**grid_kw, "voxel_size": jvox.VoxelSize(*grid_kw["voxel_size"])})
            grid = jvox.VoxelGrid(jnp.asarray(dens.copy()), jnp.asarray(feats + offset), cfg, attn=jnp.asarray(attn.copy()))
            out[role] = JModel(grid, JRenderConfig(**rcfg))
        else:
            cfg = tvox.VoxelGridConfig(**{**grid_kw, "voxel_size": tvox.VoxelSize(*grid_kw["voxel_size"])})
            grid = tvox.VoxelGrid(torch.from_numpy(dens.copy()), torch.from_numpy(feats + offset), cfg,
                                  attn=torch.from_numpy(attn.copy()))
            out[role] = TModel(grid, TRenderConfig(**rcfg))
    return out


def _run(pkg, datasets, out_dir, arrays, **kw):
    jds, tds = datasets
    ds = jds if pkg == "jax" else tds
    m = _models(ds, *arrays, pkg)
    fn = jgr.refine_model if pkg == "jax" else tgr.refine_model
    returned = fn(m["sds"], m["edit"], m["object"], m["ref"], ds, out_dir, prompt="a test prompt", edit_idx=1,
                  object_idx=2, timestamp=10, fast_debug_mode=True, **CUT_KW, **kw)
    assert returned is m["edit"]
    return m


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_legacy_direction_buckets_bitwise():
    """Both thresholds' sides (yaw 60 / 120, pitch 55) and 200 random poses
    bucket the same in both packages."""
    def rt(yaw_deg, pitch_deg):
        rot = np.eye(3, dtype=np.float32)
        rot[0, 0] = np.cos(np.radians(yaw_deg))
        t = np.array([np.cos(np.radians(pitch_deg)), 0.0, np.sin(np.radians(pitch_deg))], np.float32) * 4.0
        return np.concatenate([rot, t.reshape(3, 1)], axis=1)

    cases = {(50.0, 10.0): "front", (70.0, 10.0): "side", (130.0, 10.0): "back", (70.0, 60.0): "overhead"}
    for (yaw, pitch), want in cases.items():
        assert tgr.get_dir_batch_from_poses_legacy(rt(yaw, pitch)[None]) == [want]
    rng = np.random.default_rng(0)
    poses = np.stack([rt(y, p) for y, p in zip(rng.uniform(0, 180, 200), rng.uniform(-10, 90, 200))])
    assert tgr.get_dir_batch_from_poses_legacy(poses) == jgr.get_dir_batch_from_poses_legacy(poses)
    for pose in poses[:20]:
        assert tgr._legacy_pitch_yaw_from_Rt(pose) == jgr._legacy_pitch_yaw_from_Rt(pose)


def test_cut_and_merge_match_jax_bitwise(datasets, tmp_path):
    """Re-learn off, 2 iterations, a cut at iterations 1 and 2: the SDS
    model's keep grid, merged densities and features equal JAX's bitwise,
    non-edit voxels hold the reference's features and edit voxels the SDS
    model's, and the run writes the same files (legacy names, "pbject")."""
    arrays = _arrays()
    kw = dict(num_stages=1, num_iterations_per_stage=2, refine_freq=2, save_freq=2, feedback_freq=1000, summary_freq=1)
    jm = _run("jax", datasets, tmp_path / "jax", arrays, **kw)
    tm = _run("torch", datasets, tmp_path / "torch", arrays, **kw)
    keep = _np(tm["sds"].grid.attn)[..., 0]
    assert set(np.unique(keep)) <= {-10.0, -5.0, 0.0} and (keep == 0.0).any()
    for name in ("attn", "densities", "features"):
        np.testing.assert_array_equal(_np(getattr(tm["sds"].grid, name)), _np(getattr(jm["sds"].grid, name)))
    merged, keep_mask = _np(tm["sds"].grid.features), keep != 0.0
    np.testing.assert_array_equal(merged[keep_mask], _np(tm["ref"].grid.features)[keep_mask])
    np.testing.assert_array_equal(merged[~keep_mask], (arrays[1] + 1.0)[~keep_mask])
    names = {p.name for p in (tmp_path / "torch" / "saved_models").iterdir()}
    assert names == {p.name for p in (tmp_path / "jax" / "saved_models").iterdir()}
    assert {"model_pbject_stage_1_iter_1.pth", "model_final_sds.pth", "model_final_edit.pth"} <= names


@pytest.fixture(scope="module")
def sd_pair():
    """The JAX tiny SD at 32^2 in f32 (shape-only init) and the port, with
    the same seeded numpy parameters."""
    jsd = JSD(config=j_tiny(image_size=32), unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=21)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD(config=t_tiny(image_size=32), unet_dtype=torch.float32, device="cpu")
    tsd.load_flax_params(params)
    return jsd, tsd


def test_relearn_matches_jax_with_replayed_draws(datasets, sd_pair, tmp_path, monkeypatch):
    """Re-learn on, 2 iterations (the cut at iteration 1): the RGB frame,
    SD 1.4's stand-in the tiny SD with the VAE eps and noise of JAX's keys
    (`split(key, 3)` an iteration, then get_attn_map's splits), the dual
    update: both attention grids within 1e-4 of JAX's, and moved."""
    jsd, tsd = sd_pair
    rng = np.random.default_rng(3)
    edit_attn = rng.normal(-1.0, 1.0, (RES, RES, RES, 1)).astype(np.float32)
    arrays = _arrays(edit_attn, rng.normal(-1.0, 1.0, (RES, RES, RES, 1)).astype(np.float32))
    iters, seed = 2, 42
    kw = dict(num_stages=1, num_iterations_per_stage=iters, refine_freq=1000, save_freq=1000, feedback_freq=1000,
              summary_freq=1, relearn_attn_grids=True, seed=seed, attn_tv_weight=0.01)
    jm = _run("jax", datasets, tmp_path / "jax", arrays, sd_model=jsd, **kw)

    _, c, h, w = tsd.latent_shape(1)
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(iters):
        key, k_attn, _ = jax.random.split(key, 3)
        _, k_run = jax.random.split(k_attn)
        k_enc, k_noise = jax.random.split(k_run)
        draws.append({n: torch.from_numpy(np.array(jax.random.normal(k, (1, h, w, c))))
                      for n, k in (("vae_eps", k_enc), ("noise", k_noise))})
    replay, get_attn_map = iter(draws), tsd.get_attn_map
    monkeypatch.setattr(tsd, "get_attn_map", lambda *a, **k: get_attn_map(*a, **{**k, **next(replay)}))
    tm = _run("torch", datasets, tmp_path / "torch", arrays, sd_model=tsd, **kw)
    assert next(replay, None) is None
    for role, start in (("edit", arrays[2]["edit"][1]), ("object", arrays[2]["object"][1])):
        got, want = _np(tm[role].grid.attn), _np(jm[role].grid.attn)
        assert np.abs(got - want).max() < 1e-4, role
        assert np.abs(got - start).max() > 1e-3, role


def test_two_stages_scale_all_four_models(datasets, tmp_path):
    """Two stages: every model starts at the coarse size and ends at the
    full one, as in JAX, with JAX's grids within 1e-5 (the resample's
    rounding) and the cut's keep grid equal."""
    arrays = _arrays()
    kw = dict(num_stages=2, num_iterations_per_stage=1, scale_factor=2.0, refine_freq=1, save_freq=1000,
              feedback_freq=1000)
    jm = _run("jax", datasets, tmp_path / "jax", arrays, **kw)
    tm = _run("torch", datasets, tmp_path / "torch", arrays, **kw)
    for role in ("edit", "object", "sds", "ref"):
        assert tm[role].grid.grid_dims == (RES,) * 3 == jm[role].grid.grid_dims
        for name in ("densities", "features"):
            np.testing.assert_allclose(_np(getattr(tm[role].grid, name)), _np(getattr(jm[role].grid, name)),
                                       rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(tm["sds"].grid.attn), _np(jm["sds"].grid.attn))
