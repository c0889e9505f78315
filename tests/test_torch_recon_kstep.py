"""Parity of the rest of the port's reconstruction against voxe_tpu on the
CPU: K steps a call on the shear-warp and exact routes, the streaming step,
the memmap-backed dataset, the ray utilities, and training states that
either package resumes from. The recon CLIs' K-step cadence, `--resume`,
`--coarse_stages_on_cpu` and a streaming stage are in
test_torch_recon_cli_kstep.py.

Inputs are made with numpy from a seed and fed to both packages. The
shear-warp image indices are numpy draws, the same in both; the draws that
JAX makes with `jax.random` (image batches, pixel indices, jitter) are
replayed into the port from the JAX key as the JAX step splits it."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_recon import SIX_POSES, _check_grads, _check_update, _grids, _jax_optimizer, _t_grid
from voxe_tpu.data.dataset import PosedImagesDataset as JDataset
from voxe_tpu.render import rays as jrays
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import checkpointing as jckpt
from voxe_tpu.train import recon as jrecon
from voxe_tpu.utils import camera as jcam
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.render import rays as trays
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import checkpointing as tckpt
from voxe_tpu_torch.train import recon as trecon
from voxe_tpu_torch.utils import camera as tcam

LR, DECAY_STEPS, GAMMA = 0.03, 2, 0.1  # the lr changes inside a 3-step call


def _jax_adam():
    return optax.adam(optax.exponential_decay(LR, DECAY_STEPS, GAMMA, staircase=True))


def _port_adam(grid):
    return trecon.make_adam(grid, LR), trecon.exponential_decay_staircase(LR, DECAY_STEPS, GAMMA)


def _check_k_steps(grid, opt, j_new, j_state, j_old, steps):
    """After K steps: Adam's count, both moments to 1e-4 of their max (f32
    gradients in another summation order; the moments are linear and
    quadratic in them), and the grid to 1e-5 on 99.9 % of its entries. An
    entry whose first moment sits near zero (a gradient of about Adam's eps,
    or steps whose gradients cancel) takes an update lr * m / sqrt(v) that
    the rounding can swing by up to 2 lr a step, and later steps carry that
    on; so every entry is held to 2 lr K."""
    adam = j_state[0]
    assert int(adam.count) == steps
    for name in ("densities", "features"):
        t = getattr(grid, name)
        state = opt.state[t]
        assert int(state["step"]) == steps
        _check_grads(state["exp_avg"], getattr(adam.mu, name))
        _check_grads(state["exp_avg_sq"], getattr(adam.nu, name))
        j_t = np.asarray(getattr(j_new, name))
        diff = np.abs(t.detach().numpy() - j_t)
        assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).sum()
        assert diff.max() <= 2 * LR * steps
        assert np.abs(j_t - np.asarray(getattr(j_old, name))).max() > 0.0


# ---------------------------------------------------------------------------
# K steps a call
# ---------------------------------------------------------------------------


def test_shearwarp_kstep_matches_jax():
    """K = 3 shear-warp steps (12^3, SH degree 1, 24^2 base, fused
    compositing, diffuse regularisation) on three numpy-drawn images against
    `make_recon_train_multi_step_shearwarp`: the last step's losses, Adam's
    moments and the grid."""
    K, base = 3, (24, 24)
    jg, tg = _grids((12,) * 3, sh_degree=1, seed=21)
    rng = np.random.default_rng(22)
    targets = rng.uniform(0, 1, (6, *base, 3)).astype(np.float32)
    masks = (rng.random((6, *base)) > 0.2).astype(np.float32)
    poses = np.stack([np.concatenate(jcam.pose_spherical(y, p, 4.0), 1) for y, p in SIX_POSES]).astype(np.float32)
    idxs = np.random.default_rng(42).integers(0, 6, K)  # the trainer's host draw, shared
    cfg = dict(num_samples_per_ray=32, white_bkgd=True, use_fused_kernel=True)
    jopt = _jax_adam()
    jmulti = jrecon.make_recon_train_multi_step_shearwarp(
        JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, base, K, True)
    j_new, j_state, jm = jmulti(jg, jopt.init(jg), jnp.asarray(targets), jnp.asarray(masks), jnp.asarray(poses),
                                jnp.asarray(idxs, jnp.int32), jax.random.PRNGKey(0))
    grid = _t_grid(tg)
    opt, sched = _port_adam(grid)
    multi = trecon.make_recon_train_multi_step_shearwarp(
        TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt, base, K, True, lr_schedule=sched)
    tm = multi(grid, torch.from_numpy(targets), torch.from_numpy(masks), torch.from_numpy(poses), idxs)
    for k in ("total_loss", "specular_loss", "diffuse_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * GAMMA)
    _check_k_steps(grid, opt, j_new, j_state, jg, K)
    with pytest.raises(ValueError, match="3 indices"):
        multi(grid, torch.from_numpy(targets), torch.from_numpy(masks), torch.from_numpy(poses), idxs[:2])


def test_exact_kstep_with_replayed_draws():
    """K = 3 exact ray-batch steps against `make_recon_train_multi_step`:
    each step's image batch, pixel indices and jitter are derived from the
    JAX key as its scan splits it (K keys, then 3 per step) and injected."""
    K, R, S, B = 3, 64, 24, 2
    jg, tg = _grids((10, 10, 10), seed=23)
    rng = np.random.default_rng(24)
    images = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    poses = np.stack([np.concatenate(jcam.pose_spherical(y, p, 4.0), 1)
                      for y, p in ((20, 50), (140, 70), (250, 30))]).astype(np.float32)
    intr = (8, 8, 9.0)
    cfg = dict(num_samples_per_ray=S, white_bkgd=True)
    jopt = _jax_adam()
    jmulti = jrecon.make_recon_train_multi_step(
        jcam.CameraIntrinsics(*intr), JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt, R,
        num_train_images=3, image_batch_size=B, steps_per_call=K)
    key = jax.random.PRNGKey(25)
    j_new, j_state, jm = jmulti(jg, jopt.init(jg), jnp.asarray(images), jnp.asarray(poses), key)
    batches, flat, jitter = [], [], []
    for step_key in jax.random.split(key, K):  # train/recon.py:434-442
        k_batch, k_idx, k_render = jax.random.split(step_key, 3)
        batches.append(np.array(jax.random.randint(k_batch, (B,), 0, 3)))
        flat.append(np.array(jax.random.randint(k_idx, (R,), 0, B * 8 * 8)))
        jitter.append(np.array(jax.random.uniform(k_render, (R, S), dtype=jnp.float32)))
    grid = _t_grid(tg)
    opt, sched = _port_adam(grid)
    multi = trecon.make_recon_train_multi_step(
        tcam.CameraIntrinsics(*intr), TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt, R,
        3, B, K, lr_schedule=sched)
    tm = multi(grid, torch.from_numpy(images), torch.from_numpy(poses), batch_indices=torch.from_numpy(np.stack(batches)),
               flat_idx=torch.from_numpy(np.stack(flat)), t_rand=torch.from_numpy(np.stack(jitter)))
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5, atol=1e-6)
    _check_k_steps(grid, opt, j_new, j_state, jg, K)
    # undrawn: each step draws its batch, pixels and jitter from the generator
    m = multi(grid, torch.from_numpy(images), torch.from_numpy(poses), torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["total_loss"])) and int(opt.state[grid.densities]["step"]) == 2 * K


def test_streaming_step_matches_jax():
    """The streaming step on host-gathered pixels against
    `make_recon_train_step_streaming`, the jitter replayed: loss, gradients
    and the Adam update."""
    R, S = 48, 24
    jg, tg = _grids((10, 10, 10), seed=26)
    rng = np.random.default_rng(27)
    batch_poses = np.stack([np.concatenate(jcam.pose_spherical(y, p, 4.0), 1)
                            for y, p in ((30, 60), (200, 40))]).astype(np.float32)
    flat_idx = rng.integers(0, 2 * 8 * 8, R)
    pixels = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    intr = (8, 8, 9.0)
    cfg = dict(num_samples_per_ray=S, white_bkgd=True)
    jopt = _jax_optimizer()
    jstep = jrecon.make_recon_train_step_streaming(
        jcam.CameraIntrinsics(*intr), JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **cfg), jopt)
    key = jax.random.PRNGKey(28)
    new, state, jm = jstep(jg, jopt.init(jg), jnp.asarray(batch_poses), jnp.asarray(flat_idx), jnp.asarray(pixels), key)
    _, k_render = jax.random.split(key)  # train/recon.py:372
    t_rand = np.array(jax.random.uniform(k_render, (R, S), dtype=jnp.float32))
    grid = _t_grid(tg)
    opt = trecon.make_adam(grid, 0.03)
    step = trecon.make_recon_train_step_streaming(
        tcam.CameraIntrinsics(*intr), TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **cfg), opt,
        lr_schedule=trecon.exponential_decay_staircase(0.03, 1, 0.1))
    tm = step(grid, batch_poses, flat_idx, pixels, t_rand=torch.from_numpy(t_rand))
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5, atol=1e-6)
    _check_grads(grid.densities.grad, state[0].densities)
    _check_grads(grid.features.grad, state[0].features)
    _check_update(grid.features, new.features, jg.features, state[0].features, grid.features.grad)


# ---------------------------------------------------------------------------
# the memmap dataset, the ray utilities
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 32^2 synthetic scene (4 train, 2 held-out views) in the CLI's split
    layout."""
    root = tmp_path_factory.mktemp("scene")
    generate_synthetic_scene(root, num_train=4, num_test=2, image_size=32, focal=32.0, grid_res=24, device="cpu")
    for split in ("train", "test"):
        (root / split).mkdir()
        for p in (root / "images").glob(f"{split}_*.png"):
            p.rename(root / split / p.name)
    return root


@pytest.mark.parametrize("backing", ["memmap", "auto"])
def test_memmap_dataset_matches_ram(scene, backing):
    """A memmap-backed decode (asked for, or chosen by "auto" above the
    budget) holds the RAM decode bit for bit; it streams, gathers pixels as
    the JAX dataset does, refuses device caching and draws the same
    batches."""
    kw = dict(images_dir=scene / "train", camera_params_json=scene / "train_camera_params.json",
              downsample_factor=2.0, rgba_white_bkgd=True)
    ram = TDataset(device="cpu", cache_backing="ram", **kw)
    mm = TDataset(device="cpu", cache_backing=backing, max_ram_gib=1e-6, **kw)
    jmm = JDataset(cache_backing="memmap", **kw)
    assert isinstance(mm.images, np.memmap) and mm.streaming and not ram.streaming
    np.testing.assert_array_equal(np.asarray(mm.images), ram.images)
    np.testing.assert_array_equal(mm.poses, ram.poses)
    rng = np.random.default_rng(3)
    flat, img = rng.integers(0, 16 * 16, 50), rng.integers(0, len(mm), 50)
    got = mm.sample_pixels(flat, img)
    np.testing.assert_array_equal(got, jmm.sample_pixels(flat, img))
    np.testing.assert_array_equal(got, ram.images[img, flat // 16, flat % 16])
    assert got.dtype == np.float32 and got.shape == (50, 3)
    with pytest.raises(RuntimeError, match="streaming"):
        mm.device_arrays()
    assert mm.get_config_dict()["cache_backing"] == backing
    bm, br = mm.iter_batches(3, np.random.default_rng(0)), ram.iter_batches(3, np.random.default_rng(0))
    for _ in range(3):
        np.testing.assert_array_equal(next(bm), next(br))
    with pytest.raises(ValueError, match="cache_backing"):
        TDataset(device="cpu", cache_backing="disk", **kw)


def test_ray_utilities_match_jax():
    """`cast_rays_batch` against `cast_rays` per pose and against JAX,
    `collate_rays`, `ndcize_rays` and `select_rays_and_pixels`."""
    intr = (6, 9, 7.5)
    pts = [jcam.pose_spherical(y, p, 4.0) for y, p in ((30, 50), (120, 70), (250, 20))]
    rot = np.stack([p.rotation for p in pts]).astype(np.float32)
    trans = np.stack([p.translation for p in pts]).astype(np.float32)
    jr = jrays.cast_rays_batch(jcam.CameraIntrinsics(*intr), jnp.asarray(rot), jnp.asarray(trans))
    tr = trays.cast_rays_batch(tcam.CameraIntrinsics(*intr), rot, trans)
    assert tr.origins.shape == (3, 6, 9, 3)
    np.testing.assert_allclose(tr.directions.numpy(), np.asarray(jr.directions), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tr.origins.numpy(), np.asarray(jr.origins))
    single = [trays.cast_rays(tcam.CameraIntrinsics(*intr), rot[i], trans[i]) for i in range(3)]
    np.testing.assert_allclose(tr.directions[1].numpy(), single[1].directions.numpy(), rtol=1e-6, atol=1e-6)

    flat = [trays.flatten_rays(r) for r in single]
    coll = trays.collate_rays(flat)
    jcoll = jrays.collate_rays([jrays.flatten_rays(jrays.cast_rays(jcam.CameraIntrinsics(*intr), jnp.asarray(rot[i]),
                                                                   jnp.asarray(trans[i]))) for i in range(3)])
    assert coll.origins.shape == (3 * 54, 3)
    np.testing.assert_allclose(coll.directions.numpy(), np.asarray(jcoll.directions), rtol=1e-6, atol=1e-6)

    # NDC: rays from in front of the near plane, looking down -z
    rng = np.random.default_rng(4)
    o = (rng.uniform(-0.5, 0.5, (40, 3)) + np.array([0.0, 0.0, 0.5])).astype(np.float32)
    d = (rng.normal(0, 0.2, (40, 3)) + np.array([0.0, 0.0, -1.0])).astype(np.float32)
    jn = jrays.ndcize_rays(jrays.Rays(jnp.asarray(o), jnp.asarray(d)), jcam.CameraIntrinsics(*intr))
    tn = trays.ndcize_rays(trays.Rays(torch.from_numpy(o), torch.from_numpy(d)), tcam.CameraIntrinsics(*intr))
    np.testing.assert_allclose(tn.origins.numpy(), np.asarray(jn.origins), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.directions.numpy(), np.asarray(jn.directions), rtol=1e-5, atol=1e-5)

    pixels = rng.uniform(0, 1, (3 * 54, 3)).astype(np.float32)
    idx = rng.integers(0, 3 * 54, 17)
    (jo, jd), jp = jrays.select_rays_and_pixels(jcoll, jnp.asarray(pixels), jnp.asarray(idx))
    (to, td), tp = trays.select_rays_and_pixels(coll, torch.from_numpy(pixels), idx)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# training states across packages
# ---------------------------------------------------------------------------


def test_training_state_across_packages(tmp_path):
    """A state the port writes loads into the JAX package's template (the
    generator leaf ignored) with its moments and count, and a JAX-written
    state resumes the port: one more Adam step from it equals optax's. The
    generator: its own state on the same device, else the seed from the
    key."""
    jg, tg = _grids((5, 4, 3), sh_degree=0, seed=29)
    rng = np.random.default_rng(30)
    grads = [rng.normal(0, 1, (5, 4, 3, 3 + 1)).astype(np.float32) for _ in range(3)]

    def jax_grads(g):
        return jg.replace(densities=jnp.asarray(g[..., :1]), features=jnp.asarray(g[..., 1:]))

    jopt = _jax_adam()
    state, grid_j = jopt.init(jg), jg
    for g in grads[:2]:
        upd, state = jopt.update(jax_grads(g), state, grid_j)
        grid_j = optax.apply_updates(grid_j, upd)
    key = jax.random.PRNGKey(31)
    jpath = tmp_path / "jax_state.pth"
    jckpt.save_training_state(jpath, {"grid": grid_j, "opt_state": state, "key": key},
                              {"stage": 2, "stage_iteration": 2, "global_step": 9})

    grid = _t_grid(tg)
    opt, sched = _port_adam(grid)
    gen = torch.Generator().manual_seed(5)
    meta = tckpt.load_training_state(jpath, grid, opt, gen)
    assert meta == {"stage": 2, "stage_iteration": 2, "global_step": 9}
    assert gen.initial_seed() == (int(key[0]) << 32) | int(key[1])
    np.testing.assert_array_equal(grid.densities.detach().numpy(), np.asarray(grid_j.densities))
    # one more step on the same gradient in both packages
    upd, state3 = jopt.update(jax_grads(grads[2]), state, grid_j)
    grid_j3 = optax.apply_updates(grid_j, upd)
    grid.densities.grad = torch.from_numpy(grads[2][..., :1])
    grid.features.grad = torch.from_numpy(grads[2][..., 1:])
    trecon.apply_lr_schedule(opt, sched)
    opt.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * GAMMA)
    np.testing.assert_allclose(grid.features.detach().numpy(), np.asarray(grid_j3.features), rtol=0, atol=1e-6)

    # the port's file, back into JAX's template and into the port
    ppath = tmp_path / "port_state.pth"
    arrays = tckpt.training_state_arrays(grid, opt, gen, 10)
    assert "torch_generator/cpu" in arrays
    tckpt.save_training_state(ppath, arrays, {"stage": 2, "stage_iteration": 3, "global_step": 10})
    template = {"grid": jg, "opt_state": jopt.init(jg), "key": key}
    j_state, j_meta = jckpt.load_training_state(ppath, template)
    assert j_meta["global_step"] == 10 and int(j_state["opt_state"][0].count) == 3
    np.testing.assert_array_equal(np.asarray(j_state["opt_state"][0].nu.features),
                                  opt.state[grid.features]["exp_avg_sq"].numpy())
    np.testing.assert_allclose(np.asarray(j_state["opt_state"][0].mu.features), np.asarray(state3[0].mu.features),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(j_state["grid"].features), grid.features.detach().numpy())
    # key = [global_step, the generator's seed mod 2^32]: the seed from the JAX key
    assert np.asarray(j_state["key"]).tolist() == [10, int(key[1])]
    grid2 = _t_grid(tg)
    opt2, _ = _port_adam(grid2)
    draws = torch.rand(4, generator=gen)
    gen2 = torch.Generator()
    tckpt.load_training_state(ppath, grid2, opt2, gen2)
    torch.testing.assert_close(torch.rand(4, generator=gen2), draws, rtol=0, atol=0)
    assert int(opt2.state[grid2.features]["step"]) == 3
