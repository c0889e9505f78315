"""Parity of the port's K-iteration refinement call against voxe_tpu on the
CPU: `make_refine_multi_step` at K = 2 on the tiny SD (32^2, f32, the same
seeded numpy parameters on both sides) against the JAX scan, with every
draw replayed from the JAX key as the scan splits it: per iteration the
hemisphere pose (`random_pose_jax`), then t, the VAE's eps and the noise.
The direction bucket of each pose picks the text and token selection on
both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_recon import _check_grads
from tests.test_torch_refine import GRID_KW, LR, _iteration_inputs, sd_pair  # noqa: F401  (fixture)
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import refine as jrefine
from voxe_tpu.utils import camera as jcam
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import refine as trefine
from voxe_tpu_torch.utils import camera as tcam

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

PROMPT = "a dog wearing a party hat"
K, RADIUS, BASE, EDIT_IDX = 2, 4.0311, (24, 24), [4, 5]


def _jax_selection(jsd):
    """The JAX loop's stacked per-direction tables over one token bucket
    (voxe_tpu/train/refine.py:497-517)."""
    n = {d: jsd.get_num_tokens(PROMPT + f", {d} view") for d in DIRECTION_PROMPTS}
    bucket = 8 * ((max(n.values()) + 7) // 8)
    idxs, emask, omask = (np.zeros((4, bucket), dt) for dt in (np.int32, np.float32, np.float32))
    for row, d in enumerate(DIRECTION_PROMPTS):
        idxs[row, :n[d]] = np.arange(1, n[d] + 1)
        emask[row, [i - 1 for i in EDIT_IDX]] = 1.0
        omask[row, :n[d]] = 1.0 - emask[row, :n[d]]
    return jnp.asarray(idxs), jnp.asarray(emask), jnp.asarray(omask)


def test_refine_kstep_matches_jax(sd_pair):
    """Two iterations in one call: the last iteration's direction bucket and
    losses (1e-5 relative), both grids' Adam moments (1e-4 of their max) and
    the grids (1e-5 on 99.9 % of entries; every entry within 2 lr a step)."""
    jsd, tsd = sd_pair
    dens, feats, attn, _, vs = _iteration_inputs()
    jgrid = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats),
                           jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs), **GRID_KW), attn=jnp.asarray(attn[..., :1]))
    jcfg = JRenderConfig(num_samples_per_ray=32, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                         use_fused_kernel=True)
    sched = optax.exponential_decay(LR, 1, 0.1, staircase=True)
    opt_e, opt_o = optax.adam(sched), optax.adam(sched)
    jmulti = jrefine.make_refine_multi_step(jsd, jcfg, opt_e, opt_o, jgrid, BASE, 0, 0.01, K, RADIUS)
    text_by_dir = jnp.stack([jsd.get_text_embeds(PROMPT + f", {d} view", "") for d in DIRECTION_PROMPTS])
    e0, o0 = jnp.asarray(attn[..., :1]), jnp.asarray(attn[..., 1:])
    key = jax.random.PRNGKey(17)
    new_e, new_o, st_e, st_o, jm = jmulti(e0, o0, opt_e.init(e0), opt_o.init(o0), jsd.params, text_by_dir,
                                          *_jax_selection(jsd), key)
    poses, ts, epss, noises = [], [], [], []
    for step_key in jax.random.split(key, K):  # voxe_tpu/train/refine.py:297-298, 195
        k_pose, k_iter = jax.random.split(step_key)
        poses.append([np.array(x) for x in jcam.random_pose_jax(k_pose, RADIUS)])
        k_enc, k_noise, k_t, _, _ = jax.random.split(k_iter, 5)
        epss.append(np.array(jax.random.normal(k_enc, (1, 16, 16, 4))))
        noises.append(np.array(jax.random.normal(k_noise, (1, 16, 16, 4))))
        ts.append(int(jsd.sample_timestep(k_t)))

    grid = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats),
                          tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), **GRID_KW))
    tcfg = TRenderConfig(num_samples_per_ray=32, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                         use_fused_kernel=True)
    e, o = torch.tensor(attn[..., :1]), torch.tensor(attn[..., 1:])
    t_opt_e, t_opt_o = trefine.make_attn_adam(e, LR), trefine.make_attn_adam(o, LR)
    multi = trefine.make_refine_multi_step(
        tsd, tcfg, t_opt_e, t_opt_o, grid, BASE, 0, 0.01, K, RADIUS, trefine.exponential_decay_staircase(LR, 1, 0.1))
    selection = [trefine.token_selection(tsd.get_num_tokens(PROMPT + f", {d} view"), EDIT_IDX, None)
                 for d in DIRECTION_PROMPTS]
    t_text = torch.stack([tsd.get_text_embeds(PROMPT + f", {d} view", "") for d in DIRECTION_PROMPTS])
    m = multi(e, o, t_text, selection, poses=[np.stack(x) for x in zip(*poses)], t=ts,
              noise=torch.from_numpy(np.stack(noises)), vae_eps=torch.from_numpy(np.stack(epss)))
    assert m["dir_idx"] == int(jm["dir_idx"]) and m["t"] == ts[-1]
    for name in ("attn_loss_edit", "tv_loss_edit", "attn_loss_object", "tv_loss_object"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5, atol=1e-7)
    for t_new, opt, j_new, j_state, j_old in ((e, t_opt_e, new_e, st_e, e0), (o, t_opt_o, new_o, st_o, o0)):
        state = opt.state[t_new]
        assert int(state["step"]) == int(j_state[0].count) == K
        _check_grads(state["exp_avg"], j_state[0].mu)
        _check_grads(state["exp_avg_sq"], j_state[0].nu)
        diff = np.abs(t_new.detach().numpy() - np.asarray(j_new))
        assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).sum()
        assert diff.max() <= 2 * LR * K
        assert np.abs(np.asarray(j_new) - np.asarray(j_old)).max() > 0.0
    # undrawn: the poses, t and the SD draws come from the generator
    m = multi(e, o, t_text, selection, torch.Generator().manual_seed(0))
    assert 0 <= m["dir_idx"] < 4 and np.isfinite(float(m["attn_loss_edit"]))
    assert int(t_opt_e.state[e]["step"]) == 2 * K


def test_direction_index_matches_the_jax_buckets():
    """The host bucketing of the port's K-step call against the JAX scan
    body's traced one (voxe_tpu/train/refine.py:302-305), at the bucket
    edges and in between."""
    for pitch in (15.0, 24.9, 25.0, 60.0, 89.9):
        for yaw in (0.0, 45.0, 45.1, 120.0, 120.1, 200.0, 239.9, 240.0, 314.9, 315.0, 359.9):
            j = 3
            j = 0 if 45.0 < yaw < 315.0 else j
            j = 2 if 120.0 < yaw < 240.0 else j
            j = 1 if pitch < 25.0 else j
            assert tcam.direction_index(pitch, yaw) == j, (pitch, yaw)
    assert tcam.direction_index(20.0, 180.0) == 1 and DIRECTION_PROMPTS[1] == "overhead"


@pytest.mark.parametrize("steps_per_call", [2, 3])
def test_fused_loop_cadence(steps_per_call, sd_pair, tmp_path, monkeypatch):
    """`refine_edited_relu_field` with K iterations a call (random poses,
    shear-warp): 5 iterations in calls of K and a last partial call, each
    through `make_refine_multi_step`; snapshots when the step is within K of
    a multiple of 3 or on the last call, as the JAX loop writes them."""
    _, tsd = sd_pair
    built, calls = [], []
    make = trefine.make_refine_multi_step

    def spy(*args, **kwargs):
        built.append(args[8])  # steps_per_call
        multi = make(*args, **kwargs)

        def counted(*a, **kw):
            calls.append(args[8])
            return multi(*a, **kw)

        return counted

    monkeypatch.setattr(trefine, "make_refine_multi_step", spy)
    scene = tmp_path / "scene"
    generate_synthetic_scene(scene, num_train=2, num_test=1, image_size=16, focal=16.0, grid_res=12, device="cpu")
    dataset = TDataset(scene / "images", scene / "train_camera_params.json", rgba_white_bkgd=True, device="cpu")
    dens, feats, attn, _, vs = _iteration_inputs()
    cfg = TRenderConfig(num_samples_per_ray=32, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                        use_fused_kernel=True)

    def model(channel):
        grid = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats),
                              tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), **GRID_KW),
                              attn=torch.from_numpy(attn[..., channel:channel + 1].copy()))
        return tvol.VolumetricModel(grid, cfg)

    out = tmp_path / "refine"
    trefine.refine_edited_relu_field(
        model(0), model(1), model(0), model(0), dataset, out, PROMPT, EDIT_IDX, 0, (16, 16), num_iterations=5,
        save_freq=3, feedback_freq=100, summary_freq=100, sd_model=tsd, min_num_edit_voxels=10,
        fast_debug_mode=True, steps_per_call=steps_per_call)
    chunks = [steps_per_call] * (5 // steps_per_call) + ([5 % steps_per_call] if 5 % steps_per_call else [])
    assert calls == chunks and built == sorted(set(chunks), key=chunks.index)
    ends = list(np.cumsum(chunks))
    saved = sorted(g for g in ends if g % 3 < steps_per_call or g == 5)
    assert sorted(p.name for p in (out / "saved_models").glob("model_edit_iter_*")) == sorted(
        f"model_edit_iter_{g}.pth" for g in saved)
