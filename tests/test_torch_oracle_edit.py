"""The weight-free edit evidence on the port (voxe_tpu_torch/tools): the
analytic oracle denoiser through the port's real shear-warp edit steps, at
the JAX tests' own configurations and with their own asserts
(tests/test_sds_oracle_edit.py: 24^3, 40^2 base, 150 iterations;
tests/test_demo_oracle_local.py: the local demo at 24^3, 48^2 base, 120 +
120 iterations), the hat scene bitwise against the JAX demo's, and the
oracle's injected gradient against JAX's on the same render, noise and t
within 1e-6."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sds_oracle_edit import OracleSDS as JOracleSDS
from voxe_tpu_torch.data.synthetic import make_demo_grid
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.render.shearwarp import render_shear_warp
from voxe_tpu_torch.tools import demo_oracle_edit, demo_oracle_local_edit, oracle
from voxe_tpu_torch.train import sds as tsds
from voxe_tpu_torch.train.recon import make_adam
from voxe_tpu_torch.utils.camera import CameraBounds, pose_spherical
from voxe_tpu_torch.utils.constants import EXTRA_ACCUMULATED_WEIGHTS

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

BASE_HW = (40, 40)


def _rcfg():
    return SHVoxGridRenderConfig(num_samples_per_ray=48, camera_bounds=CameraBounds(0.5, 10.0), white_bkgd=True,
                                 perturb_sampled_points=False)


def _object_colour(grid):
    """Mean rendered colour over object pixels (acc weight > 0.5)
    (test_sds_oracle_edit.py:79)."""
    out, _ = render_shear_warp(grid, pose_spherical(30.0, 40.0, 4.031), _rcfg(), base_hw=BASE_HW)
    img = out.colour.detach().numpy()
    mask = out.extra[EXTRA_ACCUMULATED_WEIGHTS].detach().numpy().reshape(-1) > 0.5
    assert mask.sum() > 20
    return img[mask].mean(axis=0)


def _assert_recoloured(before, after, target, channel, ref_d, grid):
    """test_sds_oracle_edit.py:112-124's asserts."""
    target = np.asarray(target)
    dist_before, dist_after = float(np.linalg.norm(before - target)), float(np.linalg.norm(after - target))
    assert dist_after < 0.5 * dist_before, (before, after)
    others = [c for c in range(3) if c != channel]
    assert all(after[channel] > after[c] + 0.2 for c in others), after
    corr = np.corrcoef(ref_d.ravel(), grid.densities.detach().numpy().ravel())[0, 1]
    assert corr > 0.9, corr


def test_hat_scene_matches_jax_demo():
    from tools.demo_oracle_local_edit import make_hat_scene as jmake_hat_scene

    jgrid, jhat, jbody = jmake_hat_scene(24)
    grid, hat, body = oracle.make_hat_scene(24, device="cpu")
    assert np.array_equal(hat, jhat) and np.array_equal(body, jbody) and hat.any() and body.any()
    for name in ("densities", "features"):
        assert np.array_equal(getattr(grid, name).numpy(), np.asarray(getattr(jgrid, name))), name
    assert grid.config.to_json_dict() == jgrid.config.to_json_dict()


@pytest.mark.parametrize("t", [20, 500, 979])
def test_oracle_gradient_matches_jax(t):
    """The gradient the oracle injects into a render [1, 40, 40, 3], with
    JAX's noise replayed, within 1e-6."""
    rng = np.random.default_rng(t)
    x = rng.uniform(0.0, 1.0, (1, *BASE_HW, 3)).astype(np.float32)
    key = jax.random.PRNGKey(t)
    jor = JOracleSDS((1.0, 0.1, 0.1))
    want = np.asarray(jax.grad(lambda v: jor.sds_loss(None, None, v, key, t))(jnp.asarray(x)))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    xt = torch.from_numpy(x).requires_grad_(True)
    oracle.OracleSDS((1.0, 0.1, 0.1), device="cpu").sds_loss(None, xt, t, noise=noise).backward()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0.0, atol=1e-6)


def test_masked_oracle_targets_object_pixels_only():
    x = torch.tensor([[[[0.2, 0.9, 0.9], [0.95, 0.9, 0.99]]]])  # an object pixel, a background one
    target = oracle.MaskedOracleSDS(oracle.GOLDEN, device="cpu").target_image(x)
    assert torch.equal(target, torch.tensor([[[oracle.GOLDEN, [1.0, 1.0, 1.0]]]]))


def test_oracle_sds_recolours_the_object():
    """test_sds_oracle_edit.py::test_oracle_sds_recolours_the_object on the
    port's make_sds_train_step_shearwarp: 150 hemisphere steps toward red,
    density correlation weight 5, Adam 0.05."""
    grid = make_demo_grid(res=24, device="cpu")
    target = (1.0, 0.1, 0.1)
    step = tsds.make_sds_train_step_shearwarp(oracle.OracleSDS(target, device="cpu"), _rcfg(), make_adam(grid, 0.05),
                                              BASE_HW, density_correlation_weight=5.0)
    ref_d, ref_f = grid.densities.detach().clone(), grid.features.detach().clone()
    before = _object_colour(grid)
    rng, gen, t_gen = np.random.default_rng(0), torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    for _ in range(150):
        rot, trans = oracle.pose_tensors(oracle.demo_pose(rng), "cpu")
        step(grid, torch.zeros((2, 77, 8)), rot, trans, ref_d, ref_f, int(torch.randint(20, 980, (), generator=t_gen)),
             generator=gen)
    _assert_recoloured(before, _object_colour(grid), target, 0, ref_d.numpy(), grid)


def test_oracle_sds_recolours_via_data_pose_path():
    """test_sds_oracle_edit.py::test_oracle_sds_recolours_via_data_pose_fused_path
    on the port's dataset-pose step (`make_sds_train_step_shearwarp_data`,
    which the trainer runs K steps a call): 6 fixed poses, 150 steps toward
    green, one pose a step from a seeded draw, t in [20, 980]."""
    grid = make_demo_grid(res=24, device="cpu")
    target = (0.1, 1.0, 0.1)
    step = tsds.make_sds_train_step_shearwarp_data(oracle.OracleSDS(target, device="cpu"), _rcfg(),
                                                   make_adam(grid, 0.05), BASE_HW, 1, density_correlation_weight=5.0)
    rng = np.random.default_rng(3)
    poses = [oracle.pose_tensors(oracle.demo_pose(rng), "cpu") for _ in range(6)]
    rots, transs = torch.stack([p[0] for p in poses]), torch.stack([p[1] for p in poses])
    ref_d, ref_f = grid.densities.detach().clone(), grid.features.detach().clone()
    dummy_pix, dummy_msk = torch.zeros((1, *BASE_HW, 3)), torch.zeros((1, *BASE_HW))
    before = _object_colour(grid)
    gen = torch.Generator().manual_seed(0)
    for _ in range(150):
        idx = torch.randint(0, 6, (1,), generator=gen)
        t = int(torch.randint(20, 981, (), generator=gen))
        step(grid, torch.zeros((2, 77, 8)), rots[idx], transs[idx], dummy_pix, dummy_msk, ref_d, ref_f, t,
             generator=gen)
    _assert_recoloured(before, _object_colour(grid), target, 1, ref_d.numpy(), grid)


def test_demo_oracle_edit_tiny(tmp_path):
    """The global demo at 24^3 / 40^2 base, 150 iterations: the golden
    recolour at least halves the object's colour distance, the geometry
    holds (density correlation > 0.9), and its files."""
    out = tmp_path / "demo"
    m = demo_oracle_edit.main(["--res", "24", "--base", "40", "--iters", "150", "--eval_size", "64", "--device", "cpu",
                               "--out", str(out)])
    assert m["colour_distance_after"] < 0.5 * m["colour_distance_before"], m
    assert m["density_correlation"] > 0.9 and m["ms_per_step"] > 0.0, m
    assert json.loads((out / "metrics.json").read_text()) == m
    assert (out / "before_after.png").exists() and (out / "edited_turntable.mp4").exists()


def test_demo_oracle_local_edit_tiny(tmp_path):
    """tests/test_demo_oracle_local.py on the port's demo, at its config and
    bounds."""
    out = tmp_path / "demo"
    m = demo_oracle_local_edit.main(["--res", "24", "--base", "48", "--eval_size", "64", "--sds_iters", "120",
                                     "--refine_iters", "120", "--device", "cpu", "--out", str(out)])
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics == m
    assert metrics["body_restored"] is True
    assert metrics["iou"] > 0.5, metrics
    assert metrics["hat_feature_delta"] > 0.1, metrics
    assert metrics["body_mislabel_frac"] < 0.2, metrics
    assert (out / "before_globaledit_refined.png").exists()
    assert {"sds_ms_per_step", "refine_ms_per_step", "graph_cut_s"} <= set(metrics)
