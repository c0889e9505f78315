"""Recon quality on the port's shear-warp path (voxe_tpu_torch/train/recon.py)
at tests/test_shearwarp_train.py's own configuration: a 32^3 grid trained
300 steps on 64^2 base-plane targets pre-warped from 10 exact renders of the
demo grid, then a held-out pose rendered through the exact renderer must
exceed 25 dB. The JAX test's run on the same scene and initial grid is
repeated here and the gap between the two PSNRs is printed, not asserted.
Then the port's quality tool (voxe_tpu_torch/tools/quality_run_shearwarp.py)
end to end at a tiny size."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from voxe_tpu_torch.data.synthetic import make_demo_grid
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models.volumetric import VolumetricModel
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.tools import quality_run_shearwarp
from voxe_tpu_torch.train import recon as trecon
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

BASE_HW, RES, STEPS = (64, 64), 32, 300


def _poses():
    """test_shearwarp_train.py:55's 10 training poses and its held-out one."""
    rng = np.random.default_rng(0)
    return [(float(rng.random() * 360.0), 15.0 + float(rng.random() * 70.0), 4.031) for _ in range(10)], (77.0, 33.0,
                                                                                                          4.031)


def _init_arrays():
    """The JAX test's initial grid (_fresh_grid(PRNGKey(0))), as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.uniform(k1, (RES, RES, RES, 1), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.uniform(k2, (RES, RES, RES, 3), minval=-1.0, maxval=1.0)))


def _port_psnr(dens, feats) -> float:
    rcfg = SHVoxGridRenderConfig(num_samples_per_ray=96, camera_bounds=CameraBounds(0.5, 10.0), white_bkgd=True,
                                 perturb_sampled_points=False)
    intr = CameraIntrinsics(48, 48, 48.0)
    gt = VolumetricModel(make_demo_grid(res=RES, device="cpu"), rcfg)
    train_poses, test_pose = _poses()
    poses = [pose_spherical(*p) for p in train_poses]
    images = torch.stack([gt.render(intr, p).colour for p in poses])
    poses_t = torch.from_numpy(np.stack([np.concatenate([p.rotation, p.translation.reshape(3, 1)], 1)
                                         for p in poses]).astype(np.float32))
    grid = VoxelGrid(torch.from_numpy(dens.copy()), torch.from_numpy(feats.copy()), VoxelGridConfig(
        voxel_size=VoxelSize(*[3.0 / RES] * 3), density_preactivation="identity", density_postactivation="softplus"))
    targets, masks = trecon.warp_dataset_to_base(images, poses_t, intr, grid, BASE_HW)
    assert float(masks.mean()) > 0.5
    step = trecon.make_recon_train_step_shearwarp(rcfg, trecon.make_adam(grid, 0.03), BASE_HW)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        metrics = step(grid, targets, masks, poses_t, int(rng.integers(0, 10)))
    assert np.isfinite(float(metrics["total_loss"]))
    model = VolumetricModel(grid.replace(densities=grid.densities.detach(), features=grid.features.detach()), rcfg)
    pred = model.render(intr, pose_spherical(*test_pose)).colour
    truth = gt.render(intr, pose_spherical(*test_pose)).colour
    return -10.0 * np.log10(float(torch.mean((truth - pred) ** 2)) + 1e-12)


def _jax_psnr(dens, feats) -> float:
    """test_recon_shearwarp_reaches_screen_space_parity's run (JAX)."""
    from voxe_tpu.data.synthetic import make_demo_grid as jmake_demo_grid
    from voxe_tpu.grid.voxels import VoxelGrid as JGrid, VoxelGridConfig as JConfig, VoxelSize as JSize
    from voxe_tpu.models.volumetric import VolumetricModel as JModel
    from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
    from voxe_tpu.train.recon import make_recon_train_step_shearwarp, warp_dataset_to_base
    from voxe_tpu.utils.camera import CameraBounds as JBounds, CameraIntrinsics as JIntr, pose_spherical as jpose

    rcfg = JRenderConfig(num_samples_per_ray=96, camera_bounds=JBounds(0.5, 10.0), white_bkgd=True,
                         perturb_sampled_points=False)
    intr = JIntr(48, 48, 48.0)
    gt = JModel(jmake_demo_grid(res=RES), rcfg)
    train_poses, test_pose = _poses()
    poses = [jpose(*p) for p in train_poses]
    images = jnp.stack([gt.render(intr, p).colour for p in poses])
    poses_j = jnp.asarray(np.stack([np.concatenate([np.asarray(p.rotation), np.asarray(p.translation).reshape(3, 1)],
                                                   1) for p in poses]))
    grid = JGrid(jnp.asarray(dens), jnp.asarray(feats), JConfig(
        voxel_size=JSize(*[3.0 / RES] * 3), density_preactivation="identity", density_postactivation="softplus",
        expected_density_scale=1.0))
    targets, masks = warp_dataset_to_base(images, poses_j, intr, grid, BASE_HW)
    opt = optax.adam(0.03)
    opt_state = opt.init(grid)
    step = make_recon_train_step_shearwarp(rcfg, opt, BASE_HW)
    rng, key = np.random.default_rng(1), jax.random.PRNGKey(0)
    for _ in range(STEPS):
        key, sk = jax.random.split(key)
        grid, opt_state, _ = step(grid, opt_state, targets, masks, poses_j, jnp.asarray(int(rng.integers(0, 10))), sk)
    truth = gt.render(intr, jpose(*test_pose)).colour
    pred = JModel(grid, rcfg).render(intr, jpose(*test_pose)).colour
    return -10.0 * np.log10(float(jnp.mean((truth - pred) ** 2)) + 1e-12)


def test_recon_shearwarp_reaches_screen_space_parity():
    """Held-out PSNR through the exact renderer > 25 dB (the JAX test's
    bound); the gap to the JAX package's run is reported."""
    dens, feats = _init_arrays()
    psnr = _port_psnr(dens, feats)
    jax_psnr = _jax_psnr(dens, feats)
    print(f"held-out PSNR: port {psnr:.4f} dB, JAX {jax_psnr:.4f} dB, gap {psnr - jax_psnr:+.4f} dB")
    assert psnr > 25.0, f"held-out screen-space PSNR too low: {psnr:.2f} dB"


def test_quality_tool_tiny(tmp_path, capsys):
    """The quality tool end to end on the CPU at a tiny size: the scene, the
    4-stage ladder, the exact-renderer test of both splits, its RESULT line
    and result.json."""
    out = tmp_path / "q"
    result = quality_run_shearwarp.main(["--image", "24", "--grid", "24", "--views", "4", "--iters", "8", "--device",
                                         "cpu", "--out", str(out)])
    assert json.loads((out / "result.json").read_text()) == result
    assert np.isfinite(result["heldout_psnr"]) and np.isfinite(result["train_psnr"]) and result["total_iters"] == 32
    line = [s for s in capsys.readouterr().out.splitlines() if s.startswith("RESULT:")]
    assert line and f"held-out PSNR {result['heldout_psnr']:.2f} dB" in line[0] and "grid 24^3" in line[0]
    assert (out / "run" / "saved_models" / "model_final.pth").exists()

