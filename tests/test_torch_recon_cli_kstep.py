"""The recon CLIs of both packages on the CPU at a tiny size, for what the
rest of reconstruction adds: K steps a call with the JAX trainer's cadence,
`--resume` (from a JAX-written training state, and across the stage ladder),
`--coarse_stages_on_cpu`, and a memmap-backed (streaming) stage through the
trainer."""
import logging

import numpy as np
import pytest
import torch

import train_sh_based_voxel_grid_with_posed_images as jcli
from voxe_tpu.models import volumetric as jvol
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as tcli
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.parallel import distributed as tdist
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.train import checkpointing as tckpt
from voxe_tpu_torch.train.recon import train_sh_vox_grid_vol_mod_with_posed_images

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)


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


def _args(scene, iterations, stages=1):
    # the exact route: the JAX CLI's K-step jits stay a few seconds
    return ["-d", str(scene), "--grid_dims", "12", "12", "12", "--num_stages", str(stages),
            "--num_iterations_per_stage", str(iterations), "--steps_per_call", "3", "--save_frequency", "2",
            "--summary_frequency", "4", "--fast_debug_mode", "True", "--use_shear_warp", "False",
            "--ray_batch_size", "256", "--train_num_samples_per_ray", "16"]


def _snapshots(out):
    return sorted(p.name for p in (out / "saved_models").iterdir())


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Both CLIs, 7 iterations at 3 a call (calls end at steps 3, 6, 7),
    snapshots every 2 steps."""
    out = tmp_path_factory.mktemp("kstep")
    jcli.main(_args(scene, 7) + ["-o", str(out / "jax"), "--num_workers", "0"], standalone_mode=False)
    tcli.main(_args(scene, 7) + ["-o", str(out / "port"), "--device", "cpu"])
    return out


def test_kstep_cadence_writes_the_jax_trainers_snapshots(runs):
    """The snapshot cadence runs on the global step at each call's end, the
    stage's first call and its last: steps 3, 6 and 7, as the JAX trainer
    writes them (one step a call would write 1, 2, 4, 6, 7); the training
    state counts 7 updates."""
    assert _snapshots(runs / "port") == _snapshots(runs / "jax") == sorted(
        [f"model_stage_1_iter_{g}.pth" for g in (3, 6, 7)] + ["model_final.pth", "training_state_latest.pth"])
    arrays, meta = tckpt.read_training_state(runs / "port" / "saved_models" / "training_state_latest.pth")
    assert meta["global_step"] == 7 and meta["stage_iteration"] == 7 and int(arrays["opt_state/0/count"]) == 7
    j_model, _ = jvol.load_volumetric_model(runs / "port" / "saved_models" / "model_final.pth")
    assert np.isfinite(np.asarray(j_model.grid.densities)).all()


def test_resume_from_the_jax_training_state(runs, scene):
    """`--resume` from the JAX CLI's training_state_latest.pth: with the same
    budget nothing is left to run and model_final.pth is the JAX grid bit
    for bit; with 10 iterations the port continues at step 8 (one call of 3)
    and its state counts 10 updates."""
    state = runs / "jax" / "saved_models" / "training_state_latest.pth"
    same = runs / "resume_same"
    tcli.main(_args(scene, 7) + ["-o", str(same), "--device", "cpu", "--resume", str(state)])
    j_final, _ = jvol.load_volumetric_model(runs / "jax" / "saved_models" / "model_final.pth")
    t_final, _ = tvol.load_volumetric_model(same / "saved_models" / "model_final.pth", device="cpu")
    np.testing.assert_array_equal(t_final.grid.densities.numpy(), np.asarray(j_final.grid.densities))
    np.testing.assert_array_equal(t_final.grid.features.numpy(), np.asarray(j_final.grid.features))
    assert _snapshots(same) == ["model_final.pth"]
    more = runs / "resume_more"
    tcli.main(_args(scene, 10) + ["-o", str(more), "--device", "cpu", "--resume", str(state)])
    assert _snapshots(more) == ["model_final.pth", "model_stage_1_iter_10.pth", "training_state_latest.pth"]
    arrays, meta = tckpt.read_training_state(more / "saved_models" / "training_state_latest.pth")
    assert (meta["stage"], meta["stage_iteration"], meta["global_step"]) == (1, 8, 10)
    assert int(arrays["opt_state/0/count"]) == int(arrays["opt_state/1/count"]) == 10
    moved = np.abs(arrays["grid/0"] - np.asarray(j_final.grid.densities)).max()
    assert moved > 0.0


def test_resume_across_the_stage_ladder_and_coarse_stages_on_cpu(scene, tmp_path, caplog, monkeypatch):
    """The port's own state at stage 2 of 2: a resumed run fast-forwards
    stage 1 (the grid scaled up the ladder to the state's size) and
    continues stage 2 after the saved iteration; `--coarse_stages_on_cpu`
    runs and logs the CPU stages; `--num_devices 2` hands the command to two
    spawned ranks (recorded here, not started: tests/test_torch_parallel.py
    runs them)."""
    first, resumed = tmp_path / "first", tmp_path / "resumed"
    tcli.main(_args(scene, 4, stages=2) + ["-o", str(first), "--device", "cpu"])
    state = first / "saved_models" / "training_state_latest.pth"
    _, meta = tckpt.read_training_state(state)
    assert (meta["stage"], meta["stage_iteration"], meta["global_step"]) == (2, 4, 8)
    tcli.main(_args(scene, 6, stages=2) + ["-o", str(resumed), "--device", "cpu", "--resume", str(state)])
    assert _snapshots(resumed) == ["model_final.pth", "model_stage_2_iter_10.pth", "training_state_latest.pth"]
    arrays, meta = tckpt.read_training_state(resumed / "saved_models" / "training_state_latest.pth")
    assert meta["global_step"] == 10 and int(arrays["opt_state/0/count"]) == 6
    with caplog.at_level(logging.INFO, logger="voxe_tpu_torch"):
        tcli.main(_args(scene, 2, stages=2) + ["-o", str(tmp_path / "coarse"), "--device", "cpu",
                                                "--coarse_stages_on_cpu", "True"])
    assert [r.stage_device for r in caplog.records if hasattr(r, "stage_device")] == ["cpu", "cpu"]
    assert any("stage 1 runs on the CPU" in r.getMessage() for r in caplog.records)
    assert (tmp_path / "coarse" / "saved_models" / "model_final.pth").exists()
    spawned = []
    monkeypatch.setattr(tdist, "launch_local", lambda fn, fn_args, n: spawned.append((fn, fn_args, n)))
    multi = _args(scene, 2) + ["-o", str(tmp_path / "x"), "--device", "cpu", "--num_devices", "2"]
    tcli.main(multi)
    assert spawned == [(tcli.main, (multi,), 2)] and not (tmp_path / "x").exists()


@pytest.mark.cuda
def test_num_devices_beyond_the_card_count_fails_at_once(scene, tmp_path):
    """On a one-card host, `--device cuda --num_devices 2` fails before it
    spawns anything, with both counts in the message."""
    if not torch.cuda.is_available() or torch.cuda.device_count() != 1:
        pytest.skip("needs a host with exactly one CUDA card")
    with pytest.raises(ValueError, match=r"--num_devices 2 .* has 1 CUDA device"):
        tcli.main(_args(scene, 2) + ["-o", str(tmp_path / "x"), "--device", "cuda", "--num_devices", "2"])
    assert not (tmp_path / "x").exists()


def test_streaming_stage_through_the_trainer(scene, tmp_path, caplog):
    """A memmap-backed dataset through the trainer: shear-warp and K steps a
    call fall back to the exact streaming step with the JAX trainer's
    warnings, and every step trains (3 snapshots at 1 step a call)."""
    ds = TDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True, device="cpu",
                  cache_backing="memmap")
    res = 12
    grid = VoxelGrid(torch.zeros((res,) * 3 + (1,)), torch.zeros((res,) * 3 + (3,)),
                     VoxelGridConfig(voxel_size=VoxelSize(*[3.0 / res] * 3), density_preactivation="identity",
                                     density_postactivation="softplus"))
    model = tvol.VolumetricModel(grid, SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=ds.camera_bounds,
                                                             white_bkgd=True))
    with caplog.at_level(logging.WARNING, logger="voxe_tpu_torch"):
        out = train_sh_vox_grid_vol_mod_with_posed_images(
            model, ds, tmp_path / "stream", num_stages=1, num_iterations_per_stage=3, ray_batch_size=256,
            image_batch_cache_size=2, save_freq=1, fast_debug_mode=True, steps_per_call=2, use_shear_warp=True)
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert any("falls back to the exact renderer" in w for w in warnings)
    assert any("falling back to steps_per_call=1" in w for w in warnings)
    assert _snapshots(tmp_path / "stream") == sorted(
        [f"model_stage_1_iter_{g}.pth" for g in (1, 2, 3)] + ["model_final.pth", "training_state_latest.pth"])
    assert torch.isfinite(out.grid.densities).all() and float(out.grid.densities.abs().max()) > 0.0
