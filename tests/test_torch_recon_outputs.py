"""Parity of the recon trainer's default-mode outputs against voxe_tpu on the
CPU: the recon CLI at `--fast_debug_mode False` (camera rays, feedback every
`feedback_freq`, held-out tests every `test_freq`) writes the JAX trainer's
file names; the held-out tester's PSNR and SSIM on the same grid; LPIPS-VGG
on random weights, alone and inside the tester; the camera-ray geometry
against `cast_rays`."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_sh_based_voxel_grid_with_posed_images as jcli
from tests.test_lpips import _synthesize_weights
from voxe_tpu.data.dataset import PosedImagesDataset as JDataset
from voxe_tpu.models import lpips as jlpips
from voxe_tpu.models import volumetric as jvol
from voxe_tpu.render.rays import cast_rays as j_cast_rays
from voxe_tpu.train.testers import test_sh_vox_grid_vol_mod_with_posed_images as j_tester
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as tcli
from voxe_tpu_torch.data.dataset import PosedImagesDataset as TDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.models import lpips as tlpips
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.train.testers import test_sh_vox_grid_vol_mod_with_posed_images as t_tester
from voxe_tpu_torch.viz.static import camera_ray_geometry

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


def _files(root):
    """Every file the run wrote, by relative path; tensorboard's event files
    carry the host and time in their names, so only their folder counts."""
    return sorted(str(p.relative_to(root).parent if "tensorboard" in p.parts else p.relative_to(root))
                  for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def recon_runs(scene, tmp_path_factory):
    """Both recon CLIs at their default fast_debug_mode False: 16^3, 2 stages
    x 3 iterations (feedback at 1 and 3 of each stage, held-out tests at
    each stage's end), 64 samples for the held-out renders. On the exact
    route: the JAX jits of the shear-warp step and feedback at both stage
    sizes take 61 s on one core; the default shear-warp route is held at
    one stage below.
    Returns (JAX output dir, port output dir, the port's log records)."""
    out = tmp_path_factory.mktemp("recon")
    args = ["-d", str(scene), "--grid_dims", "16", "16", "16", "--num_stages", "2", "--num_iterations_per_stage", "3",
            "--render_num_samples_per_ray", "64", "--use_fused_kernel", "True", "--use_shear_warp", "False",
            "--ray_batch_size", "256", "--train_num_samples_per_ray", "32"]
    jcli.main(args + ["-o", str(out / "jax"), "--num_workers", "0"], standalone_mode=False)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    port_log = logging.getLogger("voxe_tpu_torch")
    port_log.addHandler(handler)
    level = port_log.level
    port_log.setLevel(logging.INFO)
    try:
        tcli.main(args + ["-o", str(out / "torch"), "--device", "cpu"])
    finally:
        port_log.removeHandler(handler)
        port_log.setLevel(level)
    return out / "jax", out / "torch", records


def test_default_mode_writes_the_jax_trainers_files(recon_runs):
    """camera_rays.png, the feedback PNGs and the snapshots under the JAX
    trainer's names; two held-out tests (one a stage) with PSNR and SSIM,
    and their time left out of the training time."""
    jout, tout, records = recon_runs
    assert _files(tout) == _files(jout)
    names = _files(tout)
    for name in ("camera_rays.png", "training_logs/rendered_output/default_iter_1.png",
                 "training_logs/rendered_output/default_diffuse_iter_6.png",
                 "saved_models/model_stage_2_iter_4.pth", "saved_models/model_final.pth"):
        assert name in names
    tests = [r.test_metrics for r in records if hasattr(r, "test_metrics")]
    assert [r.global_step for r in records if hasattr(r, "test_metrics")] == [3, 6]
    assert all(set(m) == {"psnr", "ssim"} and np.isfinite(m["psnr"]) and 0.0 < m["ssim"] <= 1.0 for m in tests)
    stages = [r for r in records if hasattr(r, "stage_training_s")]
    assert [r.stage for r in stages] == [1, 2]
    assert all(r.stage_feedback_s > 0.0 and r.stage_test_s > 0.0 for r in stages)
    done = next(r for r in records if hasattr(r, "time_training"))
    assert done.time_training == pytest.approx(sum(r.stage_training_s for r in stages))


def test_default_route_writes_the_jax_trainers_files(scene, tmp_path):
    """The CLIs at their default route, shear-warp, and default kernel
    flags, at their smallest (8^3, 1 stage x 3 iterations: feedback at 1
    and 3, the held-out test at 3): the same file names as the JAX trainer
    (the JAX jits take 26 s of it on one core)."""
    args = ["-d", str(scene), "--grid_dims", "8", "8", "8", "--num_stages", "1", "--num_iterations_per_stage", "3",
            "--render_num_samples_per_ray", "32"]
    jcli.main(args + ["-o", str(tmp_path / "jax"), "--num_workers", "0"], standalone_mode=False)
    tcli.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert "training_logs/rendered_output/default_iter_3.png" in _files(tmp_path / "torch")


def test_tester_matches_jax(recon_runs, scene):
    """The port's model_final.pth through both testers, on the held-out
    views at 64 samples: PSNR and SSIM within 1e-4 (the exact renders agree
    to f32 rounding; SSIM's windows sum them in another order)."""
    _, tout, _ = recon_runs
    path = tout / "saved_models" / "model_final.pth"
    jm, _ = jvol.load_volumetric_model(path)
    tm, _ = tvol.load_volumetric_model(path, device="cpu")
    kw = dict(images_dir=scene / "test", camera_params_json=scene / "test_camera_params.json", rgba_white_bkgd=True)
    j = j_tester(jm, JDataset(**kw), None, 6)
    t = t_tester(tm, TDataset(device="cpu", **kw), None, 6)
    assert set(t) == set(j) == {"psnr", "ssim"}
    for name in ("psnr", "ssim"):
        assert t[name] == pytest.approx(j[name], rel=0, abs=1e-4)


@pytest.fixture(scope="module")
def lpips_dir(tmp_path_factory):
    return _synthesize_weights(tmp_path_factory.mktemp("lpips"))


def test_lpips_matches_jax_package(lpips_dir):
    """The port's LPIPS on random weights against the JAX package's (both
    torch on the CPU, the same layer sequence): within 1e-5 relative, on
    tensors and on arrays; weights that do not load give None."""
    rng = np.random.default_rng(2)
    img0 = rng.random((48, 40, 3), dtype=np.float32)
    img1 = np.clip(img0 + 0.2 * rng.standard_normal((48, 40, 3)).astype(np.float32), 0, 1)
    ref = jlpips.LPIPS(lpips_dir)(img0, img1)
    port = tlpips.LPIPS(lpips_dir)
    assert ref > 0.0
    assert port(torch.from_numpy(img0), torch.from_numpy(img1)) == pytest.approx(ref, rel=1e-5)
    assert port(img0, img1) == pytest.approx(ref, rel=1e-5)
    assert tlpips.try_load_lpips(lpips_dir / "missing") is None and tlpips.try_load_lpips(None) is None


def test_tester_reports_lpips_when_weights_load(recon_runs, scene, lpips_dir, monkeypatch):
    """With weights (argument or $VOXE_LPIPS_WEIGHTS_DIR) the tester adds
    LPIPS, the JAX tester's within 1e-5 relative, and writes every metric
    as a `test_<name>` scalar."""
    _, tout, _ = recon_runs
    path = tout / "saved_models" / "model_final.pth"
    jm, _ = jvol.load_volumetric_model(path)
    tm, _ = tvol.load_volumetric_model(path, device="cpu")
    kw = dict(images_dir=scene / "test", camera_params_json=scene / "test_camera_params.json", rgba_white_bkgd=True)
    j = j_tester(jm, JDataset(**kw), None, 6, lpips_weights_dir=lpips_dir)

    class Writer:
        scalars = []

        def add_scalar(self, name, value, global_step):
            self.scalars.append((name, value, global_step))

    monkeypatch.setenv("VOXE_LPIPS_WEIGHTS_DIR", str(lpips_dir))
    t = t_tester(tm, TDataset(device="cpu", **kw), Writer(), 6)
    assert set(t) == {"psnr", "ssim", "lpips"}
    assert t["lpips"] == pytest.approx(j["lpips"], rel=1e-5)
    assert Writer.scalars == [(f"test_{k}", t[k], 6) for k in ("psnr", "ssim", "lpips")]


@pytest.mark.parametrize("num_rays", [1, 3])
def test_camera_ray_geometry_matches_cast_rays(scene, num_rays):
    """The picked pixels' rays against `cast_rays` at those pixels, for
    every train pose (1e-6: cast_rays is f32)."""
    ds = TDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True, device="cpu")
    origins, dirs = camera_ray_geometry(ds.poses, ds.camera_intrinsics, num_rays)
    h, w = ds.camera_intrinsics.height, ds.camera_intrinsics.width
    picks = np.linspace(0, h * w - 1, num_rays).astype(int)
    assert origins.shape == (len(ds), 3) and dirs.shape == (len(ds), num_rays, 3)
    for i, pose in enumerate(ds.poses):
        rays = j_cast_rays(ds.camera_intrinsics, jnp.asarray(pose[:, :3]), jnp.asarray(pose[:, 3:]))
        ref_d = np.asarray(rays.directions).reshape(-1, 3)[picks]
        ref_o = np.asarray(rays.origins).reshape(-1, 3)[picks]
        np.testing.assert_allclose(dirs[i], ref_d, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.broadcast_to(origins[i], ref_o.shape), ref_o, rtol=0, atol=1e-6)
