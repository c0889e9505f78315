"""Parity of the port's render side against voxe_tpu on the CPU: the camera
paths, the MJPEG-AVI muxer, the five camera-path animation functions (exact
and shear-warp routes) and both render CLIs end to end, on one checkpoint
written by the JAX package (16^3 f32 grid with an attention channel, a 24^2
screen, 32 samples a ray, 3 frames).

Frames are uint8 from `to8b`'s truncation on both sides, so an f32 render
that differs by a rounding can land one level apart: colour frames are held
within 1 level. A jet-coloured frame amplifies that: one level of attention
can move the lookup one entry of the 256-entry table, up to 1/64 of the
range (about 4 levels). So on the shear-warp route the uint8 attention and
coverage frames are held within 1 level, and the colouring and blending on
top of them is held bitwise by feeding both packages the same frames."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import render_sh_based_voxel_grid as jrender_cli
import render_sh_based_voxel_grid_attn as jattn_cli
from tests.test_torch_sd import _numpy_params
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models import volumetric as jvol
from voxe_tpu.models.sd.config import tiny_test_config as j_tiny
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.utils import camera as jcam
from voxe_tpu.viz import animations as janim
from voxe_tpu.viz import video as jvideo
from voxe_tpu_torch.cli import render_sh_based_voxel_grid as trender_cli
from voxe_tpu_torch.cli import render_sh_based_voxel_grid_attn as tattn_cli
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.models.sd.config import tiny_test_config as t_tiny
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.utils import camera as tcam
from voxe_tpu_torch.viz import animations as tanim
from voxe_tpu_torch.viz import video as tvideo

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

RES, SCREEN, SAMPLES, NUM_FRAMES = 16, 24, 32, 4  # NUM_FRAMES 4: 3 poses on the turntable
INFO = {"camera_intrinsics": [SCREEN, SCREEN, float(SCREEN)], "hemispherical_radius": 4.0311,
        "camera_bounds": [2.0, 6.0]}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written checkpoint: f32 gather, SH degree 1, an attention
    channel, the fused compositing tail (its plain version on the CPU)."""
    rng = np.random.default_rng(7)
    dens = rng.uniform(-1.0, 2.0, (RES, RES, RES, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (RES, RES, RES, 12)).astype(np.float32)
    attn = rng.normal(0.0, 2.0, (RES, RES, RES, 1)).astype(np.float32)
    config = jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*[3.0 / RES] * 3), density_preactivation="identity",
                                  density_postactivation="softplus", expected_density_scale=3.0, gather_dtype="float32")
    grid = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats), config, attn=jnp.asarray(attn))
    rcfg = JRenderConfig(num_samples_per_ray=SAMPLES, camera_bounds=jcam.CameraBounds(2.0, 6.0),
                         render_num_samples_per_ray=SAMPLES, parallel_rays_chunk_size=256, use_fused_kernel=True)
    path = tmp_path_factory.mktemp("ckpt") / "model_final.pth"
    jvol.VolumetricModel(grid, rcfg).save(path, extra_info=INFO)
    return path


@pytest.fixture(scope="module")
def models(ckpt):
    """(JAX model, port model, 24^2 intrinsics, the 3 turntable poses), both
    on a white background as the CLIs render."""
    jm, _ = jvol.load_volumetric_model(ckpt, with_attn=True)
    tm, _ = tvol.load_volumetric_model(ckpt, device="cpu", with_attn=True)
    jm.render_config = jm.render_config.replace(white_bkgd=True)
    tm.render_config = tm.render_config.replace(white_bkgd=True)
    intr = jcam.CameraIntrinsics(SCREEN, SCREEN, float(SCREEN))
    return jm, tm, intr, jcam.get_thre360_animation_poses(4.0311, 60.0, NUM_FRAMES)


def _within_one_level(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


@pytest.mark.parametrize("num_poses", [2, 9, 180])
def test_camera_paths_match_jax(num_poses):
    """Turntable and spiral poses, num_poses - 1 of them, and the scaled
    intrinsics: the same numpy arithmetic in both packages (1e-12)."""
    pairs = [
        (jcam.get_thre360_animation_poses(4.0311, 60.0, num_poses),
         tcam.get_thre360_animation_poses(4.0311, 60.0, num_poses)),
        (jcam.get_thre360_spiral_animation_poses((0.5, 4.0311), 3.0, 2, num_poses),
         tcam.get_thre360_spiral_animation_poses((0.5, 4.0311), 3.0, 2, num_poses)),
    ]
    for jposes, tposes in pairs:
        assert len(jposes) == len(tposes) == num_poses - 1
        for jp, tp in zip(jposes, tposes):
            np.testing.assert_allclose(tp.rotation, jp.rotation, rtol=0, atol=1e-12)
            np.testing.assert_allclose(tp.translation, jp.translation, rtol=0, atol=1e-12)
    intr = (400, 300, 400.0)
    for factor in (2.0, 0.75, 1.0 / 3.0):
        assert tuple(tcam.scale_camera_intrinsics(tcam.CameraIntrinsics(*intr), factor)) == tuple(
            jcam.scale_camera_intrinsics(jcam.CameraIntrinsics(*intr), factor))


def test_to8b_tensor_truncates_as_to8b():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (64, 64, 3)).astype(np.float32)
    x[0, :4, 0] = [254.999 / 255, 1.0, 0.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    np.testing.assert_array_equal(tcam.to8b_tensor(torch.from_numpy(x)).numpy(), jcam.to8b(x))


def test_muxer_bytes_match_jax(tmp_path):
    """The same frames give the same file, byte for byte (Pillow JPEG at
    quality 92 on both sides); it reads back as an AVI of those frames."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (24, 40, 3), dtype=np.uint8) for _ in range(3)] + [np.zeros((24, 40, 3), np.uint8)]
    jvideo._write_mjpeg_avi(tmp_path / "j.avi", frames, 60)
    path = tvideo.write_video(tmp_path / "rendered_video.mp4", np.stack(frames), fps=60)
    assert path.read_bytes() == (tmp_path / "j.avi").read_bytes()
    num_frames, width, height, jpegs = tvideo.read_mjpeg_avi(path)
    assert (num_frames, width, height, len(jpegs)) == (4, 40, 24, 4)
    for j, frame in zip(jpegs, frames):
        assert Image.open(io.BytesIO(j)).size == (40, 24) and j == tvideo._encode_jpeg(frame)
    (tmp_path / "x.wav").write_bytes(b"RIFF\4\0\0\0WAVE")
    with pytest.raises(ValueError, match="RIFF/AVI"):
        tvideo.read_mjpeg_avi(tmp_path / "x.wav")


@pytest.mark.parametrize("use_shear_warp", [False, True])
def test_colour_path_matches_jax(models, tmp_path, use_shear_warp):
    jm, tm, intr, poses = models
    kw = dict(overridden_num_samples_per_ray=SAMPLES, render_scale_factor=1.0, use_shear_warp=use_shear_warp)
    j = janim.render_camera_path_for_volumetric_model(jm, poses, intr, **kw)
    t = tanim.render_camera_path_for_volumetric_model(tm, poses, intr, image_save_freq=2, image_save_path=tmp_path, **kw)
    assert t.shape == (3, SCREEN, SCREEN, 3)
    _within_one_level(t, j)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_0.png", "frame_2.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "frame_2.png")), t[2])


ATTN_FUNCTIONS = ["render_camera_path_for_volumetric_model_attn",
                  "render_camera_path_for_volumetric_model_attn_only",
                  "render_camera_path_for_volumetric_model_attn_blend"]


@pytest.mark.parametrize("name", ATTN_FUNCTIONS)
def test_attention_paths_match_jax_exact(models, name):
    """The exact route: both packages colour the same f32 renders (within
    rounding), so the frames agree within 1 level."""
    jm, tm, intr, poses = models
    kw = dict(overridden_num_samples_per_ray=SAMPLES, render_scale_factor=1.0)
    j = getattr(janim, name)(jm, poses, intr, **kw)
    t = getattr(tanim, name)(tm, poses, intr, **kw)
    assert t.shape == j.shape and t.shape[0] == 3
    _within_one_level(t, j)


@pytest.fixture(scope="module")
def fast_attn_frames(models):
    jm, tm, intr, poses = models
    j, t = jm.render_camera_path_fast_attn(intr, poses), tm.render_camera_path_fast_attn(intr, poses)
    return j, t


def test_fast_attention_frames_match_jax(models, fast_attn_frames):
    """The shear-warp route's uint8 RGB, attention and coverage frames
    within 1 level; include_rgb=False gives the same attention frames and
    no RGB; a pose inside the volume refuses the whole path."""
    jm, tm, intr, poses = models
    (jr, ja, jacc), (tr, ta, tacc) = fast_attn_frames
    for j, t in ((jr, tr), (ja, ta), (jacc, tacc)):
        _within_one_level(t, j)
    assert tr.shape == (3, SCREEN, SCREEN, 3) and ta.shape == tacc.shape == (3, SCREEN, SCREEN)
    assert ta.max() > 64 and tacc.max() > 128  # attention and coverage are not blank
    none, ta2, tacc2 = tm.render_camera_path_fast_attn(intr, poses, include_rgb=False)
    assert none is None
    np.testing.assert_array_equal(ta2, ta)
    np.testing.assert_array_equal(tacc2, tacc)
    inside = list(poses) + [jcam.pose_spherical(0.0, 60.0, 1.0)]
    with pytest.raises(ValueError, match="inside"):
        tm.render_camera_path_fast(intr, inside)
    with pytest.raises(ValueError, match="inside"):
        tm.render_camera_path_fast_attn(intr, inside)


@pytest.mark.parametrize("name", ATTN_FUNCTIONS)
def test_attention_paths_colouring_matches_jax_shear_warp(models, fast_attn_frames, monkeypatch, name):
    """The shear-warp route's colouring and blending, bitwise: the port's
    function given the JAX frames (held within 1 level above) gives the JAX
    function's output."""
    jm, tm, intr, poses = models
    (jr, ja, jacc), _ = fast_attn_frames
    calls = []

    def jax_frames(camera_intrinsics, camera_path, include_rgb=True):
        calls.append(include_rgb)
        return (jr if include_rgb else None), ja, jacc

    monkeypatch.setattr(tm, "render_camera_path_fast_attn", jax_frames)
    kw = dict(overridden_num_samples_per_ray=SAMPLES, render_scale_factor=1.0, use_shear_warp=True)
    j = getattr(janim, name)(jm, poses, intr, **kw)
    t = getattr(tanim, name)(tm, poses, intr, **kw)
    np.testing.assert_array_equal(t, j)
    assert calls == [name != "render_camera_path_for_volumetric_model_attn_only"]


def test_gt_attn_maps_path_matches_jax(models):
    """Live SD attention frames with the tiny SD (32^2, f32, the same seeded
    parameters), t fixed at 200, the JAX per-frame draws replayed: the RGB
    half within 1 level; the attention half is the jet colouring of a map
    held within 1e-4 of its max (test_torch_refine.py), so a pixel may cross
    one lookup entry: within 5 levels (4 for the entry, 1 for the
    truncation), and within 1 level on 97 % of the pixels."""
    jm, tm, intr, poses = models
    jsd = JSD(config=j_tiny(image_size=32), unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=21)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD(config=t_tiny(image_size=32), unet_dtype=torch.float32, device="cpu")
    tsd.load_flax_params(params)
    key = jax.random.PRNGKey(5)
    prompt, token = "a dog wearing a hat", 3
    j = janim.render_camera_path_for_volumetric_model_gt_attn_maps(
        jm, poses, intr, jsd, prompt, token, key, timestamp=200, overridden_num_samples_per_ray=SAMPLES)
    draws, k = [], key
    for _ in poses:  # the JAX function's draws: key -> sub -> (k_t, k_run) -> (k_enc, k_noise)
        k, sub = jax.random.split(k)
        k_enc, k_noise = jax.random.split(jax.random.split(sub)[1])
        draws.append([torch.tensor(np.asarray(jax.random.normal(kk, (1, 16, 16, 4)))) for kk in (k_enc, k_noise)])
    get_attn_map = tsd.get_attn_map

    def replayed(*args, **kw):
        eps, noise = draws.pop(0)
        return get_attn_map(*args, **kw, vae_eps=eps, noise=noise)

    tsd.get_attn_map = replayed
    t = tanim.render_camera_path_for_volumetric_model_gt_attn_maps(
        tm, poses, intr, tsd, prompt, token, torch.Generator().manual_seed(0), timestamp=200,
        overridden_num_samples_per_ray=SAMPLES)
    assert t.shape == j.shape == (3, SCREEN, 2 * SCREEN, 3) and not draws
    _within_one_level(t[:, :, :SCREEN], j[:, :, :SCREEN])
    diff = np.abs(t[:, :, SCREEN:].astype(int) - j[:, :, SCREEN:].astype(int)).max(-1)
    assert diff.max() <= 5 and (diff <= 1).mean() >= 0.97


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Train poses for the dataset camera path (the port's synthetic scene)."""
    root = tmp_path_factory.mktemp("scene")
    generate_synthetic_scene(root, num_train=3, num_test=1, image_size=16, focal=16.0, grid_res=12, device="cpu")
    (root / "train").mkdir()
    for p in (root / "images").glob("train_*.png"):
        p.rename(root / "train" / p.name)
    return root


def _frames_and_files(out):
    files = sorted(p.name for p in out.iterdir())
    frames = [np.asarray(Image.open(out / f"frame_{i}.png")) for i in range(len(files)) if (out / f"frame_{i}.png").exists()]
    return files, np.stack(frames)


@pytest.mark.parametrize("camera_path,use_shear_warp", [("thre360", False), ("spiral", True), ("dataset", False)])
def test_render_cli_matches_jax_cli(ckpt, scene, tmp_path, camera_path, use_shear_warp):
    """Both CLIs on the same checkpoint: the same files (frames, prompt.txt,
    the video) and frames within 1 level; the port's video is the JAX
    muxer's on the port's frames."""
    args = ["-i", str(ckpt), "--num_frames", str(NUM_FRAMES), "--overridden_num_samples_per_ray", str(SAMPLES),
            "--render_scale_factor", "1.0", "--save_freq", "1", "--camera_path", camera_path, "-d", str(scene),
            "--use_shear_warp", str(use_shear_warp), "-p", "a dog", "--fps", "12"]
    jrender_cli.main(args + ["-o", str(tmp_path / "jax")], standalone_mode=False)
    frames = trender_cli.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    jfiles, jframes = _frames_and_files(tmp_path / "jax")
    tfiles, tframes = _frames_and_files(tmp_path / "torch")
    assert tfiles == jfiles and "rendered_video.mp4" in tfiles and "prompt.txt" in tfiles
    assert tframes.shape == (3, SCREEN, SCREEN, 3)
    np.testing.assert_array_equal(tframes, frames)
    _within_one_level(tframes, jframes)
    jvideo._write_mjpeg_avi(tmp_path / "ref.avi", list(tframes), 12)
    assert (tmp_path / "torch" / "rendered_video.mp4").read_bytes() == (tmp_path / "ref.avi").read_bytes()


@pytest.mark.parametrize("use_shear_warp", [False, True])
def test_render_attn_cli_matches_jax_cli(ckpt, tmp_path, use_shear_warp):
    """The attention CLI's default blend on both routes: the same files;
    frames within 1 level on the exact route. On the shear-warp route the
    blend is coloured from uint8 frames that may differ by 1 level (held
    above), which moves a pixel by at most 0.55 (RGB) + 0.45 x 4 (one jet
    entry) + 1 (truncation) < 4 levels."""
    args = ["-i", str(ckpt), "--num_frames", str(NUM_FRAMES), "--overridden_num_samples_per_ray", str(SAMPLES),
            "--render_scale_factor", "1.0", "--save_freq", "2", "--use_shear_warp", str(use_shear_warp)]
    jattn_cli.main(args + ["-o", str(tmp_path / "jax")], standalone_mode=False)
    tattn_cli.main(args + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    jfiles, jframes = _frames_and_files(tmp_path / "jax")
    tfiles, tframes = _frames_and_files(tmp_path / "torch")
    assert tfiles == jfiles == ["frame_0.png", "frame_2.png", "rendered_video.mp4"]
    diff = np.abs(tframes.astype(int) - jframes.astype(int)).max()
    assert diff <= (3 if use_shear_warp else 1)
    assert tvideo.read_mjpeg_avi(tmp_path / "torch" / "rendered_video.mp4")[:3] == (3, SCREEN, SCREEN)


def test_render_attn_cli_live_sd_tiny(ckpt, tmp_path):
    """`--use_sd True --sd_version tiny` (the click command takes a free
    string): exact renders blended with the tiny SD's token map, seeded
    random weights; PNGs and a 3-frame video of the right size."""
    frames = tattn_cli.main([
        "-i", str(ckpt), "-o", str(tmp_path), "--num_frames", str(NUM_FRAMES), "--overridden_num_samples_per_ray",
        str(SAMPLES), "--render_scale_factor", "1.0", "--save_freq", "1", "--use_sd", "True", "--sd_version", "tiny",
        "--sds_prompt", "a dog wearing a hat", "--index_to_attn", "3", "--timestamp", "200", "--device", "cpu",
    ])
    assert frames.shape == (3, SCREEN, SCREEN, 3) and frames.dtype == np.uint8
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_0.png", "frame_1.png", "frame_2.png",
                                                          "rendered_video.mp4"]
    assert tvideo.read_mjpeg_avi(tmp_path / "rendered_video.mp4")[:3] == (3, SCREEN, SCREEN)
    assert len({f.tobytes() for f in frames}) == 3


@pytest.mark.parametrize("jcli,tcli", [(jrender_cli, trender_cli), (jattn_cli, tattn_cli)])
def test_cli_flags_match_click_command(jcli, tcli):
    """Every flag of the click command with its short name and default; the
    port adds `--device` only."""
    def default(p):  # an option with no default: None, or click's UNSET sentinel in newer versions
        return None if p.required or type(p.default).__name__ == "Sentinel" else p.default

    click_opts = {p.name: (sorted(p.opts), p.required, default(p)) for p in jcli.main.params}
    port_opts = {
        a.dest: (sorted(a.option_strings), a.required, a.default)
        for a in tcli.build_parser()._actions if a.dest != "help"
    }
    assert port_opts.pop("device") == (["--device"], False, "cuda")
    assert port_opts == click_opts
