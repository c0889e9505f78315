"""Parity of the port's refinement stage against voxe_tpu on the CPU, on the
grid side: the attention fields of the grid, the shear-warp attention
render (1 and 2 channels, frozen densities, both tails, f32 and bf16
tables) and its gradient, the screen and exact attention renders, the
native max-flow and component labelling, the graph cut, the keep grid and
the voxel merge (bitwise), the SCC post-process, attention checkpoints
across the packages, the refinement PNGs, and the refine and segment CLIs
(flags, and tiny runs on the CPU, as the edit CLI's `--do_refinement`).

Inputs are made with numpy from a seed and fed to both packages; draws that
JAX makes with `jax.random` are replayed into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models import volumetric as jvol
from voxe_tpu.render import interface as jinterface
from voxe_tpu.render import shearwarp as jsw
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.render.rays import Rays as JRays
from voxe_tpu.seg import components as jcomp
from voxe_tpu.seg import graphcut as jgc
from voxe_tpu.seg import native as jnative
from voxe_tpu.utils import camera as jcam
from voxe_tpu_torch.cli import edit_pretrained_relu_field as tedit_cli
from voxe_tpu_torch.cli import refine_edited_relu_field as trefine_cli
from voxe_tpu_torch.cli import segment_attn_relu_field as tseg_cli
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as trecon_cli
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.models.sd.weights import voxel_grid_from_numpy
from voxe_tpu_torch.parallel import distributed as tdist
from voxe_tpu_torch.render import interface as tinterface
from voxe_tpu_torch.render import shearwarp as tsw
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.render.rays import Rays as TRays
from voxe_tpu_torch.seg import components as tcomp
from voxe_tpu_torch.seg import graphcut as tgc
from voxe_tpu_torch.seg import native as tnative
from voxe_tpu_torch.utils import camera as tcam
from voxe_tpu_torch.viz import _jet
from voxe_tpu_torch.viz import refinement as tviz

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False

GRID_KW = dict(density_preactivation="identity", density_postactivation="softplus", expected_density_scale=3.0)


def _arrays(res=12, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(-1.0, 2.0, (res, res, res, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (res, res, res, 3)).astype(np.float32)
    attn = rng.normal(0.0, 1.5, (res, res, res, channels)).astype(np.float32)
    orig = (dens + rng.normal(0.0, 0.5, dens.shape)).astype(np.float32)
    return dens, feats, attn, orig


def _grids(res=12, channels=2, seed=0, gather_dtype="float32"):
    """The same grid with an attention field and frozen densities in both
    packages (copies: a jax array may share numpy's buffer)."""
    dens, feats, attn, orig = _arrays(res, channels, seed)
    vs = [3.0 / res] * 3
    jg = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats),
                        jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs), gather_dtype=gather_dtype, **GRID_KW),
                        attn=jnp.asarray(attn), orig_densities=jnp.asarray(orig))
    tg = voxel_grid_from_numpy(dens, feats, tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), gather_dtype=gather_dtype,
                                                                  **GRID_KW), device="cpu", attn=attn, orig_densities=orig)
    return jg, tg


def _cfgs(**kw):
    kw = dict(num_samples_per_ray=32, white_bkgd=True, render_num_samples_per_ray=40, **kw)
    return (JRenderConfig(camera_bounds=jcam.CameraBounds(2.0, 6.0), **kw),
            TRenderConfig(camera_bounds=tcam.CameraBounds(2.0, 6.0), **kw))


def test_attn_fields_query_and_rescale():
    """grid_query_attn (live and frozen densities), scale_voxel_grid with
    the attention channel, and the frozen snapshot."""
    jg, tg = _grids(res=8, channels=1)
    pts = np.random.default_rng(1).uniform(-1.6, 1.6, (300, 3)).astype(np.float32)
    for orig in (False, True):
        np.testing.assert_allclose(
            tvox.grid_query_attn(tg, torch.from_numpy(pts), use_orig_densities=orig).numpy(),
            np.asarray(jvox.grid_query_attn(jg, jnp.asarray(pts), use_orig_densities=orig)), rtol=1e-5, atol=1e-6,
        )
    js, ts = jvox.scale_voxel_grid(jg, (11, 6, 9), include_attn=True), tvox.scale_voxel_grid(tg, (11, 6, 9), include_attn=True)
    np.testing.assert_allclose(ts.attn.numpy(), np.asarray(js.attn), atol=2e-6)
    np.testing.assert_allclose(ts.densities.numpy(), np.asarray(js.densities), atol=2e-6)
    assert tvox.scale_voxel_grid(tg, (4, 4, 4)).attn is None
    frozen = tg.replace(densities=tg.densities.clone().requires_grad_(True)).with_frozen_orig_densities()
    assert not frozen.orig_densities.requires_grad and torch.equal(frozen.orig_densities, tg.densities)
    with pytest.raises(ValueError, match="attn"):
        tvox.grid_query_attn(tg.replace(attn=None), torch.from_numpy(pts))


@pytest.mark.parametrize(
    "channels,orig,fused,gather_dtype,view",
    [
        (1, False, False, "float32", (10.0, 85.0)),
        (2, True, False, "bfloat16", (190.0, 85.0)),
        (2, True, True, "float32", (10.0, 5.0)),
    ],
    ids=["1ch-streamed-f32", "2ch-orig-streamed-bf16", "2ch-orig-fused-f32"],
)
def test_shearwarp_attn_render_matches_jax(channels, orig, fused, gather_dtype, view):
    """`render_shear_warp(attn_mode=True, background_value=0)` and the
    gradient of a weighted sum of it w.r.t. the attention field, on the
    streamed tail and the monolithic one (fused compositing; its one-channel
    case runs in the screen-render test below). f32 table: 1e-5 (values,
    and gradients relative to their max); bf16 table: 3e-2 (torch rounds
    each bf16 resample product once more than XLA:CPU)."""
    jg, tg = _grids(channels=channels, seed=2, gather_dtype=gather_dtype)
    jcfg, tcfg = _cfgs(use_fused_kernel=fused)
    pose = jcam.pose_spherical(*view, 4.0311)
    base = (20, 20)
    w = np.random.default_rng(3).standard_normal((base[0] * base[1], channels)).astype(np.float32)
    kw = dict(base_hw=base, attn_mode=True, use_orig_densities=orig, background_value=0.0)

    def jloss(a):
        out, _ = jsw.render_shear_warp(jg.replace(attn=a), jcam.CameraPose(*pose), jcfg, **kw)
        return jnp.sum(out.colour * w), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jg.attn)
    a = tg.attn.clone().requires_grad_(True)
    tout, _ = tsw.render_shear_warp(tg.replace(attn=a), tcam.CameraPose(*pose), tcfg, **kw)
    (tout.colour * torch.from_numpy(w)).sum().backward()
    tol = 1e-5 if gather_dtype == "float32" else 3e-2
    assert tout.colour.shape == (base[0] * base[1], channels)
    assert float(tout.colour.max()) > 0.05 and float(tout.colour.min()) >= 0.0
    np.testing.assert_allclose(tout.colour.detach().numpy(), np.asarray(jout.colour), rtol=0, atol=tol)
    np.testing.assert_allclose(tout.extra["accumulated_weight"].detach().numpy(),
                               np.asarray(jout.extra["accumulated_weight"]), rtol=0, atol=tol)
    scale = float(np.abs(np.asarray(jgrad)).max())
    assert scale > 0.0
    assert float(np.abs(a.grad.numpy() - np.asarray(jgrad)).max()) <= tol * scale


def test_screen_and_exact_attn_renders_match_jax():
    """`VolumetricModel.render(attn=True)` on the shear-warp screen path
    (monolithic tail, one channel) and on the exact renderer over the frozen
    densities, and the differentiable exact attention render with JAX's
    jitter replayed, its gradient included (f32: 1e-5, gradients relative to
    their max)."""
    jg, tg = _grids(channels=1, seed=4)
    jcfg, tcfg = _cfgs(use_fused_kernel=True, parallel_rays_chunk_size=100)
    jm, tm = jvol.VolumetricModel(jg, jcfg), tvol.VolumetricModel(tg, tcfg)
    intr = (14, 18, 18.0)
    pose = jcam.pose_spherical(130.0, 60.0, 4.0311)
    for kw in (dict(use_shear_warp=True), dict(use_orig_densities=True)):
        jo = jm.render(jcam.CameraIntrinsics(*intr), pose, attn=True, **kw)
        to = tm.render(tcam.CameraIntrinsics(*intr), pose, attn=True, **kw)
        assert to.colour.shape == (14, 18, 1) and float(to.colour.max()) > 0.05
        np.testing.assert_allclose(to.colour.numpy(), np.asarray(jo.colour), rtol=0, atol=1e-5)

    rng = np.random.default_rng(5)
    o = np.tile(np.asarray(pose.translation, np.float32).reshape(1, 3), (60, 1))
    d = (-o / np.linalg.norm(o, axis=1, keepdims=True) + 0.15 * rng.standard_normal((60, 3))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    t_rand = np.array(jax.random.uniform(jax.random.split(key)[0], (60, 32), dtype=jnp.float32))
    wts = rng.standard_normal((60, 1)).astype(np.float32)

    def jloss(a):
        out = jinterface.render_sh_voxel_grid_attn(jg.replace(attn=a), JRays(jnp.asarray(o), jnp.asarray(d)), jcfg, key=key)
        return jnp.sum(out.colour * wts), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jg.attn)
    a = tg.attn.clone().requires_grad_(True)
    tout = tinterface.render_sh_voxel_grid_attn(
        tg.replace(attn=a), TRays(torch.from_numpy(o), torch.from_numpy(d)), tcfg, t_rand=torch.from_numpy(t_rand)
    )
    (tout.colour * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(tout.colour.detach().numpy(), np.asarray(jout.colour), rtol=0, atol=1e-5)
    scale = float(np.abs(np.asarray(jgrad)).max())
    assert scale > 0.0 and float(np.abs(a.grad.numpy() - np.asarray(jgrad)).max()) <= 1e-5 * scale


def test_native_maxflow_and_components_match_jax():
    """The port's own build of the C++ backend against the JAX package's:
    flow and labels of random graphs (both algorithms) and cc3d-style
    labels at each connectivity, bitwise."""
    assert tnative.build().parent.name == "_build" and tnative.SEG_SRC_DIR.parent.parent.name == "voxe_tpu_torch"
    rng = np.random.default_rng(7)
    n, m = 300, 1500
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    cap, cap_rev = rng.random(m).astype(np.float32), rng.random(m).astype(np.float32)
    src = np.where(rng.random(n) < 0.05, 1e30, rng.random(n) * 0.5).astype(np.float32)
    snk = np.where(rng.random(n) < 0.05, 1e30, rng.random(n) * 0.5).astype(np.float32)
    for algo in ("bk", "dinic"):
        jf, jl = jnative.maxflow_mincut(n, u, v, cap, cap_rev, src, snk, algo=algo)
        tf, tl = tnative.maxflow_mincut(n, u, v, cap, cap_rev, src, snk, algo=algo)
        assert tf == jf and np.array_equal(tl, jl) and 0 < tl.sum() < n
    vol = rng.random((14, 12, 10)) > 0.62
    for conn in (26, 18, 6):
        jl, jn = jnative.largest_k(vol, k=5, connectivity=conn)
        tl, tn = tnative.largest_k(vol, k=5, connectivity=conn)
        assert tn == jn and np.array_equal(tl, jl)


def _seg_models(res=20, seed=8, strong_edit=True):
    """Edit / object / output / reference models in both packages: a blob of
    density, an edit attention peak in one corner of it."""
    rng = np.random.default_rng(seed)
    dens = np.full((res, res, res, 1), -3.0, np.float32)
    dens[4:16, 5:15, 3:17] = rng.uniform(0.5, 3.0, (12, 10, 14, 1))
    feats = rng.uniform(-2, 2, (res, res, res, 3)).astype(np.float32)
    x = np.arange(res)[:, None, None]
    edit = np.where(x > 10, 6.0, -1.0)[..., None] + rng.normal(0, 0.3 if strong_edit else 2.0, (res, res, res, 1))
    obj = np.where(x > 10, -1.0, 2.0)[..., None] + rng.normal(0, 1.0, (res, res, res, 1))
    ref_d = (dens + rng.normal(0, 0.5, dens.shape)).astype(np.float32)
    ref_f = rng.uniform(-1, 1, feats.shape).astype(np.float32)
    cfg_kw = dict(voxel_size=[3.0 / res] * 3)
    out = {}
    for pkg, vox, vol, to in (("jax", jvox, jvol, jnp.asarray), ("torch", tvox, tvol, torch.tensor)):
        cfg = vox.VoxelGridConfig(voxel_size=vox.VoxelSize(*cfg_kw["voxel_size"]), **GRID_KW)
        rcfg = _cfgs()[0 if pkg == "jax" else 1]

        def model(a, d=dens, f=feats):
            return vol.VolumetricModel(vox.VoxelGrid(to(d), to(f), cfg, attn=None if a is None else to(a.astype(np.float32))), rcfg)

        out[pkg] = (model(edit), model(obj), model(np.full_like(dens, -20.0)), model(None, ref_d, ref_f))
    return out


def _merge_jax(out_model, ref_model):
    """The merge of the JAX refinement loop (voxe_tpu/train/refine.py, the keep mask)."""
    keep = np.asarray(out_model.grid.attn)[..., 0] != 0.0
    d, f = np.asarray(out_model.grid.densities).copy(), np.asarray(out_model.grid.features).copy()
    d[keep], f[keep] = np.asarray(ref_model.grid.densities)[keep], np.asarray(ref_model.grid.features)[keep]
    return d, f


@pytest.mark.parametrize("case", ["seeded", "top_k_fallback", "downsampled"])
def test_graph_cut_and_merge_match_jax(case):
    """`get_edit_region` (build_graph with its seeded object draw, the
    top-k fallback, the 4x downsampled graph) and the voxel merge: segments,
    node indices, keep grid and merged grid bitwise."""
    models = _seg_models(strong_edit=case != "top_k_fallback")
    kw = dict(min_num_edit_voxels=300 if case == "seeded" else 10**6, num_obj_voxels_thresh=400)
    if case == "downsampled":  # 45 nodes: top-k seeds scaled down with the graph
        kw.update(downsample_grid=True, top_k_edit_thresh=10, top_k_obj_thresh=10)
    je, jo, jout, jref = models["jax"]
    te, to, tout, tref = models["torch"]
    jseg, jidx = jgc.get_edit_region(je, jo, jout, **kw)
    tseg, tidx = tgc.get_edit_region(te, to, tout, **kw)
    assert 0 < (tseg == 0).sum() < len(tseg)
    np.testing.assert_array_equal(tseg, jseg)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tout.grid.attn.numpy(), np.asarray(jout.grid.attn))
    assert set(np.unique(tout.grid.attn.numpy())) == {-10.0, -5.0, 0.0}
    tgc.merge_edit_region(tout, tref)
    jd, jf = _merge_jax(jout, jref)
    np.testing.assert_array_equal(tout.grid.densities.numpy(), jd)
    np.testing.assert_array_equal(tout.grid.features.numpy(), jf)


def test_scc_post_process_matches_jax():
    rng = np.random.default_rng(9)
    dens = rng.normal(-0.5, 1.0, (16, 14, 12, 1)).astype(np.float32)
    ref = rng.normal(0.0, 1.0, dens.shape).astype(np.float32)
    t = tcomp.scc_post_process(dens, ref)
    np.testing.assert_array_equal(t, jcomp.scc_post_process(dens, ref))
    assert not np.array_equal(t, dens)


def test_attn_checkpoints_load_across_packages(tmp_path):
    """Grids with attention (2 channels) and frozen densities saved by either
    package load in the other bitwise; `with_attn` injects -20 in both."""
    jg, tg = _grids(res=6, channels=2, seed=10)
    jcfg, tcfg = _cfgs(use_fused_kernel=True)
    jvol.VolumetricModel(jg, jcfg).save(tmp_path / "j.pth")
    tvol.VolumetricModel(tg, tcfg).save(tmp_path / "t.pth")
    tl, _ = tvol.load_volumetric_model(tmp_path / "j.pth", device="cpu")
    jl, _ = jvol.load_volumetric_model(tmp_path / "t.pth")
    for src, loaded in ((jg, tl.grid), (jl.grid, tg)):
        for name in ("densities", "features", "attn", "orig_densities"):
            np.testing.assert_array_equal(np.asarray(getattr(loaded, name)), np.asarray(getattr(src, name)))
    jvol.VolumetricModel(jg.replace(attn=None, orig_densities=None), jcfg).save(tmp_path / "plain.pth")
    tp, _ = tvol.load_volumetric_model(tmp_path / "plain.pth", device="cpu", with_attn=True)
    jp, _ = jvol.load_volumetric_model(tmp_path / "plain.pth", with_attn=True)
    np.testing.assert_array_equal(tp.grid.attn.numpy(), np.asarray(jp.grid.attn))
    assert float(tp.grid.attn.max()) == -20.0 and tp.grid.orig_densities is None
    assert tvol.load_volumetric_model(tmp_path / "plain.pth", device="cpu")[0].grid.attn is None


def test_refinement_pngs_match_jax(tmp_path):
    """The jet table is matplotlib's; the target-map, render-diagnostic and
    render-difference PNGs are the JAX package's pixel for pixel."""
    import matplotlib

    from voxe_tpu.viz import refinement as jviz

    np.testing.assert_array_equal(_jet.JET_256, matplotlib.colormaps["jet"](np.arange(256))[:, :3])
    rng = np.random.default_rng(11)
    e, o = rng.random((24, 20)).astype(np.float32) * 0.2, rng.random((24, 20)).astype(np.float32) * 0.1
    r = np.where(rng.random((24, 20)) > 0.3, rng.random((24, 20)), 0.0).astype(np.float32)
    for pkg, viz in (("j", jviz), ("t", tviz)):
        d = tmp_path / pkg
        viz.visualize_attention_maps(e, o, 3, d)
        viz.visualize_attn_render_diagnostics(r, e, "edit", 3, d)
        viz.visualize_render_diff(r, e, 3, d)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 7 and names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / name)),
                                      np.asarray(Image.open(tmp_path / "j" / name)), err_msg=name)


@pytest.mark.parametrize("cli", ["refine_edited_relu_field", "segment_attn_relu_field"])
def test_cli_flags_match_click_command(cli):
    """Every flag of the JAX CLI with its short names and default; the port
    adds `--device` only."""
    import importlib

    jcli = importlib.import_module(cli)
    tcli = trefine_cli if cli.startswith("refine") else tseg_cli
    click_opts = {p.name: (sorted(p.opts), p.required, None if p.required else p.default) for p in jcli.main.params}
    port_opts = {a.dest: (sorted(a.option_strings), a.required, a.default)
                 for a in tcli.build_parser()._actions if a.dest != "help"}
    assert port_opts.pop("device") == (["--device"], False, "cuda")
    for name in ("grid_dims", "grid_location", "grid_world_size"):
        if name in port_opts:
            port_opts[name] = (*port_opts[name][:2], tuple(port_opts[name][2]))
    assert port_opts == click_opts


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 32^2 scene, a 16^3 recon and a 2-step tiny-SD edit, all by the
    port's CLIs on the CPU."""
    root = tmp_path_factory.mktemp("refine_cli")
    scene = root / "scene"
    generate_synthetic_scene(scene, num_train=4, num_test=2, image_size=32, focal=32.0, grid_res=24, device="cpu")
    for split in ("train", "test"):
        (scene / split).mkdir()
        for p in (scene / "images").glob(f"{split}_*.png"):
            p.rename(scene / split / p.name)
    trecon_cli.main(["-d", str(scene), "-o", str(root / "recon"), "--grid_dims", "16", "16", "16", "--num_stages", "1",
                     "--num_iterations_per_stage", "2", "--fast_debug_mode", "True", "--use_fused_kernel", "True",
                     "--device", "cpu"])
    edit_args = ["-i", str(root / "recon" / "saved_models" / "model_final.pth"), "-p", "a dog wearing a hat",
                 "-d", str(scene), "--data_downsample_factor", "1", "--sd_version", "tiny", "--num_iterations_edit", "2",
                 "--fast_debug_mode", "True", "--device", "cpu"]
    tedit_cli.main(edit_args + ["-o", str(root / "edit")])
    return root, scene, edit_args


def test_refine_and_segment_clis_tiny_end_to_end(tiny_run, monkeypatch):
    """The refine CLI (3 shear-warp iterations, feedback and snapshots every
    2) and the segment CLI on its attention grids: checkpoints that both
    packages load, the keep grid, diagnostics PNGs; `--num_devices 2` hands
    the command to two spawned ranks (recorded here, not started:
    tests/test_torch_parallel.py runs them); two iterations a call; a short
    dataset-pose run."""
    root, scene, _ = tiny_run
    recon, edit = root / "recon" / "saved_models" / "model_final.pth", root / "edit" / "saved_models" / "model_final.pth"
    args = ["-d", str(scene), "-i", str(edit), "-r", str(recon), "-p", "a dog wearing a hat", "-eidx", "4 5",
            "--data_downsample_factor", "1", "--sd_version", "tiny", "--min_num_edit_voxels", "10", "--device", "cpu"]
    trefine_cli.main(args + ["-o", str(root / "refine"), "--num_iterations_per_stage", "3", "--feedback_frequency", "2",
                             "--save_frequency", "2"])
    saved = root / "refine" / "saved_models"
    assert sorted(p.name for p in saved.iterdir()) == sorted(
        [f"model_{g}_iter_{i}.pth" for g in ("edit", "object") for i in (1, 2, 3)]
        + ["model_final_attn_edit.pth", "model_final_attn_object.pth", "model_final_refined.pth"]
    )
    renders = {p.name for p in (root / "refine" / "training_logs" / "rendered_output").iterdir()}
    assert {"attn_attn_iter_2.png", "edit_attn_map_3.png", "mask_object_1.png", "render_diff_2.png",
            "scatter3d_ids_0.png"} <= renders
    refined, _ = tvol.load_volumetric_model(saved / "model_final_refined.pth", device="cpu")
    j_refined, _ = jvol.load_volumetric_model(saved / "model_final_refined.pth")
    np.testing.assert_array_equal(np.asarray(j_refined.grid.attn), refined.grid.attn.numpy())
    assert set(np.unique(refined.grid.attn.numpy())) <= {-10.0, -5.0, 0.0}
    assert tvol.load_volumetric_model(edit, device="cpu")[0].grid.attn is None
    trained, _ = tvol.load_volumetric_model(saved / "model_final_attn_edit.pth", device="cpu")
    assert float((trained.grid.attn + 20.0).abs().max()) > 0.0  # the attention grid trained

    tseg_cli.main(["-d", str(scene), "-ie", str(saved / "model_final_attn_edit.pth"),
                   "-io", str(saved / "model_final_attn_object.pth"), "-r", str(recon), "-i", str(edit),
                   "-o", str(root / "seg"), "--data_downsample_factor", "1", "--min_num_edit_voxels", "10",
                   "--device", "cpu"])
    seg, _ = tvol.load_volumetric_model(root / "seg" / "saved_models" / "model_final_refined.pth", device="cpu")
    # the same graph cut on the same grids: the segment CLI reproduces the refine CLI's merge
    assert torch.equal(seg.grid.attn, refined.grid.attn) and torch.equal(seg.grid.densities, refined.grid.densities)
    assert {"attn_final_attn_iter_0.png", "sds_refined_iter_0.png", "scatter3d_locations_0.png"} <= {
        p.name for p in (root / "seg" / "training_logs" / "rendered_output").iterdir()}
    spawned = []
    monkeypatch.setattr(tdist, "launch_local", lambda fn, fn_args, n: spawned.append((fn, fn_args, n)))
    trefine_cli.main(args + ["-o", str(root / "x"), "--num_devices", "2"])
    assert spawned == [(trefine_cli.main, (args + ["-o", str(root / "x"), "--num_devices", "2"],), 2)]
    assert not (root / "x").exists()
    monkeypatch.undo()
    # two iterations a call: 3 iterations are calls ending at 2 and 3, and the
    # JAX K-step cadence snapshots both (step % 2 < 2), never iteration 1
    trefine_cli.main(args + ["-o", str(root / "refine_k2"), "--num_iterations_per_stage", "3", "--steps_per_call", "2",
                             "--save_frequency", "2"])
    assert sorted(p.name for p in (root / "refine_k2" / "saved_models").glob("model_edit_iter_*")) == [
        "model_edit_iter_2.pth", "model_edit_iter_3.pth"]
    # dataset-pose mode (shear-warp, the dataset poses' guard), fast debug: no feedback
    trefine_cli.main(args + ["-o", str(root / "refine_data"), "--num_iterations_per_stage", "2", "--data_pose_mode", "True",
                             "--save_frequency", "5"])
    assert (root / "refine_data" / "saved_models" / "model_object_iter_2.pth").exists()


def test_edit_cli_with_refinement_and_scc(tiny_run):
    """`edit --do_refinement True --post_process_scc True` on the CPU: the
    edit, 2 refinement iterations on the exact renderer, the graph cut and
    merge, and the SCC post-process of the refined model."""
    root, _, edit_args = tiny_run
    out = root / "edit_refine"
    tedit_cli.main(edit_args + ["-o", str(out), "--do_refinement", "True", "--post_process_scc", "True", "-eidx", "4",
                                "--num_iterations_refine", "2", "--use_shear_warp", "False",
                                "--render_num_samples_per_ray", "32", "--min_num_edit_voxels", "10"])
    saved = out / "saved_models"
    refined, _ = tvol.load_volumetric_model(saved / "model_final_refined.pth", device="cpu")
    assert refined.grid.attn is not None and refined.grid.grid_dims == (16, 16, 16)
    assert (saved / "model_object_iter_2.pth").exists()
    assert (out / "training_logs" / "rendered_output" / "pred_attn_edit_2.png").exists()
