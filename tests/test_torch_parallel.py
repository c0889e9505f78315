"""The port's data-parallel ray batching (voxe_tpu_torch/parallel) on the
CPU over gloo, at the sizes and tolerances of tests/test_parallel.py
(16^2 images, 8^3 to 12^3 grids, 16 samples; rtol 1e-4, atol 1e-5): the
sharded recon step (one gradient all-reduce a step), the sharded shear-warp
K-step, the SDS step with the tiny SD, the refinement's attention step and
the recon trainer, each against the unsharded torch step, the two recon
steps also against JAX's own steps on a 2-device mesh; the mesh helpers at
world size 3 (an uneven split); the group set-up from the JAX_* variables;
and the recon, edit and refine CLIs at `--num_devices 2`.

Each group runs once: two ranks (and three for the uneven split) start as
the module's first fixture, run every sharded check, and leave their
results on disk; the tests compute the unsharded and JAX references in this
process meanwhile, then compare. The CLIs' two-device runs start as
subprocesses beside them. Every process is joined with a deadline and
killed after it, and every group times out its collectives."""
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from voxe_tpu_torch.cli import edit_pretrained_relu_field as tedit_cli
from voxe_tpu_torch.cli import refine_edited_relu_field as trefine_cli
from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as trecon_cli
from voxe_tpu_torch.data.dataset import PosedImagesDataset
from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
from voxe_tpu_torch.grid.voxels import VoxelGrid, VoxelGridConfig, VoxelSize
from voxe_tpu_torch.models import volumetric as tvol
from voxe_tpu_torch.parallel import distributed as tdist
from voxe_tpu_torch.parallel import mesh as tmesh
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig
from voxe_tpu_torch.render.rays import cast_rays, flatten_rays
from voxe_tpu_torch.train import recon as trecon
from voxe_tpu_torch.train import refine as trefine
from voxe_tpu_torch.train import sds as tsds
from voxe_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LR = 0.01
DEADLINE_S = 150.0
INTR = CameraIntrinsics(16, 16, 16.0)
RAY_BATCH = 1024
GRID_KW = dict(density_preactivation="identity", density_postactivation="softplus")
PROMPT = "a dog wearing a hat"


# ---------------------------------------------------------------------------
# the checks: one function each, run with a mesh on the ranks and without
# one here; inputs from numpy seeds, so every process builds the same
# ---------------------------------------------------------------------------


def _grid(res=12, seed=None, attn=False, density=0.0):
    """test_parallel.py's grid (zeros, or uniform(-1, 1) from `seed`)."""
    if seed is None:
        dens = np.full((res, res, res, 1), density, np.float32)
        feats = np.zeros((res, res, res, 3), np.float32)
    else:
        rng = np.random.default_rng(seed)
        dens = rng.uniform(-1.0, 1.0, (res, res, res, 1)).astype(np.float32)
        feats = rng.uniform(-1.0, 1.0, (res, res, res, 3)).astype(np.float32)
    return VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats),
                     VoxelGridConfig(voxel_size=VoxelSize(*[3.0 / res] * 3), **GRID_KW),
                     attn=torch.zeros((res, res, res, 1)) if attn else None)


def _rcfg(**kw):
    return SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=CameraBounds(2.0, 6.0), white_bkgd=True, **kw)


def _poses_eye(n):
    poses = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    poses[:, 2, 3] = 4.0
    return torch.from_numpy(poses)


def _state(grid, metrics):
    return dict(densities=grid.densities.detach().clone(), features=grid.features.detach().clone(),
                grad_densities=grid.densities.grad.clone(), grad_features=grid.features.grad.clone(),
                loss=float(metrics["total_loss"]))


def check_exact_step(mesh, draws):
    """One exact recon step (test_parallel.py:52): with `draws` (JAX's flat
    index and jitter) injected, and with the step's own draws from a seeded
    generator; the collectives one step issues."""
    out = {}
    for name in ("replayed", "drawn"):
        grid = _grid()
        opt = trecon.make_adam(grid, LR)
        step = trecon.make_recon_train_step(INTR, _rcfg(), opt, RAY_BATCH, mesh=mesh)
        args = (grid, torch.zeros((4, 16, 16, 3)), _poses_eye(4), torch.arange(4))
        before = dict(mesh.calls) if mesh is not None else {}
        if name == "replayed":
            m = step(*args, flat_idx=torch.from_numpy(draws["flat_idx"]), t_rand=torch.from_numpy(draws["t_rand"]))
        else:
            m = step(*args, torch.Generator().manual_seed(3))
        out[name] = _state(grid, m)
        if mesh is not None:
            out[name]["calls"] = {k: v - before.get(k, 0) for k, v in mesh.calls.items() if v != before.get(k, 0)}
    return out


K_POSES = ((20.0, 30.0), (140.0, 30.0), (260.0, 30.0))


def _kstep_inputs():
    grid = _grid(seed=0)
    poses = torch.from_numpy(np.stack([np.concatenate(pose_spherical(y, p, 4.0), 1) for y, p in K_POSES]).astype(
        np.float32))
    targets, masks = trecon.warp_dataset_to_base(torch.zeros((3, 16, 16, 3)), poses, INTR, grid, (16, 16))
    return grid, poses, targets, masks


def check_kstep(mesh):
    """K = 3 shear-warp steps a call (test_parallel.py:295)."""
    grid, poses, targets, masks = _kstep_inputs()
    opt = trecon.make_adam(grid, LR)
    multi = trecon.make_recon_train_multi_step_shearwarp(_rcfg(perturb_sampled_points=False), opt, (16, 16), 3,
                                                         mesh=mesh)
    m = multi(grid, targets, masks, poses, np.array([0, 2, 1]))
    return _state(grid, m)


def _tiny_sd():
    from voxe_tpu_torch.models.sd.sds import StableDiffusion

    return StableDiffusion("tiny", unet_dtype=torch.float32, device="cpu", seed=0)


def check_sds_step(mesh, sd=None):
    """One SDS edit step on the exact renderer with the tiny SD
    (test_parallel.py:107): density correlation 200, TV 0.1, t = 400."""
    sd = sd or _tiny_sd()
    grid = _grid(attn=True)
    opt = tsds.make_adam(grid, LR)
    step = tsds.make_sds_train_step(sd, _rcfg(perturb_sampled_points=False), opt, (16, 16),
                                    density_correlation_weight=200.0, tv_density_weight=0.1, mesh=mesh)
    rays = flatten_rays(cast_rays(INTR, torch.eye(3), torch.tensor([[0.0], [0.0], [4.0]])))
    ref_d, ref_f = grid.densities.detach().clone(), grid.features.detach().clone()
    m = step(grid, sd.get_text_embeds("a yarn doll", ""), rays, torch.zeros((256, 3)), ref_d, ref_f, 400,
             generator=torch.Generator().manual_seed(42))
    return {**_state(grid, m), "density_correlation_loss": float(m["density_correlation_loss"])}


def check_refine_step(mesh):
    """The refinement's dual attention step on the exact renderer
    (test_parallel.py:145): densities 5, attention 0.1, a ramp target; as
    there without jitter, and with the jitter drawn from a seeded generator
    (every rank draws the whole batch's)."""
    out = {}
    for name, cfg, gen in (("fixed", _rcfg(perturb_sampled_points=False), None),
                           ("drawn", _rcfg(), torch.Generator().manual_seed(4))):
        base = _grid(attn=True, density=5.0)
        edit_attn, obj_attn = torch.full((12, 12, 12, 1), 0.1), torch.full((12, 12, 12, 1), 0.1)
        opt_e, opt_o = trefine.make_attn_adam(edit_attn, LR), trefine.make_attn_adam(obj_attn, LR)
        step = trefine.make_attn_train_step(cfg, opt_e, opt_o, base, 0.001, mesh=mesh)
        rays = flatten_rays(cast_rays(INTR, torch.eye(3), torch.tensor([[0.0], [0.0], [4.0]])))
        target = torch.linspace(0.0, 1.0, 256).reshape(16, 16)
        m = step(edit_attn, obj_attn, rays, target, 1.0 - target, generator=gen)
        out[name] = dict(edit=edit_attn.detach().clone(), object=obj_attn.detach().clone(),
                         **{k: float(v) for k, v in m.items()})
    return out


def check_noisy_exact_render(mesh):
    """The exact colour render of flat rays with jitter and density noise,
    sharded by `render_rays_sharded`: every rank draws the whole batch's
    jitter and noise and renders its rows. (Both packages' exact renders
    turn a ray whose last, infinitely deep sample gets a negative noisy
    density into NaN; the NaNs fall on the same rays.)"""
    from voxe_tpu_torch.render.interface import render_sh_voxel_grid

    rays = flatten_rays(cast_rays(INTR, torch.eye(3), torch.tensor([[0.0], [0.0], [4.0]])))
    return tsds.render_rays_sharded(render_sh_voxel_grid, _grid(seed=1), rays, _rcfg(stochastic_density_noise_std=0.5),
                                    torch.Generator().manual_seed(6), mesh).detach()


def _recon_trainer(scene, out, num_devices):
    """test_parallel.py:200's trainer run: 1 stage of 4 exact steps."""
    ds = PosedImagesDataset(scene / "images", scene / "train_camera_params.json", rgba_white_bkgd=True, device="cpu")
    rcfg = SHVoxGridRenderConfig(num_samples_per_ray=8, camera_bounds=ds.camera_bounds, white_bkgd=True,
                                 render_num_samples_per_ray=8, parallel_rays_chunk_size=256)
    vol = trecon.train_sh_vox_grid_vol_mod_with_posed_images(
        tvol.VolumetricModel(_grid(8, attn=True), rcfg), ds, out, ray_batch_size=256, num_stages=1,
        num_iterations_per_stage=4, save_freq=100, test_freq=100, feedback_freq=100, summary_freq=2,
        fast_debug_mode=True, num_devices=num_devices,
    )
    return vol.grid.densities.detach().clone()


def check_helpers(mesh):
    """shard_rays / shard_axis / replicate / gather_axis on 256 rays, and
    gather_axis' gradient through a sharded function and all_reduce_grads."""
    x = torch.arange(256 * 3, dtype=torch.float32).reshape(256, 3)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((256, 3)).astype(np.float32))
    out = dict(rays=tmesh.shard_rays(mesh, x).clone(), cols=tmesh.shard_axis(mesh, x, 1).clone())
    t = torch.full((5,), float(mesh.rank + 1))
    tmesh.replicate(mesh, [t])
    out["replicated"] = t
    out["gathered"] = tmesh.gather_axis(mesh, tmesh.shard_rays(mesh, x), 0, 256)
    out["gathered_cols"] = tmesh.gather_axis(mesh, tmesh.shard_axis(mesh, x, 1), 1)  # lengths exchanged
    xf = (x / 100.0).requires_grad_(True)
    g = tmesh.gather_axis(mesh, torch.sin(tmesh.shard_rays(mesh, xf)), 0, 256)
    ((g * w).sum() + (g**2).sum()).backward()
    out["local_grad"] = xf.grad.clone()
    tmesh.all_reduce_grads(mesh, [xf])
    out["grad"] = xf.grad.clone()
    return out


def _helpers_reference():
    x = (torch.arange(256 * 3, dtype=torch.float32).reshape(256, 3) / 100.0).requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((256, 3)).astype(np.float32))
    g = torch.sin(x)
    ((g * w).sum() + (g**2).sum()).backward()
    return x.grad


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, port: int, work: str) -> None:
    """One rank: join the group from the JAX_* variables (the launch of
    test_parallel.py:233), then run the world's checks; results to disk."""
    os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world),
                      JAX_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    work = Path(work)
    assert tdist.maybe_init_distributed(True, device="cpu", timeout_s=60.0)
    assert tdist.maybe_init_distributed(True, device="cpu")  # a second call is a no-op
    mesh = tmesh.make_mesh(world)
    total = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(total)
    res = dict(rank=rank, primary=tdist.is_primary_host(), writer=tdist.is_local_writer(), sum=float(total),
               helpers=check_helpers(mesh))
    if world == 2:
        draws = np.load(work / "draws.npz")
        res.update(exact=check_exact_step(mesh, draws), kstep=check_kstep(mesh), refine=check_refine_step(mesh),
                   noisy_render=check_noisy_exact_render(mesh),
                   sds=check_sds_step(mesh),
                   trainer=_recon_trainer(work / "scene16", work / f"trainer_rank{rank}", 2))
    torch.save(res, work / f"world{world}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


class _Runs:
    """The module's background processes: the two groups and the CLIs'
    two-device runs, each joined (with a deadline) when first read."""

    def __init__(self, work: Path):
        self.work, self.procs, self.done = work, {}, {}

    def start_group(self, world: int) -> None:
        ctx = multiprocessing.get_context("spawn")
        port = tdist.free_port()
        self.procs[f"world{world}"] = [ctx.Process(target=_rank_main, args=(r, world, port, str(self.work)))
                                       for r in range(world)]
        for p in self.procs[f"world{world}"]:
            p.start()

    def start_cli(self, name: str, module: str, args) -> None:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        log = open(self.work / f"{name}.log", "w")
        self.procs[name] = [subprocess.Popen([sys.executable, "-m", module, *args], env=env, stdout=log,
                                             stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent.parent)]
        log.close()

    def join(self, name: str) -> None:
        if name in self.done:
            return
        end = time.monotonic() + DEADLINE_S
        codes = []
        for p in self.procs[name]:
            if isinstance(p, subprocess.Popen):
                try:
                    codes.append(p.wait(timeout=max(1.0, end - time.monotonic())))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    codes.append("killed")
            else:
                p.join(max(1.0, end - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
                    codes.append("killed")
                else:
                    codes.append(p.exitcode)
        self.done[name] = codes
        log = self.work / f"{name}.log"
        assert codes == [0] * len(codes), f"{name}: exit codes {codes}\n" + (
            log.read_text()[-3000:] if log.exists() else "")

    def group(self, world: int) -> list:
        self.join(f"world{world}")
        return [torch.load(self.work / f"world{world}_rank{r}.pt", weights_only=False) for r in range(world)]

    def close(self) -> None:
        for name in self.procs:
            try:
                self.join(name)
            except AssertionError:
                pass


def _jax_references() -> dict:
    """JAX's exact recon step (its gradients kept by a pass-through optax
    stage) and its shear-warp K-step on make_mesh(2), from the inputs the
    ranks use."""
    import jax
    import jax.numpy as jnp
    import optax

    from voxe_tpu.grid import voxels as jvox
    from voxe_tpu.parallel.mesh import make_mesh
    from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
    from voxe_tpu.train import recon as jrecon
    from voxe_tpu.utils import camera as jcam

    def jgrid(dens, feats):
        return jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats),
                              jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*[3.0 / 12] * 3), **GRID_KW))

    mesh, intr = make_mesh(2), jcam.CameraIntrinsics(16, 16, 16.0)
    capture = optax.GradientTransformation(  # hands back the step's gradients as its state
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda updates, state, params=None: (updates, updates))
    jopt = optax.chain(capture, optax.adam(LR))
    jg = jgrid(np.zeros((12, 12, 12, 1), np.float32), np.zeros((12, 12, 12, 3), np.float32))
    jstep = jrecon.make_recon_train_step(
        intr, JRenderConfig(num_samples_per_ray=16, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True),
        jopt, RAY_BATCH, mesh=mesh)
    e_new, e_state, e_m = jstep(jg, jopt.init(jg), jnp.zeros((4, 16, 16, 3)), jnp.asarray(_poses_eye(4).numpy()),
                                jnp.arange(4), jax.random.PRNGKey(7))
    grid, poses, _, _ = _kstep_inputs()
    jg = jgrid(grid.densities.numpy(), grid.features.numpy())
    jposes = jnp.asarray(poses.numpy())
    targets, masks = jrecon.warp_dataset_to_base(jnp.zeros((3, 16, 16, 3)), jposes, intr, jg, (16, 16))
    kopt = optax.adam(LR)
    jmulti = jrecon.make_recon_train_multi_step_shearwarp(
        JRenderConfig(num_samples_per_ray=16, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                      perturb_sampled_points=False), kopt, (16, 16), 3, mesh=mesh)
    k_new, _, k_m = jmulti(jg, kopt.init(jg), targets, masks, jposes, jnp.asarray([0, 2, 1], jnp.int32),
                           jax.random.PRNGKey(11))
    out = dict(exact_densities=e_new.densities, exact_features=e_new.features,
               exact_grad_densities=e_state[0].densities, exact_grad_features=e_state[0].features,
               exact_loss=e_m["total_loss"], kstep_densities=k_new.densities, kstep_features=k_new.features,
               kstep_loss=k_m["total_loss"])
    return {k: np.asarray(v) for k, v in out.items()}


def _input_model(scene: Path, path: Path) -> None:
    """A seeded 12^3 model (softplus field, f32 table) for the edit and
    refine CLIs: with the bf16 table each rank's share of the table's
    gradient is rounded to bf16 before the all-reduce (ROADMAP.md
    section 3)."""
    from voxe_tpu_torch.utils.misc import compute_expected_density_scale_for_relu_field_grid

    ds = PosedImagesDataset(scene / "train", scene / "train_camera_params.json", rgba_white_bkgd=True, device="cpu")
    rng = np.random.default_rng(13)
    grid = VoxelGrid(
        torch.from_numpy(rng.uniform(-1.0, 1.0, (12, 12, 12, 1)).astype(np.float32)),
        torch.from_numpy(rng.uniform(-1.0, 1.0, (12, 12, 12, 3)).astype(np.float32)),
        VoxelGridConfig(voxel_size=VoxelSize(*[3.0 / 12] * 3), gather_dtype="float32",
                        expected_density_scale=compute_expected_density_scale_for_relu_field_grid((3.0, 3.0, 3.0)),
                        **GRID_KW))
    rcfg = SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=ds.camera_bounds, white_bkgd=True,
                                 render_num_samples_per_ray=16)
    tvol.VolumetricModel(grid, rcfg).save(path)


def _cli_args(scene, model):
    common = ["-d", str(scene), "--data_downsample_factor", "1", "--feedback_frequency", "2", "--save_frequency",
              "2", "--device", "cpu"]
    recon = common + ["--gather_dtype", "float32", "--grid_dims", "12", "12", "12", "--num_stages", "1",
                      "--num_iterations_per_stage", "3", "--train_num_samples_per_ray", "16",
                      "--render_num_samples_per_ray", "16", "--test_frequency", "2"]
    edit = common + ["-i", str(model), "-p", PROMPT, "--sd_version", "tiny", "--num_iterations_edit", "3",
                     "--train_num_samples_per_ray", "16", "--render_num_samples_per_ray", "16"]
    refine = common + ["-i", str(model), "-r", str(model), "-p", PROMPT, "-eidx", "4 5", "--sd_version", "tiny",
                       "--num_iterations_per_stage", "3", "--min_num_edit_voxels", "10"]
    return dict(recon=recon, edit=edit, refine=refine)


CLI_MODULES = dict(recon=trecon_cli, edit=tedit_cli, refine=trefine_cli)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both groups and the three CLIs' two-device runs, then take
    JAX's reference steps and run the CLIs on one device here."""
    import jax

    work = tmp_path_factory.mktemp("parallel")
    k_idx, k_render = jax.random.split(jax.random.PRNGKey(7))  # voxe_tpu/train/recon.py:130
    np.savez(work / "draws.npz", flat_idx=np.array(jax.random.randint(k_idx, (RAY_BATCH,), 0, 4 * 16 * 16)),
             t_rand=np.array(jax.random.uniform(k_render, (RAY_BATCH, 16))))
    generate_synthetic_scene(work / "scene16", num_train=4, num_test=1, image_size=16, focal=16.0, grid_res=16,
                             device="cpu")
    r = _Runs(work)
    r.start_group(2)
    r.start_group(3)
    scene = work / "scene32"
    generate_synthetic_scene(scene, num_train=4, num_test=2, image_size=32, focal=32.0, grid_res=24, device="cpu")
    for split in ("train", "test"):
        (scene / split).mkdir()
        for p in (scene / "images").glob(f"{split}_*.png"):
            p.rename(scene / split / p.name)
    _input_model(scene, work / "model.pth")
    args = _cli_args(scene, work / "model.pth")
    for name in ("recon", "edit", "refine"):
        r.start_cli(name, CLI_MODULES[name].__name__, args[name] + ["-o", str(work / f"{name}2"), "--num_devices", "2"])
    try:
        r.jax_refs = _jax_references()
        for name in ("recon", "edit", "refine"):  # the one-device references, here meanwhile
            CLI_MODULES[name].main(args[name] + ["-o", str(work / f"{name}1")])
        yield r
    finally:
        r.close()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _same_on_every_rank(results, key):
    for res in results[1:]:
        for name, value in results[0][key].items():
            if isinstance(value, torch.Tensor) and not name.startswith("grad"):
                assert torch.equal(res[key][name], value), (key, name)


def test_multihost_init_two_processes(runs):
    """Two processes join one group through maybe_init_distributed from the
    JAX_* variables (test_parallel.py:233): they sum across it, rank 0 is
    the primary host and the only writer."""
    ranks = runs.group(2)
    assert [r["sum"] for r in ranks] == [3.0, 3.0]
    assert [r["primary"] for r in ranks] == [True, False]
    assert [r["writer"] for r in ranks] == [True, False]
    assert not tdist.maybe_init_distributed(False) and tdist.is_primary_host()


@pytest.mark.parametrize("world", [2, 3])
def test_shard_replicate_and_gather(runs, world):
    """shard_rays / shard_axis follow tensor_split (256 rays at world 3:
    86, 85, 85), replicate broadcasts rank 0's tensor, gather_axis
    reassembles the shards, and its backward hands each rank its slice of
    the gradient unreduced: after all_reduce_grads the sharded gradient is
    the unsharded one (test_parallel.py:74)."""
    ranks = runs.group(world)
    x = torch.arange(256 * 3, dtype=torch.float32).reshape(256, 3)
    ref_grad = _helpers_reference()
    for r in ranks:
        h = r["helpers"]
        assert torch.equal(h["rays"], torch.tensor_split(x, world)[r["rank"]])
        assert torch.equal(h["cols"], torch.tensor_split(x, world, dim=1)[r["rank"]])
        assert torch.equal(h["replicated"], torch.ones(5))
        assert torch.equal(h["gathered"], x) and torch.equal(h["gathered_cols"], x)
        lo, hi = tmesh.shard_bounds(tmesh.Mesh(None, r["rank"], world, torch.device("cpu")), 256)
        local = torch.zeros_like(ref_grad)
        local[lo:hi] = ref_grad[lo:hi]
        _close(h["local_grad"], local)
        _close(h["grad"], ref_grad)
    if world == 3:
        assert [r["helpers"]["rays"].shape[0] for r in ranks] == [86, 85, 85]


def _check_against_unsharded(sharded, ref, keys=("densities", "features")):
    for k in keys:
        _close(sharded[k], ref[k])
    assert sharded["loss"] == pytest.approx(ref["loss"], rel=1e-4)


def test_sharded_exact_step_matches_unsharded_and_jax(runs):
    """The exact recon step at world size 2 against the unsharded step, with
    JAX's draws replayed and with its own draws, one gradient all-reduce a
    step (test_parallel.py:43, :52); and against JAX's
    make_recon_train_step on make_mesh(2) from the same grid and draws."""
    ref = check_exact_step(None, np.load(runs.work / "draws.npz"))
    ranks = runs.group(2)
    jax_ref = runs.jax_refs
    _same_on_every_rank([r["exact"] for r in ranks], "replayed")
    sharded = ranks[0]["exact"]
    for name in ("replayed", "drawn"):
        _check_against_unsharded(sharded[name], ref[name])
        assert sharded[name]["calls"] == {"all_reduce_grads": 1}
    got = sharded["replayed"]
    assert got["loss"] == pytest.approx(float(jax_ref["exact_loss"]), rel=1e-4)
    for name in ("densities", "features"):
        jgrad = jax_ref[f"exact_grad_{name}"]
        scale = np.abs(jgrad).max()
        assert scale > 0 and np.abs(got[f"grad_{name}"].numpy() - jgrad).max() <= 1e-4 * scale
        _close(got[name], jax_ref[f"exact_{name}"])


def test_sharded_shearwarp_kstep_matches_unsharded_and_jax(runs):
    """K = 3 shear-warp steps a call at world size 2, each rank on its base
    rows, against the unsharded call (test_parallel.py:295) and against
    JAX's make_recon_train_multi_step_shearwarp on make_mesh(2)."""
    ref = check_kstep(None)
    ranks = runs.group(2)
    jax_ref = runs.jax_refs
    for r in ranks:
        assert torch.equal(r["kstep"]["densities"], ranks[0]["kstep"]["densities"])
    sharded = ranks[0]["kstep"]
    _check_against_unsharded(sharded, ref)
    assert sharded["loss"] == pytest.approx(float(jax_ref["kstep_loss"]), rel=1e-4)
    for name in ("densities", "features"):
        _close(sharded[name], jax_ref[f"kstep_{name}"])


def test_sharded_sds_step_matches_unsharded(runs):
    """The SDS edit step with the tiny SD at world size 2: every rank's
    frame rows gathered, SD replicated, the grid terms on rank 0
    (test_parallel.py:107). The unsharded torch step is held against JAX in
    test_torch_edit.py."""
    ref = check_sds_step(None)
    ranks = runs.group(2)
    for r in ranks:
        assert torch.equal(r["sds"]["densities"], ranks[0]["sds"]["densities"])
    _check_against_unsharded(ranks[0]["sds"], ref)
    assert ranks[1]["sds"]["density_correlation_loss"] == pytest.approx(ref["density_correlation_loss"], abs=1e-6)


def test_sharded_refine_attn_step_matches_unsharded(runs):
    """The refinement's dual attention step at world size 2
    (test_parallel.py:145), without jitter and with jitter and density
    noise: both grids, the masked loss fired."""
    refs = check_refine_step(None)
    ranks = runs.group(2)
    for name, ref in refs.items():
        for r in ranks:
            got = r["refine"][name]
            for k in ("edit", "object"):
                _close(got[k], ref[k])
            for k in ("attn_loss_edit", "total_loss_edit", "attn_loss_object", "tv_loss_object"):
                assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7)
        assert ref["attn_loss_edit"] > 0.0 and ranks[0]["refine"][name]["attn_loss_edit"] > 0.0


def test_sharded_exact_render_draws_the_whole_batch(runs):
    """The sharded exact render with jitter and density noise gives the
    unsharded colours: each rank's rays take their rows of the whole
    batch's draws."""
    ref = check_noisy_exact_render(None)
    assert torch.isfinite(ref).any()
    for r in runs.group(2):
        np.testing.assert_allclose(r["noisy_render"].numpy(), ref.numpy(), rtol=RTOL, atol=ATOL, equal_nan=True)


def test_recon_trainer_honors_num_devices(runs, tmp_path):
    """The recon trainer with num_devices=2 (test_parallel.py:200): finite,
    the grid of num_devices=1 within tolerance, and one set of files: rank
    0's output directory holds the single-device run's, rank 1's nothing."""
    ref = _recon_trainer(runs.work / "scene16", tmp_path / "single", 1)
    ranks = runs.group(2)
    assert torch.isfinite(ranks[0]["trainer"]).all()
    for r in ranks:
        _close(r["trainer"], ref)
    assert _files(runs.work / "trainer_rank0") == _files(tmp_path / "single")
    assert not (runs.work / "trainer_rank1").exists()


def _files(root: Path):
    """The files under `root`, a tensorboard event file's time stamp cut."""
    return sorted(re.sub(r"tfevents\..*", "tfevents", p.relative_to(root).as_posix())
                  for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("cli", ["recon", "edit", "refine"])
def test_cli_num_devices_2(runs, cli):
    """The CLI with `--device cpu --num_devices 2` spawns its two ranks and
    writes the file set of its one-device run, once; the final grids agree."""
    runs.join(cli)
    one, two = runs.work / f"{cli}1", runs.work / f"{cli}2"
    assert _files(two) == _files(one) and len(_files(one)) > 3
    final = {"recon": "model_final.pth", "edit": "model_final.pth", "refine": "model_final_attn_edit.pth"}[cli]
    a, _ = tvol.load_volumetric_model(one / "saved_models" / final, device="cpu", with_attn=cli == "refine")
    b, _ = tvol.load_volumetric_model(two / "saved_models" / final, device="cpu", with_attn=cli == "refine")
    for name in ("densities", "features") + (("attn",) if cli == "refine" else ()):
        _close(getattr(b.grid, name), getattr(a.grid, name))
    log = (runs.work / f"{cli}.log").read_text()
    assert "torch.distributed initialized: process 0/2 (gloo)" in log
    assert "process 1/2" not in log  # the second rank logs nothing


def test_count_mismatch_and_missing_group_fail_at_once(tmp_path):
    """`--num_devices 2 --multihost True` without a launched group names the
    variables it needs; a group of another size is refused."""
    args = ["-d", str(tmp_path), "-o", str(tmp_path / "o"), "--device", "cpu", "--num_devices", "2",
            "--multihost", "True"]
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        trecon_cli.main(args)
    assert not (tmp_path / "o").exists()
