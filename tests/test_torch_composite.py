"""Parity of the port's compositing (ops/composite.py, render/accumulate.py
and the fused exact render) against voxe_tpu on the CPU, where the port's
wrapper runs the kernel's plain version. The JAX kernel runs in Pallas
interpret mode (its own tests' switch). The kernel itself runs only on a
card: the `cuda`-marked tests hold it against the plain version there.
The card's machine has no JAX, so the JAX imports are optional and only the
`cuda` tests run without them:
    python3 -m pytest --noconftest tests/test_torch_composite.py -m cuda"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import voxe_tpu.ops.composite as jcomp
    from voxe_tpu.grid import voxels as jvox
    from voxe_tpu.render import accumulate as jacc
    from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
    from voxe_tpu.render.interface import render_sh_voxel_grid as j_render
    from voxe_tpu.render.rays import Rays as JRays
    from voxe_tpu.utils.camera import CameraBounds as JBounds
except ImportError:  # the card's machine: only the `cuda` tests below run there
    jax = None
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.ops import composite as tcomp
from voxe_tpu_torch.render import accumulate as tacc
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.render.interface import render_sh_voxel_grid as t_render
from voxe_tpu_torch.render.rays import Rays as TRays
from voxe_tpu_torch.utils.camera import CameraBounds as TBounds

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def jax_kernel_interpreted():
    jcomp._FORCE_INTERPRET = True
    yield
    jcomp._FORCE_INTERPRET = False


def _inputs(n, s, seed=0, hi=5.0):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0, hi, (n, s)).astype(np.float32)
    depths = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    dirn = rng.uniform(0.9, 1.4, (n,)).astype(np.float32)
    return density, depths, dirn


def _sequential_f64(density, depths, dirn):
    """An independent per-ray loop in float64."""
    n, s = density.shape
    w = np.zeros((n, s))
    for r in range(n):
        t = 1.0
        for i in range(s):
            delta = (depths[r, i + 1] - depths[r, i] if i + 1 < s else 1e10) * float(dirn[r])
            alpha = 1.0 - np.exp(-float(density[r, i]) * delta)
            w[r, i] = alpha * t
            t *= 1.0 - alpha
    return w, w.sum(-1)


@pytest.mark.parametrize("n", [64, 37])
def test_port_matches_jax_kernel(jax_kernel_interpreted, n):
    """[64, 128] and the ragged [37, 128] (rows not a multiple of the TPU tile)."""
    args = _inputs(n, 128)
    jw, jacc_ = jcomp.composite_weights(*map(jnp.asarray, args))
    tw, tacc_ = tcomp.composite_weights(*map(torch.from_numpy, args))
    # the JAX test's own tolerance for kernel vs reference (f32 products in
    # another order)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tacc_.numpy(), np.asarray(jacc_), rtol=1e-5, atol=1e-6)


def test_plain_version_at_s160_against_reference_and_f64_loop():
    """S = 160 (the recon slice count; no lane alignment on the port's side)."""
    args = _inputs(24, 160, seed=1, hi=20.0)
    tw, ta = tcomp.composite_weights(*map(torch.from_numpy, args))
    jw, ja = jcomp.composite_weights_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    w64, a64 = _sequential_f64(*args)
    # f32 against f64: a product of up to 160 factors, ~S * 2^-24 relative
    np.testing.assert_allclose(tw.numpy(), w64, rtol=0, atol=2e-5)
    np.testing.assert_allclose(ta.numpy(), a64, rtol=0, atol=2e-5)


def test_autograd_matches_jax_grad_in_all_inputs():
    density, depths, dirn = _inputs(16, 40, seed=2)
    c = np.random.default_rng(3).standard_normal((16,)).astype(np.float32)

    def jloss(d, z, n):
        w, acc = jcomp.composite_weights(d, z, n)
        return jnp.sum(w * w) + jnp.sum(acc * jnp.asarray(c))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (density, depths, dirn)))
    ts = [torch.tensor(x, requires_grad=True) for x in (density, depths, dirn)]
    w, acc = tcomp.composite_weights(*ts)
    ((w * w).sum() + (acc * torch.from_numpy(c)).sum()).backward()
    for t, j in zip(ts, jg):
        # the same reference formula differentiated by two frameworks
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)


def test_cpu_wrapper_counts_no_launch():
    before = tcomp.LAUNCHES
    tcomp.composite_weights(*map(torch.from_numpy, _inputs(4, 9)))
    assert tcomp.LAUNCHES == before


@pytest.mark.parametrize("final_delta", ["inf", "slab"])
def test_accumulate_padding_both_modes(jax_kernel_interpreted, final_delta):
    """The fused branch pads S = 160 to 256 ("slab": continued slab spacing;
    "inf": INFINITY steps) and must give the plain branch's colour, depth and
    acc; both against JAX's fused branch (its kernel interpreted)."""
    rng = np.random.default_rng(4)
    n, s = 12, 160
    radiance = rng.standard_normal((n, s, 3)).astype(np.float32)
    density, depths, _ = _inputs(n, s, seed=5, hi=8.0)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    proc = np.concatenate([radiance, density[..., None]], -1)
    t_rays = TRays(torch.zeros(n, 3), torch.from_numpy(dirs))
    j_rays = JRays(jnp.zeros((n, 3)), jnp.asarray(dirs))
    kw = dict(white_bkgd=True, final_delta=final_delta)
    plain = tacc.accumulate_radiance_density_on_rays(torch.from_numpy(proc), torch.from_numpy(depths), t_rays, **kw)
    fused = tacc.accumulate_radiance_density_on_rays(
        torch.from_numpy(proc), torch.from_numpy(depths), t_rays, use_fused_kernel=True, **kw
    )
    jfused = jacc.accumulate_radiance_density_on_rays(
        jnp.asarray(proc), jnp.asarray(depths), j_rays, use_fused_kernel=True, **kw
    )
    for name in ("colour", "depth"):
        # cumsum/exp identity vs product scan: f32 rounding of 160-term sums
        np.testing.assert_allclose(getattr(fused, name).numpy(), getattr(plain, name).numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(getattr(fused, name).numpy(), np.asarray(getattr(jfused, name)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fused.extra["accumulated_weight"].numpy(), np.asarray(jfused.extra["accumulated_weight"]), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("debug", [False, True])
def test_accumulate_plain_branches_match_jax(debug):
    """The cumsum/exp branch and the extra_debug_info (cumprod) branch."""
    rng = np.random.default_rng(6)
    n, s = 10, 33
    proc = np.concatenate(
        [rng.standard_normal((n, s, 3)), rng.uniform(0, 6, (n, s, 1))], -1
    ).astype(np.float32)
    depths = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    t = tacc.accumulate_radiance_density_on_rays(
        torch.from_numpy(proc), torch.from_numpy(depths), TRays(torch.zeros(n, 3), torch.from_numpy(dirs)),
        extra_debug_info=debug,
    )
    j = jacc.accumulate_radiance_density_on_rays(
        jnp.asarray(proc), jnp.asarray(depths), JRays(jnp.zeros((n, 3)), jnp.asarray(dirs)), extra_debug_info=debug
    )
    assert set(t.extra) == set(j.extra)
    for k in t.extra:
        np.testing.assert_allclose(t.extra[k].numpy(), np.asarray(j.extra[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.colour.numpy(), np.asarray(j.colour), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth), rtol=1e-5, atol=1e-5)


def test_fused_exact_render_matches_jax(jax_kernel_interpreted):
    """render_sh_voxel_grid(use_fused_kernel=True): 128 samples per ray, so
    the JAX side runs its Pallas kernel (interpreted)."""
    rng = np.random.default_rng(7)
    res = 12
    dens = rng.uniform(-1.0, 3.0, (res, res, res, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (res, res, res, 12)).astype(np.float32)
    kw = dict(density_preactivation="identity", density_postactivation="softplus", expected_density_scale=2.0)
    jg = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats), jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*[2.0 / res] * 3), **kw))
    tg = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats), tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*[2.0 / res] * 3), **kw))
    origins = np.tile(np.array([[0.3, -3.5, 0.4]], np.float32), (48, 1))
    dirs = (rng.standard_normal((48, 3)) * 0.15 + np.array([0.0, 1.0, 0.0])).astype(np.float32)
    common = dict(num_samples_per_ray=128, white_bkgd=True, optimized_sampling=True, use_fused_kernel=True)
    jout = j_render(jg, JRays(jnp.asarray(origins), jnp.asarray(dirs)), JRenderConfig(camera_bounds=JBounds(1.0, 6.0), **common))
    tout = t_render(tg, TRays(torch.from_numpy(origins), torch.from_numpy(dirs)), TRenderConfig(camera_bounds=TBounds(1.0, 6.0), **common))
    assert float(tout.extra["accumulated_weight"].max()) > 0.5  # the rays see the grid
    # gather, SH and compositing in f32 on both sides: float rounding
    np.testing.assert_allclose(tout.colour.numpy(), np.asarray(jout.colour), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tout.extra["accumulated_weight"].numpy(), np.asarray(jout.extra["accumulated_weight"]), rtol=1e-4, atol=1e-5
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,hi", [(4096, 256, 5.0), (2048, 1024, 5.0), (1000, 37, 5.0), (777, 160, 50.0), (3, 1, 5.0)])
def test_composite_kernel_matches_plain_on_card(cuda_device, n, s, hi):
    args = [torch.from_numpy(x).to(cuda_device) for x in _inputs(n, s, hi=hi)]
    before = tcomp.LAUNCHES
    w, acc = tcomp.composite_weights(*args)
    torch.cuda.synchronize()
    assert tcomp.LAUNCHES == before + 1
    wr, ar = tcomp.composite_weights_reference(*args)
    # both in [0, 1]; f32 products in another order: well under S * 2^-24
    assert float((w - wr).abs().max()) <= 1e-5
    assert float((acc - ar).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_composite_kernel_rejects_what_it_cannot_take(cuda_device):
    d, z, n = [torch.from_numpy(x).to(cuda_device) for x in _inputs(8, 16)]
    with pytest.raises(ValueError):
        tcomp.composite_weights(d.double(), z.double(), n.double())
    with pytest.raises(ValueError):
        tcomp.composite_weights(d.t().contiguous().t(), z, n)  # not row-major
    with pytest.raises(ValueError):
        tcomp.composite_weights(d, z.cpu(), n)
