"""Parity of the port's compositing (ops/composite.py, render/accumulate.py
and the fused exact render) against voxe_tpu on the CPU, where the port's
wrapper runs the kernel's plain version. The JAX kernel runs in Pallas
interpret mode (its own tests' switch). The shear-warp tail's
`composite_render` is held on the CPU against the plain tail it replaced,
and the benchmark's reader of its backward kernel on made-up traces. The
kernels themselves run only on a card: the `cuda`-marked tests hold them
against the plain version there.
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
from portbench.lib.manifest import reader
from portbench.lib.trace import Trace
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.ops import composite as tcomp
from voxe_tpu_torch.render import accumulate as tacc
from voxe_tpu_torch.render import shearwarp as tsw
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.render.interface import render_sh_voxel_grid as t_render
from voxe_tpu_torch.render.rays import Rays as TRays
from voxe_tpu_torch.utils import tracing
from voxe_tpu_torch.utils.camera import CameraBounds as TBounds
from voxe_tpu_torch.utils.camera import CameraPose as TPose
from voxe_tpu_torch.utils.camera import pose_spherical
from voxe_tpu_torch.utils.constants import INFINITY

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
    """JAX's fused branch pads S = 160 to 256 ("slab": continued slab
    spacing; "inf": INFINITY steps, its kernel interpreted). The port gives
    its colour, depth and acc through the plain branch in both modes, and
    in "slab" through `composite_render`, which pads as JAX does (the
    shear-warp tail's route; the exact renderer's "inf" route composites
    unpadded, `test_fused_exact_render_matches_jax`)."""
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
    jfused = jacc.accumulate_radiance_density_on_rays(
        jnp.asarray(proc), jnp.asarray(depths), j_rays, use_fused_kernel=True, **kw
    )
    # cumsum/exp identity vs product scan: f32 rounding of 160-term sums
    for name in ("colour", "depth"):
        np.testing.assert_allclose(getattr(plain, name).numpy(), np.asarray(getattr(jfused, name)), rtol=1e-4, atol=1e-5)
    if final_delta == "inf":
        return
    colour, depth, acc = tcomp.composite_render(
        torch.from_numpy(density), torch.from_numpy(depths), torch.linalg.norm(torch.from_numpy(dirs), dim=-1),
        torch.from_numpy(radiance), torch.ones((n, s), dtype=torch.bool),
    )
    fused = {"colour": colour + (1.0 - acc), "depth": depth}
    for name in ("colour", "depth"):
        np.testing.assert_allclose(fused[name].numpy(), getattr(plain, name).numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(fused[name].numpy(), np.asarray(getattr(jfused, name)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jfused.extra["accumulated_weight"]), rtol=1e-5, atol=1e-6)


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


def _render_inputs(n, s, c, dtype, seed=0, hi=5.0, empty=0, device="cpu"):
    """composite_render's inputs: a mask with a fifth of the samples
    outside and the first `empty` rays wholly outside, density up to `hi`
    inside and 0 outside, sorted depths in [2, 6), |dir| in [0.9, 1.4),
    radiance ~ N(0, 1) clipped to [-4, 4] in `dtype`."""
    g = torch.Generator(device=device).manual_seed(seed)
    inside = torch.rand((n, s), generator=g, device=device) > 0.2
    inside[:empty] = False
    sigma = torch.where(inside, torch.rand((n, s), generator=g, device=device) * hi, 0.0)
    depths = torch.sort(torch.rand((n, s), generator=g, device=device) * 4.0 + 2.0, dim=-1).values
    dir_norms = torch.rand((n,), generator=g, device=device) * 0.5 + 0.9
    radiance = torch.randn((n, s, c), generator=g, device=device).clamp(-4.0, 4.0).to(dtype)
    return sigma, depths, dir_norms, radiance, inside


def _upstream(n, c, seed=1, device="cpu"):
    """Gradients of colour, depth and acc. The colour's lie on a 1/16 grid
    in [-1, 1]: with a bf16 y in [sigmoid(-4), 1) each g_c y_c is exact in
    f32 and so is their sum over C, in any order, so the plain tail's GEMM
    and the kernel round the same value to bf16 (a sum that rounded
    differently in f32 could land on the other side of a bf16 rounding)."""
    g = torch.Generator(device=device).manual_seed(seed)
    g_colour = torch.round((torch.rand((n, c), generator=g, device=device) * 2.0 - 1.0) * 16.0) / 16.0
    g_depth = torch.randn((n, 1), generator=g, device=device)
    g_acc = torch.randn((n, 1), generator=g, device=device)
    return g_colour, g_depth, g_acc


def _composite_and_grads(fn, inputs, upstream, want_sigma=True):
    """fn's (colour, depth, acc) and the gradients of sum(out * upstream)
    in sigma and radiance (None where not asked for)."""
    sigma, depths, dir_norms, radiance, inside = inputs
    sigma = sigma.clone().requires_grad_(want_sigma)
    radiance = radiance.clone().requires_grad_(True)
    outs = fn(sigma, depths, dir_norms, radiance, inside)
    sum(((o * g).sum() for o, g in zip(outs, upstream)), torch.zeros(())).backward()
    return [o.detach() for o in outs] + [sigma.grad, radiance.grad]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composite_render_cpu_is_the_plain_tail_bit_for_bit(dtype):
    """The CPU path against the tail it replaced, as the monolithic tail ran
    it before: the radiance masked to -INFINITY, the lane padding at the
    slab spacing, the weights, the weights in the radiance dtype against the
    sigmoid, the depth sum."""
    inputs = _render_inputs(40, 37, 3, dtype, empty=3)
    upstream = _upstream(40, 3)

    def old_tail(sigma, depths, dir_norms, radiance, inside):
        raw = torch.where(inside[..., None], radiance, torch.full((), -INFINITY, dtype=radiance.dtype))
        pad = (-37) % 128
        ks = torch.arange(1, pad + 1, dtype=depths.dtype)
        depths_p = torch.cat([depths, depths[..., -1:] + (depths[..., -1:] - depths[..., -2:-1]) * ks], dim=-1)
        sigma_p = torch.cat([sigma, sigma.new_zeros((40, pad))], dim=-1)
        weights_full, acc = tcomp.composite_weights(sigma_p.contiguous(), depths_p.contiguous(), dir_norms)
        weights = weights_full[..., :37]
        colour = torch.sigmoid(raw)
        colour_render = torch.einsum("...s,...sc->...c", weights.to(colour.dtype).float(), colour.float())
        return colour_render, torch.sum(depths * weights, dim=-1, keepdim=True), acc[..., None]

    got = _composite_and_grads(tcomp.composite_render, inputs, upstream)
    want = _composite_and_grads(old_tail, inputs, upstream)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_composite_render_cpu_counts_no_launch():
    inputs, upstream = _render_inputs(8, 20, 2, torch.bfloat16), _upstream(8, 2)
    with tracing.counted() as c:
        _composite_and_grads(tcomp.composite_render, inputs, upstream)
    for name in ("composite.LAUNCHES", "composite.LAUNCHES_SUMS", "composite.LAUNCHES_BWD"):
        assert c[name] == 0
    assert c["composite.LAUNCHED_BWD_SHAPES"] == set()


SW_RES, SW_BASE = 12, (16, 16)
SW_CFG = TRenderConfig(num_samples_per_ray=64, camera_bounds=TBounds(0.5, 10.0), white_bkgd=True,
                       use_fused_kernel=True)


def _sw_grid(sh_degree, gather_dtype="bfloat16"):
    g = torch.Generator().manual_seed(sh_degree)
    dens = torch.rand((SW_RES,) * 3 + (1,), generator=g) * 2.0 - 1.0
    feats = torch.rand((SW_RES,) * 3 + (3 * (sh_degree + 1) ** 2,), generator=g) * 2.0 - 1.0
    cfg = tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*[3.0 / SW_RES] * 3), density_preactivation="identity",
                               density_postactivation="softplus", gather_dtype=gather_dtype, expected_density_scale=3.0)
    return tvox.VoxelGrid(dens.requires_grad_(True), feats.requires_grad_(True), cfg)


def _sw_render(grid, **kw):
    out, _ = tsw.render_shear_warp(grid, TPose(*pose_spherical(30.0, 60.0, 4.0)), SW_CFG, base_hw=SW_BASE, **kw)
    return out


def test_monolithic_tail_composites_once_at_degree_0():
    """The diffuse colour is the colour itself, and the two losses'
    gradients meeting in one backward give what two tails gave: the sum of
    each loss's gradient through a render of its own. An f32 table: a bf16
    one rounds each backward's table gradient to bf16 on its own."""
    grid = _sw_grid(0, "float32")
    n = SW_BASE[0] * SW_BASE[1]
    g = torch.Generator().manual_seed(3)
    w1, w2 = torch.randn((n, 3), generator=g), torch.randn((n, 3), generator=g)
    with tracing.counted() as c:
        out = _sw_render(grid, with_diffuse=True)
    assert out.extra["diffuse_colour"] is out.colour
    ((out.colour * w1).sum() + (out.extra["diffuse_colour"] * w2).sum()).backward()
    got = [grid.densities.grad.clone(), grid.features.grad.clone()]
    grid.densities.grad = grid.features.grad = None
    for w in (w1, w2):
        (_sw_render(grid).colour * w).sum().backward()
    for a, b in zip(got, (grid.densities.grad, grid.features.grad)):
        scale = float(b.abs().max())
        assert scale > 0.0
        # one backward of the summed gradient against two: f32 rounding
        assert float((a - b).abs().max()) <= 1e-5 * scale
    assert c["composite.LAUNCHES"] == 0  # the CPU takes the plain version


def test_monolithic_tail_stacks_the_diffuse_channels_above_degree_0():
    """At degree 1 the colour and the diffuse colour come from one C = 6
    pass: each equals its own C = 3 pass (the colour's render, and the
    render shaded at degree 0), depth and acc included."""
    grid = _sw_grid(1)
    both = _sw_render(grid, with_diffuse=True)
    colour = _sw_render(grid)
    diffuse = _sw_render(grid, diffuse_only=True)
    assert both.colour.shape == both.extra["diffuse_colour"].shape == colour.colour.shape
    # the same per-channel sums over S in a wider product: f32 rounding
    np.testing.assert_allclose(both.colour.detach().numpy(), colour.colour.detach().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(both.extra["diffuse_colour"].detach().numpy(), diffuse.colour.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert not torch.allclose(both.colour, both.extra["diffuse_colour"])  # degree 1 moves the colour
    for other in (colour, diffuse):
        assert torch.equal(both.depth, other.depth)
        assert torch.equal(both.extra["accumulated_weight"], other.extra["accumulated_weight"])


BWD_KERNEL = "void (anonymous namespace)::composite_bwd_kernel<__nv_bfloat16>(float const*, ...)"


def test_bwd_roofline_reader():
    """Bytes at the launched shape over the mean device time; None where
    the counter disagrees with the kernels found, where two shapes were
    launched, or where the program has no such counter (the parent's)."""
    module = reader("composite_bwd_roofline")
    assert module.COUNTERS == {
        "composite_bwd_launches": ("voxe_tpu_torch.ops.composite", "LAUNCHES_BWD", "delta"),
        "composite_bwd_shapes": ("voxe_tpu_torch.ops.composite", "LAUNCHED_BWD_SHAPES", "copy"),
    }
    shape = (589824, 160, 3, 2, True, True)
    nbytes = module.composite_bwd_bytes(*shape)
    # sigma, depths and dsigma 377 MB each, radiance and its gradient 566 MB
    # each, the mask 94 MB, the [N] vectors: 2.37 GB, 0.71 ms at 3.35 TB/s
    assert nbytes == pytest.approx(2.3735e9, rel=1e-4)
    kernels = [(BWD_KERNEL, 0.0, 1000.0), ("composite_fwd_kernel", 0.0, 700.0),
               ("composite_sums_kernel", 0.0, 500.0)] * 2

    def read(launches, shapes=frozenset({shape}), ks=kernels):
        return module.read(Trace(ks, 0.0, 0.0, 2, 1.0,
                                 {"composite_bwd_launches": launches, "composite_bwd_shapes": set(shapes)}, {}, {}))

    assert read(2) == pytest.approx(100.0 * nbytes / 3.35e12 / 1e-3)
    assert read(3) is None  # the count disagrees with the kernels found
    assert read(2, {shape, (8, 160, 2, 2, False, True)}) is None  # two shapes
    assert read(0, set(), kernels[1:3]) is None  # no backward ran
    assert module.read(Trace(kernels, 0.0, 0.0, 2, 1.0, {}, {}, {})) is None  # a program without the counter
    less = module.composite_bwd_bytes(147456, 160, 2, 2, False, True)
    assert less == pytest.approx(147456 * (160 * (4 + 4 + 4 + 1 + 4) + 4 * 5))


def test_bwd_roofline_asks_for_no_counter_without_it(monkeypatch):
    monkeypatch.delattr(tcomp, "LAUNCHES_BWD")
    assert reader("composite_bwd_roofline").COUNTERS == {}


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


# (N, S, C, radiance dtype, dsigma wanted, density's top, rays wholly outside):
# the recon step's render at 768^2 over 160 slices; refine's attention
# render at 384^2 (two channels, the frozen density: no dsigma); one and
# six channels (six: colour and diffuse stacked above degree 0); ragged N
# and S; opaque rays (transmittance underflows to 0 within the ray); empty
# rays (all outside); an f32 radiance (an f32 table)
RENDER_CASES = [
    (589824, 160, 3, torch.bfloat16, True, 5.0, 0),
    (147456, 160, 2, torch.bfloat16, False, 5.0, 0),
    (4096, 160, 1, torch.bfloat16, True, 5.0, 0),
    (4096, 160, 6, torch.bfloat16, True, 5.0, 0),
    (1000, 37, 3, torch.bfloat16, True, 5.0, 0),
    (777, 160, 3, torch.bfloat16, True, 50.0, 0),
    (512, 160, 3, torch.bfloat16, True, 5.0, 512),
    (1000, 37, 3, torch.float32, True, 5.0, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c,dtype,want_sigma,hi,empty", RENDER_CASES)
def test_composite_render_matches_plain_on_card(cuda_device, n, s, c, dtype, want_sigma, hi, empty):
    """The weights, sums and backward kernels against the plain tail on the
    card (`composite_render_reference`: the same weights kernel, whose
    backward re-differentiates its plain version, then plain sums), both
    from the same inputs and upstream gradients."""
    inputs = _render_inputs(n, s, c, dtype, hi=hi, empty=empty, device=cuda_device)
    upstream = _upstream(n, c, device=cuda_device)
    with tracing.counted() as counts:
        colour, depth, acc, dsigma, dradiance = _composite_and_grads(tcomp.composite_render, inputs, upstream,
                                                                     want_sigma)
        torch.cuda.synchronize()
        launched = {k: counts[k] for k in ("composite.LAUNCHES", "composite.LAUNCHES_SUMS", "composite.LAUNCHES_BWD")}
    assert launched == {"composite.LAUNCHES": 1, "composite.LAUNCHES_SUMS": 1, "composite.LAUNCHES_BWD": 1}
    assert counts["composite.LAUNCHED_BWD_SHAPES"] <= {(n, s, c, inputs[3].element_size(), want_sigma, True)}
    ref = _composite_and_grads(tcomp.composite_render_reference, inputs, upstream, want_sigma)
    # acc is the one weights kernel's on both sides
    assert torch.equal(acc, ref[2])
    # colour in [0, 1] and depth in [0, 6): f32 sums of the same products in
    # another order, held as kernel 2 holds its weights, relative above 1
    for got, want in ((colour, ref[0]), (depth, ref[1])):
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5
    # dradiance: the same roundings of the same bf16 or f32 values on both
    # sides (the library's sigmoid backward on the card rounds 1 - y and
    # its first product to the dtype, and so does the kernel); a sigmoid
    # whose f32 value rounds the other way is one ulp of the radiance dtype
    mantissa = 7 if dtype == torch.bfloat16 else 23
    want = ref[4].float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=torch.finfo(dtype).tiny))) - mantissa)
    assert bool(((dradiance.float() - want).abs() <= ulp).all())
    assert bool((dradiance[:empty] == 0).all())
    if not want_sigma:
        assert dsigma is None
        return
    # dsigma: delta_k (T_{k+1} e_k - sum_{i>k} e_i w_i) against the plain
    # cumprod's backward (a reversed cumulative sum divided by 1 - alpha):
    # the same f32 terms in another order, up to S of them, relative to the
    # batch's largest gradient
    scale = float(ref[3].abs().max())
    assert scale > 0.0 and torch.isfinite(dsigma).all()
    assert float((dsigma - ref[3]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_composite_render_rejects_what_it_cannot_take(cuda_device):
    sigma, depths, dir_norms, radiance, inside = _render_inputs(8, 16, 3, torch.bfloat16, device=cuda_device)
    ok = (sigma, depths, dir_norms, radiance, inside)

    def refused(i, x):
        with pytest.raises(ValueError):
            tcomp.composite_render(*ok[:i], x, *ok[i + 1:])

    refused(0, sigma.double())  # dtype
    refused(3, radiance.half())
    refused(4, inside.to(torch.uint8))
    refused(1, depths.t().contiguous().t())  # not row-major
    refused(3, radiance.transpose(0, 1).contiguous().transpose(0, 1))
    refused(2, dir_norms.cpu())  # device
    refused(3, torch.zeros((8, 16, 7), dtype=torch.bfloat16, device=cuda_device))  # C > 6
    with pytest.raises(ValueError):
        tcomp.composite_render(sigma[:, :1].contiguous(), depths[:, :1].contiguous(), dir_norms,
                               radiance[:, :1].contiguous(), inside[:, :1].contiguous())  # S = 1
    with pytest.raises(ValueError):  # the render's geometry takes no gradient
        tcomp.composite_render(sigma, depths.clone().requires_grad_(True), dir_norms, radiance, inside)
