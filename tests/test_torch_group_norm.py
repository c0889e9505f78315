"""The SD stack's GroupNorm: its `silu` flag, the plain backward formula the
kernel computes, the launch plan, the benchmark's reader and, on the card,
the kernel (`voxe_tpu_torch/csrc/group_norm.cu`) against the plain version.

On the CPU: the flag equals `F.silu` after the norm bit for bit; the tiny
VAE and UNet with their flags set equal the arithmetic before the flag
(`F.silu` applied by the blocks) bit for bit; the kernel's backward formula
equals autograd of the plain version, a constant group included, and the
clamp's zero gradient where E[x^2] - mean^2 < 0; the launch plan fills the
card; `SHAPES` is every (B, C, H, W) that the benchmark's three SD
configurations launch. On the card (marked `cuda`, skipped without one): the
kernel forward and backward against the plain version at every shape of
`SHAPES`, in both layouts, with and without SiLU, bf16 and f32; a constant
group and a group whose variance comes out below 0; bitwise repeatability
and a CUDA graph's replay; the counters. The upstream gradient has a mean
and a part along x, so that the two terms the backward's fold adds to dx
(the group's mean and its slope along x) carry weight of order one. The card
has no JAX: run the card part with `--noconftest`."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench.lib.manifest import reader
from portbench.lib.trace import Trace
from voxe_tpu_torch.models.sd.config import SD_VERSIONS, tiny_test_config
from voxe_tpu_torch.models.sd.norms import GroupNorm
from voxe_tpu_torch.models.sd.unet import UNet2DConditionModel
from voxe_tpu_torch.models.sd.vae import AutoencoderKL, Encoder
from voxe_tpu_torch.ops import group_norm as gn
from voxe_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# every (B, C, H, W) a GroupNorm sees in the cells' SD: the VAE encoder at
# B = 1 and the CFG UNet at B = 2, for dog2-sd2, dog2-sd14 and dog2-sdxl
SHAPES = (
    (1, 128, 256, 256), (1, 128, 512, 512), (1, 128, 1024, 1024), (1, 256, 128, 128), (1, 256, 256, 256),
    (1, 256, 512, 512), (1, 512, 64, 64), (1, 512, 128, 128), (1, 512, 256, 256),
    (2, 320, 32, 32), (2, 320, 64, 64), (2, 320, 128, 128), (2, 640, 16, 16), (2, 640, 32, 32), (2, 640, 64, 64),
    (2, 640, 128, 128), (2, 960, 32, 32), (2, 960, 64, 64), (2, 960, 128, 128), (2, 1280, 8, 8),
    (2, 1280, 16, 16), (2, 1280, 32, 32), (2, 1280, 64, 64), (2, 1920, 16, 16), (2, 1920, 32, 32),
    (2, 1920, 64, 64), (2, 2560, 8, 8), (2, 2560, 16, 16), (2, 2560, 32, 32),
)
H100_SMS = 132


def _inputs(shape, dtype, device, seed=0, channels_last=False):
    g = torch.Generator().manual_seed(seed)
    B, C = shape[:2]
    x = (torch.randn(shape, generator=g) * 2.0 + 0.5).to(dtype)
    w = (torch.randn(C, generator=g) * 0.5 + 1.0).to(dtype)
    b = (torch.randn(C, generator=g) * 0.5).to(dtype)
    dy = (torch.randn(shape, generator=g) + 1.0 + 0.25 * x.float()).to(dtype)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x, dy = (t.to(device).contiguous(memory_format=fmt) for t in (x, dy))
    return x, w.to(device), b.to(device), dy


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_silu_flag_is_silu_after_the_norm(dtype, channels_last):
    x, w, b, _ = _inputs((2, 16, 5, 7), dtype, "cpu", channels_last=channels_last)
    plain, fused = GroupNorm(4, 16, 1e-5).to(dtype), GroupNorm(4, 16, 1e-5, silu=True).to(dtype)
    for m in (plain, fused):
        m.weight.data, m.bias.data = w.clone(), b.clone()
    assert torch.equal(fused(x), F.silu(plain(x)))


def _unfused(model):
    """`model` with every flagged norm computing as before the flag: the
    norm alone, then `F.silu` on its output. Returns the hooks to remove."""
    hooks = []
    for m in model.modules():
        if isinstance(m, GroupNorm) and m.silu:
            m.silu = False
            hooks.append(m.register_forward_hook(lambda mod, args, out: F.silu(out)))
    return hooks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vae_and_unet_keep_their_arithmetic(dtype):
    cfg = tiny_test_config()
    torch.manual_seed(0)
    vae, unet = AutoencoderKL(cfg.vae).to(dtype), UNet2DConditionModel(cfg.unet).to(dtype)
    for model in (vae, unet):
        for m in model.modules():
            if isinstance(m, GroupNorm):  # non-trivial affine parameters
                m.weight.data.normal_(1.0, 0.3)
                m.bias.data.normal_(0.0, 0.3)
    g = torch.Generator().manual_seed(1)
    img = torch.rand((1, 3, 64, 64), generator=g).to(dtype) * 2 - 1
    lat = torch.randn((2, 4, 8, 8), generator=g).to(dtype)
    ctx = torch.randn((2, 7, cfg.unet.cross_attention_dim), generator=g).to(dtype)

    def run():
        with torch.no_grad():
            return vae.encode(img), vae.decode(lat[:1]), unet(lat, 500, ctx)

    fused = run()
    hooks = _unfused(vae) + _unfused(unet)
    before = run()
    for h in hooks:
        h.remove()
    for a, b in zip(fused, before):
        assert torch.equal(a, b)


def test_silu_flags_sit_where_the_blocks_applied_silu():
    cfg = tiny_test_config()
    vae, unet = AutoencoderKL(cfg.vae), UNet2DConditionModel(cfg.unet)
    flagged = {n.rsplit(".", 1)[-1] for model in (vae, unet) for n, m in model.named_modules()
               if isinstance(m, GroupNorm) and m.silu}
    unflagged = {n.rsplit(".", 1)[-1] for model in (vae, unet) for n, m in model.named_modules()
                 if isinstance(m, GroupNorm) and not m.silu}
    assert flagged == {"norm1", "norm2", "conv_norm_out"}
    assert unflagged == {"group_norm", "norm"}  # AttnBlock's and Transformer2D's


def _plain_variance(x, G):
    """E[x^2] - mean^2 [B, G] as the plain version computes it."""
    B, C = x.shape[:2]
    xf = x.detach().float()
    n = float(x[0, 0].numel() * (C // G))
    g1 = xf.sum((2, 3)).reshape(B, G, -1).sum(-1) / n
    g2 = (xf * xf).sum((2, 3)).reshape(B, G, -1).sum(-1) / n
    return g2 - g1 * g1


def _backward_formula(x, dy, weight, bias, num_groups: int, eps: float, silu: bool):
    """The kernel's backward as a plain formula, in f32 (no autograd): the
    forward's statistics as the plain version computes them, then, per
    (b, group) with g = dy * silu'(z) (or dy) and da_c = sum(g x) -
    mean * sum(g), dgamma_c = sum_b rstd * da_c, dbeta_c = sum_b sum(g),
    dvar = -rstd^3 / 2 * sum_c gamma_c da_c where E[x^2] - mean^2 >= 0 (else
    0), dmean = -sum_c a_c sum(g) - 2 mean dvar and
    dx = g * a + dmean / n + (2 dvar / n) * x. Returns (dx, dgamma, dbeta)."""
    B, C = x.shape[:2]
    G, reps = num_groups, C // num_groups
    n = float(x[0, 0].numel() * reps)
    xf, dyf = x.float().reshape(B, G, reps, -1), dy.float().reshape(B, G, reps, -1)
    s1, s2 = xf.sum(-1), (xf * xf).sum(-1)  # [B, G, reps]
    mean, ex2 = s1.sum(-1, keepdim=True) / n, s2.sum(-1, keepdim=True) / n  # [B, G, 1]
    d = ex2 - mean * mean
    rstd = torch.rsqrt(torch.clamp(d, min=0.0) + eps)
    gamma = weight.float().reshape(G, reps)
    a = rstd * gamma  # [B, G, reps]
    b = bias.float().reshape(G, reps) - mean * a
    z = xf * a[..., None] + b[..., None]
    g = dyf * (torch.sigmoid(z) * (1.0 + z * (1.0 - torch.sigmoid(z)))) if silu else dyf
    g1, gx = g.sum(-1), (g * xf).sum(-1)  # [B, G, reps]
    da = gx - mean * g1
    dvar = torch.where(d >= 0, -0.5 * rstd**3 * (gamma * da).sum(-1, keepdim=True), torch.zeros_like(d))
    dmean = -(a * g1).sum(-1, keepdim=True) - 2.0 * mean * dvar
    dx = g * a[..., None] + (dmean / n)[..., None] + (2.0 * dvar / n)[..., None] * xf
    return dx.reshape(x.shape), (rstd * da).sum(0).reshape(C), g1.sum(0).reshape(C)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("group", ["random", "constant", "negative_variance"])
def test_backward_formula_equals_autograd_of_the_plain_version(silu, group):
    B, C, H, W, G = 2, 12, 5, 6, 3
    x, w, b, dy = _inputs((B, C, H, W), torch.float32, "cpu", seed=2)
    reps = C // G
    if group == "constant":  # E[x^2] - mean^2 is exactly 0: rstd = eps^-1/2
        x[1, reps:2 * reps] = 1.0
        assert float(_plain_variance(x, G)[1, 1]) == 0.0
    elif group == "negative_variance":  # the clamp holds the variance at 0 and passes no gradient
        for k in range(1, 400):
            x[1, reps:2 * reps] = 0.01 * k + 0.003
            if float(_plain_variance(x, G)[1, 1]) < 0.0:
                break
        assert float(_plain_variance(x, G)[1, 1]) < 0.0
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = gn.group_norm_reference(x, w, b, G, 1e-6, silu)
    want = torch.autograd.grad(y, (x, w, b), dy)
    got = _backward_formula(x.detach(), dy, w.detach(), b.detach(), G, 1e-6, silu)
    for name, g_, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
        scale = float(w_.abs().max())
        assert float((g_ - w_).abs().max()) <= 2e-5 * scale, name  # f32, another summation order


def test_plan_fills_the_card_and_fits_a_block():
    assert gn.plan(1, 128, 1024 * 1024, True, 8, H100_SMS) == (528, 16, 16)
    for B, C, H, W in SHAPES:
        for nhwc in (True, False):
            for vec in (8, 4, 1):
                S, tc, tp = gn.plan(B, C, H * W, nhwc, vec, H100_SMS)
                if nhwc:
                    chunks = -(-(C // vec) // tc)
                    assert tc * tp <= gn.THREADS and tc <= 64 and chunks * tc >= C // vec
                    blocks, most = S * chunks * B, -(-H * W // tp)
                else:
                    blocks, most = S * -(-B * C // gn.ROWS_PER_BLOCK), -(-H * W // (32 * vec))
                assert 1 <= S <= most
                assert blocks >= gn.BLOCKS_PER_SM * H100_SMS or S == most


def _launched(version: str, size: int):
    """(B, C, H, W) of every GroupNorm call of the VAE encoder at B = 1 and
    the CFG UNet at B = 2, from a run on the meta device."""
    cfg = SD_VERSIONS[version]
    seen = []
    with torch.device("meta"):
        enc, unet = Encoder(cfg.vae), UNet2DConditionModel(cfg.unet)
    for m in list(enc.modules()) + list(unet.modules()):
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(lambda mod, args: seen.append(tuple(args[0].shape)))
    f = 2 ** (len(cfg.vae.block_out_channels) - 1)
    pooled = cfg.unet.projection_class_embeddings_input_dim - 6 * cfg.unet.addition_time_embed_dim
    added = None if cfg.unet.addition_embed_type is None else (
        torch.empty(2, pooled, device="meta"), torch.empty(2, 6, device="meta"))
    with torch.device("meta"):
        enc(torch.empty(1, 3, size, size))
        unet(torch.empty(2, 4, size // f, size // f), torch.tensor([500]),
             torch.empty(2, 77, cfg.unet.cross_attention_dim), attn_edit_fn=lambda p, *a: p, added_cond=added)
    return seen


def test_shapes_are_what_the_cells_launch():
    seen = set()
    for name in ("dog2-sd2", "dog2-sd14", "dog2-sdxl"):
        sd = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["sd"]
        seen |= set(_launched(sd["version"], int(sd["image_size"])))
    assert seen == set(SHAPES)


def test_reader_lays_the_kernels_over_the_steps():
    module = reader("groupnorm_device_ms.xl")
    assert module.COUNTERS == {"group_norm_calls": ("voxe_tpu_torch.ops.group_norm", "LAUNCHES", "delta")}
    kernels = [("void (anonymous namespace)::group_norm_nhwc_kernel<__nv_bfloat16, 8, 0>", 0.0, 100.0),
               ("void (anonymous namespace)::group_norm_fold_fwd_kernel<__nv_bfloat16>", 100.0, 5.0),
               ("void (anonymous namespace)::group_norm_nhwc_kernel<__nv_bfloat16, 8, 1>", 105.0, 195.0),
               ("void at::native::vectorized_elementwise_kernel<4, ...>", 300.0, 50.0)] * 4

    def read(calls, ks=kernels):
        return module.read(Trace(ks, 0.0, 0.0, 2, 1.0, {"group_norm_calls": calls}, {}, {}))

    assert read(4) == pytest.approx(4 * 300.0 * 1e-3 / 2)  # 0.6 ms a step
    assert read(3) is None  # the count disagrees with the kernels found
    assert read(0, ks=kernels[3:4]) is None  # no such kernel ran
    assert module.read(Trace(kernels, 0.0, 0.0, 2, 1.0, {}, {}, {})) is None  # a program without the counter


def test_reader_asks_for_no_counter_without_the_module(monkeypatch):
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    assert reader("groupnorm_device_ms.xl").COUNTERS == {}


def test_cpu_tensors_take_the_plain_version():
    x, w, b, _ = _inputs((1, 8, 4, 4), torch.float32, "cpu")
    with tracing.counted() as c:
        assert torch.equal(gn.group_norm(x, w, b, 2, 1e-6, True), gn.group_norm_reference(x, w, b, 2, 1e-6, True))
    assert c["group_norm.LAUNCHES"] == c["group_norm.REFERENCE_ON_CUDA"] == 0


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GroupNorm kernel has no CPU mode")
    gn.build()
    return torch.device("cuda")


def _plain_f32(x, w, b, dy, G, silu):
    """The plain version in f32 from the same inputs, and its autograd."""
    xf, wf, bf = (t.detach().float().requires_grad_(True) for t in (x, w, b))
    y = gn.group_norm_reference(xf, wf, bf, G, 1e-6, silu)
    return (y.detach(), *torch.autograd.grad(y, (xf, wf, bf), dy.float()))


def _close(got, want, rel, floor):
    """|got - want| <= rel |want| + floor max|want| element by element."""
    got, want = got.float(), want.float()
    bound = rel * want.abs() + floor * float(want.abs().max())
    return bool(((got - want).abs() <= bound).all())


def _kernel(x, w, b, dy, G, silu):
    x, w, b = (t.detach().requires_grad_(True) for t in (x, w, b))
    y = gn.group_norm(x, w, b, G, 1e-6, silu)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))


# bf16: one rounding of each output (2^-8 of it) beside the f32 sums' other
# order, which the floor absorbs where the output cancels; f32: the order alone
TOLS = {torch.bfloat16: (2.0**-8, 2e-3), torch.float32: (1e-5, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_bf16(card, shape, channels_last, silu):
    x, w, b, dy = _inputs(shape, torch.bfloat16, card, channels_last=channels_last)
    with tracing.counted() as c:
        got = _kernel(x, w, b, dy, 32, silu)
    assert c["group_norm.LAUNCHES"] == 2 and c["group_norm.REFERENCE_ON_CUDA"] == 0
    assert got[0].is_contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    want = _plain_f32(x, w, b, dy, 32, silu)
    for name, g_, w_ in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert g_.dtype == torch.bfloat16 and _close(g_, w_, *TOLS[torch.bfloat16]), name


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(1, 128, 512, 512), (2, 320, 64, 64), (2, 2560, 8, 8), (1, 36, 7, 9)])
def test_kernel_matches_plain_f32(card, shape, channels_last, silu):
    x, w, b, dy = _inputs(shape, torch.float32, card, channels_last=channels_last)
    got = _kernel(x, w, b, dy, 4 if shape[1] == 36 else 32, silu)
    want = _plain_f32(x, w, b, dy, 4 if shape[1] == 36 else 32, silu)
    for name, g_, w_ in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert _close(g_, w_, *TOLS[torch.float32]), name


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [True, False])
def test_single_element_vectors(card, channels_last):
    """bf16 with C (channels_last) or H W (NCHW) not a multiple of 8, and an
    input that starts off a 16-byte boundary: one element a load."""
    x, w, b, dy = _inputs((2, 36, 7, 9), torch.bfloat16, card, channels_last=channels_last)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
    shifted = flat[1:].view(x.shape) if not channels_last else flat[1:].view(2, 7, 9, 36).permute(0, 3, 1, 2)
    shifted.copy_(x)
    for inp in (x, shifted):
        got, want = _kernel(inp, w, b, dy, 4, True), _plain_f32(inp, w, b, dy, 4, True)
        for name, g_, w_ in zip(("y", "dx", "dgamma", "dbeta"), got, want):
            assert _close(g_, w_, *TOLS[torch.bfloat16]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_constant_group(card, dtype):
    """A group of ones: E[x^2] - mean^2 is exactly 0, rstd = eps^-1/2, the
    group's output is beta and its gradient the plain version's."""
    x, w, b, dy = _inputs((1, 128, 64, 64), dtype, card, channels_last=True)
    x[:, 8:12] = 1.0
    got, want = _kernel(x, w, b, dy, 32, True), _plain_f32(x, w, b, dy, 32, True)
    for name, g_, w_ in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert _close(g_, w_, *TOLS[dtype]), name
    beta = F.silu(b[8:12].float())[None, :, None, None].expand(1, 4, 64, 64)
    assert _close(got[0][:, 8:12], beta, *TOLS[dtype])


@pytest.mark.cuda
def test_negative_variance_group(card):
    """A group of one f32 value whose E[x^2] - mean^2 comes out below 0 both
    in the kernel's sums and in the plain version's: the variance clamps to 0
    and passes no gradient in both, so the kernel's dx, dgamma and dbeta
    equal autograd of the plain version there too. (In bf16 such a group's
    few significant bits sum exactly, to 0: `test_constant_group`.)"""
    G, C = 32, 128
    x, w, b, dy = _inputs((1, C, 16, 16), torch.float32, card, channels_last=True)
    for k in range(1, 400):
        x[:, 4:8] = 0.01 + 1e-4 * k + 3e-5  # group 1; small, so that dgamma's cancellation stays in the floor
        stats = gn.forward_kernel(x, w, b, G, 1e-6, True)[1][2 * C:].view(G, 3)  # mean, rstd, d a group
        if float(stats[1, 2]) < 0.0 and float(_plain_variance(x, G)[0, 1]) < 0.0:
            break
    assert float(stats[1, 2]) < 0.0 and float(_plain_variance(x, G)[0, 1]) < 0.0
    got, want = _kernel(x, w, b, dy, G, True), _plain_f32(x, w, b, dy, G, True)
    for name, g_, w_ in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert _close(g_, w_, *TOLS[torch.float32]), name


@pytest.mark.cuda
def test_bitwise_repeatable_and_replayed(card):
    x, w, b, dy = _inputs((2, 640, 32, 32), torch.bfloat16, card, channels_last=True)
    first, second = _kernel(x, w, b, dy, 32, True), _kernel(x, w, b, dy, 32, True)
    for a_, b_ in zip(first, second):
        assert torch.equal(a_, b_)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.group_norm(static, w, b, 32, 1e-6, True)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with tracing.counted() as c:
        with tracing.captured() as tally, torch.cuda.graph(graph):
            out = gn.group_norm(static, w, b, 32, 1e-6, True)
        assert tally == {"group_norm.LAUNCHES": 1} and c["group_norm.LAUNCHES"] == 0
        other, _, _, _ = _inputs((2, 640, 32, 32), torch.bfloat16, card, seed=5, channels_last=True)
        for inp in (other, x):
            static.copy_(inp)
            graph.replay()
            tracing.replayed(tally)
            torch.cuda.synchronize()
            assert torch.equal(out, gn.group_norm(inp, w, b, 32, 1e-6, True))
    assert c["group_norm.LAUNCHES"] == 4 and c["group_norm.REFERENCE_ON_CUDA"] == 0


@pytest.mark.cuda
def test_refusals(card):
    x, w, b, _ = _inputs((1, 64, 8, 8), torch.bfloat16, card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gn.group_norm(x.half(), w, b, 32, 1e-6)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        gn.group_norm(x.transpose(2, 3), w, b, 32, 1e-6)
    with pytest.raises(ValueError, match="at most 256 a group"):
        gn.group_norm(torch.zeros((1, 512, 4, 4), dtype=torch.bfloat16, device=card), torch.ones(512, device=card),
                      torch.zeros(512, device=card), 1, 1e-6)
    with pytest.raises(ValueError, match="4-D"):
        gn.group_norm(x[0], w, b, 32, 1e-6)
