"""The flash-attention backward of the port against voxe_tpu on the CPU:
`flash_attention_backward_reference` against the JAX library's own reference
backward (`mha_reference_bwd`, reached as its custom VJP reaches it), the
autograd of the port's `flash_attention` against `jax.vjp` of
`mha_reference`, the plain versions of the backward's preprocess and
postprocess kernels (Di, the padded LSE, the tile-ordered dQ workspace)
against the library's Di, the UNet's `CrossAttention` at a gate-admitted
shape and the tiny UNet's latent gradient against `jax.grad` of the JAX
modules. Inputs are made with numpy from a seed; everything runs in f32.
Tests marked `cuda` hold the backward kernels against the plain versions on a
card (skipped without one). The card's machine has no JAX, so the JAX imports
are optional and only the `cuda` tests run there."""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu import flash_attention as jfa

    from tests.test_torch_sd import _nchw, _nhwc, _numpy_params, _rel_err
    from voxe_tpu.models.sd import unet as junet
    from voxe_tpu.models.sd.sds import StableDiffusion as JSD
except ImportError:  # the card's machine: only the `cuda` tests below run there
    jax = None
from voxe_tpu_torch.models.sd import unet as tunet
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.sd.weights import from_flax_params
from voxe_tpu_torch.ops import cuda_build
from voxe_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("the JAX reference package is not installed")


def _bhld(x):
    """[B, L, h, d] numpy -> the JAX library's [B, h, L, d]."""
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


def _blhd(x):
    return np.swapaxes(np.asarray(x), 1, 2)


def _inputs(shape, lk, seed):
    rng = np.random.default_rng(seed)
    B, L, H, D = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k, v = (rng.standard_normal((B, lk or L, H, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("shape,lk,scale", [
    ((2, 256, 2, 64), None, 1.0),
    ((2, 256, 2, 64), None, 0.125),  # the UNet's d^-1/2
    ((1, 200, 3, 64), 136, 0.125),  # ragged, Lq != Lk
])
def test_backward_reference_matches_library_reference(shape, lk, scale):
    """The plain backward (lse in, the explicit formula) against the
    library's `mha_reference_bwd` from its forward's (l, m) residuals, within
    1e-5 of max|ref|. The library's reference takes sm_scale 1 only, so q is
    scaled first: dq = scale * dq', dk and dv unchanged."""
    q, k, v, do = _inputs(shape, lk, seed=int(scale * 8) + shape[1])
    jq, jk, jv, jdo = (_bhld(x) for x in (q, k, v, do))
    jq = jq * scale
    out, l, m = jfa.mha_reference_no_custom_vjp(jq, jk, jv, save_residuals=True)
    jdq, jdk, jdv, _ = jfa.mha_reference_bwd(jq, jk, jv, None, None, out, l, m, jdo)
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    dq, dk, dv = fa.flash_attention_backward(tq, tk, tv, torch.from_numpy(_blhd(out).copy()), lse, tdo, scale)
    assert _rel_err(dq.numpy(), scale * _blhd(jdq)) < 1e-5
    assert _rel_err(dk.numpy(), _blhd(jdk)) < 1e-5
    assert _rel_err(dv.numpy(), _blhd(jdv)) < 1e-5
    # the LSE the plain forward gives is the library's m + log l
    _, tlse = fa.flash_attention_with_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(tlse.numpy(), lse.numpy(), rtol=0, atol=1e-5)


def test_autograd_matches_jax_vjp():
    """Autograd through the port's `flash_attention` on CPU tensors against
    `jax.vjp` of the library's `mha_reference` (its custom VJP: the
    reference backward), ragged and Lq != Lk, within 1e-5 of max|ref|; the
    plain path launches nothing."""
    shape, lk, scale = (2, 120, 2, 64), 88, 0.125
    q, k, v, do = _inputs(shape, lk, seed=5)
    # the library's reference VJP takes sm_scale 1 only: scale q inside
    out, vjp = jax.vjp(lambda a, b, c: jfa.mha_reference(a * scale, b, c, None), *(_bhld(x) for x in (q, k, v)))
    jgrads = vjp(_bhld(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    tout = fa.flash_attention(tq, tk, tv, scale)
    tout.backward(torch.from_numpy(do))
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == launches
    assert _rel_err(tout.detach().numpy(), _blhd(out)) < 1e-5
    for t, j in zip((tq, tk, tv), jgrads):
        assert _rel_err(t.grad.numpy(), _blhd(j)) < 1e-5


RAGGED = [(lq, d) for lq in (1000, 2500, 4095) for d in (64, 128)]


@pytest.mark.parametrize("lq,d", RAGGED)
def test_preprocess_reference_matches_library_di(lq, d):
    """The preprocess's plain version against the JAX library on bf16 o and
    dO: Di as `_flash_attention_bwd` writes it (library :273, the f32 rowsum
    of o * do) within 1e-5 of max|Di| (f32 sums in another order), lse times
    log2(e), and the padding to the query tile: Di 0 and lse +inf, so
    P = exp2(S * scale * log2(e) - lse * log2(e)) is exactly 0 there."""
    rng = np.random.default_rng(lq + d)
    B, H = 1, 2
    o, do = (rng.standard_normal((B, lq, H, d)).astype(np.float32) for _ in range(2))
    lse = rng.standard_normal((B, H, lq)).astype(np.float32) * 3.0
    to, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (o, do))
    tile = fa.BWD_Q_TILE[d]
    di, lse2 = fa.flash_attention_bwd_preprocess_reference(to, tdo, torch.from_numpy(lse), tile)
    lq_pad = -(-lq // tile) * tile
    assert di.shape == lse2.shape == (B, H, lq_pad) and di.dtype == lse2.dtype == torch.float32
    jo, jdo = (jnp.asarray(_bhld(x.float().numpy())).astype(jnp.bfloat16) for x in (to, tdo))
    jdi = jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32), axis=-1)
    assert _rel_err(di[..., :lq].numpy(), np.asarray(jdi)) < 1e-5
    np.testing.assert_allclose(lse2[..., :lq].numpy(), lse * np.float32(np.log2(np.e)), rtol=1e-6, atol=0)
    assert torch.all(di[..., lq:] == 0) and torch.all(lse2[..., lq:] == np.inf)
    s = torch.from_numpy(rng.standard_normal((B, H, lq_pad - lq)).astype(np.float32)) * 30.0
    assert torch.all(torch.exp2(s * 0.125 * np.log2(np.e) - lse2[..., lq:]) == 0)


@pytest.mark.parametrize("lq,d", RAGGED)
def test_preprocess_di_matches_mha_reference_bwd(lq, d):
    """Di as the library's `mha_reference_bwd` computes it (:1664), read back
    from its outputs: with the bias gradient dab = dS = P * (dP - Di) and
    rows of P summing to 1, Di = rowsum(P * dP - dab). The preprocess's plain
    version from the same o and dO within 1e-5 of max|Di|."""
    rng = np.random.default_rng(2 * lq + d)
    B, H, lk = 1, 2, 64
    q = rng.standard_normal((B, lq, H, d)).astype(np.float32) * 0.125
    k, v = (rng.standard_normal((B, lk, H, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, lq, H, d)).astype(np.float32)
    jq, jk, jv, jdo = (_bhld(x) for x in (q, k, v, do))
    ab = jnp.zeros((B, H, lq, lk), jnp.float32)
    out, l, m = jfa.mha_reference_no_custom_vjp(jq, jk, jv, ab, save_residuals=True)
    *_, dab = jfa.mha_reference_bwd(jq, jk, jv, ab, None, out, l, m, jdo)
    p = np.exp(np.einsum("bhqd,bhkd->bhqk", np.asarray(jq), np.asarray(jk)) - np.asarray(m)[..., None])
    p /= np.asarray(l)[..., None]
    dp = np.einsum("bhqd,bhkd->bhqk", np.asarray(jdo), np.asarray(jv))
    di_lib = np.sum(p * dp - np.asarray(dab), axis=-1)
    di, _ = fa.flash_attention_bwd_preprocess_reference(
        torch.from_numpy(_blhd(out).copy()), torch.from_numpy(do), torch.zeros((B, H, lq)), fa.BWD_Q_TILE[d])
    assert _rel_err(di[..., :lq].numpy(), di_lib) < 1e-5


def _dq_workspace(dq, lq_pad, rng):
    """Scatters dq [B, Lq, h, d] into the main kernel's f32 workspace layout
    by the per-element formula of its register order (the wgmma
    accumulator: thread tid = 32 warp + 4 g + t4 holds rows 16 warp + g and
    + 8, columns 8 j + 2 t4 + e; pair i = 2 j + (row half) of a 64 x 64
    chunk sits at float 2 (128 i + tid) + e), with noise in the padded rows."""
    B, lq, H, d = dq.shape
    M = fa.BWD_Q_TILE[d]
    ws = rng.standard_normal((B, H, lq_pad * d)).astype(np.float32) * 100.0
    q, c = np.meshgrid(np.arange(lq), np.arange(d), indexing="ij")
    qi, r, cc = q % M, q % M % 64, c % 64
    warp, half, g = r // 16, r % 16 // 8, r % 8
    pair = 2 * (cc // 8) + half
    tid = 32 * warp + 4 * g + cc % 8 // 2
    off = (q - qi) * d + (qi // 64 * (d // 64) + c // 64) * 4096 + 2 * (128 * pair + tid) + cc % 2
    ws[:, :, off] = np.transpose(dq, (0, 2, 1, 3))
    return ws.reshape(B, H, lq_pad, d)


@pytest.mark.parametrize("lq,d", RAGGED)
def test_dq_postprocess_reference_round_trip(lq, d):
    """A dq scattered into the workspace's tile order comes back from the
    postprocess's plain version as (dq * scale) in bf16 [B, Lq, h, d],
    exactly, whatever the padded rows hold."""
    rng = np.random.default_rng(3 * lq + d)
    B, H, scale = 2, 3, 0.37
    tile = fa.BWD_Q_TILE[d]
    dq = rng.standard_normal((B, lq, H, d)).astype(np.float32)
    ws = _dq_workspace(dq, -(-lq // tile) * tile, rng)
    out = fa.flash_attention_dq_postprocess_reference(torch.from_numpy(ws), scale, lq)
    assert out.dtype == torch.bfloat16 and out.shape == (B, lq, H, d)
    want = (torch.from_numpy(dq) * scale).to(torch.bfloat16)
    assert torch.equal(out, want)


PTXAS_SAMPLE = """\
ptxas info    : Compiling entry function '_ZN4kern16flash_bwd_kernelILi64EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4kern16flash_bwd_kernelILi64EEEv
    256 bytes stack frame, 516 bytes spill stores, 512 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 256 bytes cumulative stack size
ptxas info    : Compile time = 272.039 ms
ptxas info    : Compiling entry function '_ZN4kern20flash_bwd_pre_kernelILi64EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4kern20flash_bwd_pre_kernelILi64EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_summary_reads_registers_and_spills():
    """The build's ptxas report, kernel by kernel, as chip_smoke.py logs it."""
    got = cuda_build.ptxas_summary(PTXAS_SAMPLE)
    assert got == {
        "_ZN4kern16flash_bwd_kernelILi64EEEv": dict(stack=256, spill_stores=516, spill_loads=512, registers=168),
        "_ZN4kern20flash_bwd_pre_kernelILi64EEEv": dict(stack=0, spill_stores=0, spill_loads=0, registers=32),
    }
    assert cuda_build.ptxas_summary("") == {}


def test_cross_attention_gradients_match_jax():
    """The UNet's CrossAttention at a shape its flash gate admits (1 x 2048
    queries, one head of 64): on CPU tensors the port's flash route is the
    plain version; JAX's gate is off on the CPU, so it takes
    `jax.nn.dot_product_attention`. The gradients of the input and of the
    four weights (and the output bias) within 1e-5 of their max."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 2048, 64)).astype(np.float32)
    w = rng.standard_normal((1, 2048, 64)).astype(np.float32)
    jm = junet.CrossAttention(1)
    params = _numpy_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], seed=10)

    def loss(prm, inp):
        return jnp.sum(jm.apply({"params": prm}, inp) * w)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tm = tunet.CrossAttention(64, 64, 1)
    tm.load_state_dict(from_flax_params(params), strict=True)
    assert tunet.flash_self_attention_enabled(2048, 64)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tm(tx) * torch.from_numpy(w)).sum().backward()
    assert _rel_err(tx.grad.numpy(), jgx) < 1e-5
    for name in ("to_q", "to_k", "to_v", "to_out_0"):
        # flax kernels are [in, out], torch weights [out, in]
        tg = getattr(tm, name).weight.grad.numpy().T
        assert _rel_err(tg, jgp[name]["kernel"]) < 1e-5, name
    assert _rel_err(tm.to_out_0.bias.grad.numpy(), jgp["to_out_0"]["bias"]) < 1e-5


def test_tiny_unet_latent_gradient_matches_jax():
    """The tiny SD UNet's gradient with respect to its latents (CFG batch 2,
    t 321), against `jax.grad` of the JAX UNet with the same parameters,
    within 1e-4 of its max (the forward's tolerance in test_torch_sd)."""
    jsd = JSD("tiny", unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params)["unet"]
    tsd = TSD("tiny", unet_dtype=torch.float32, device="cpu", seed=1)
    tsd.unet.load_state_dict(from_flax_params(params), strict=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    w = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)

    def loss(inp):
        out = jsd.unet.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, inp, jnp.asarray(321),
                             jnp.asarray(ctx))
        return jnp.sum(out * w)

    jg = jax.jit(jax.grad(loss))(jnp.asarray(x))
    tx = _nchw(x).requires_grad_(True)
    out = tsd.unet(tx, torch.tensor(321), torch.from_numpy(ctx))
    (out * _nchw(w)).sum().backward()
    assert _rel_err(_nhwc(tx.grad), jg) < 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(dev, shape, lk, q_scale, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = shape if lk is None else (shape[0], lk, *shape[2:])
    q = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) * q_scale
    k, v = (torch.randn(kv, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    do = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    return q, k, v, do


def _hold_backward(q, k, v, do, scale, grads):
    """dq, dk and dv against the plain f32 backward from the same bf16
    inputs (its own f32 forward and LSE), within 2e-2 of max|ref| (P and dS
    are bf16 operands)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    refs = fa.flash_attention_backward_reference(
        qf, kf, vf, fa.flash_attention_reference(qf, kf, vf, scale), fa.flash_attention_lse_reference(qf, kf, scale),
        do, scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        assert float((a.float() - r).abs().max() / r.abs().max()) < 2e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lk,q_scale,scale", [
    ((2, 4096, 5, 64), None, 1.0, None),  # the UNet's 64x64 level (CFG batch 2)
    ((1, 1000, 3, 64), None, 4.0, None),  # peaked scores
    ((2, 1000, 3, 64), 777, 1.0, None),  # ragged, Lq != Lk, Lk not a multiple of the 128-key block
    ((1, 2500, 2, 128), None, 1.0, None),
    ((1, 2500, 2, 128), 1000, 1.0, 0.3),  # a scale other than d^-1/2
    ((2, 1000, 3, 64), 1000, 1.0, 0.05),
    ((1, 1, 2, 64), 777, 1.0, None),  # one query: a tile of padding
    ((1, 1, 2, 128), 1000, 1.0, None),
])
def test_backward_kernels_match_plain_on_card(cuda_device, shape, lk, q_scale, scale):
    """The three kernels of one backward call (one count) against the plain
    f32 backward, at ragged lengths, Lq != Lk, one query and non-default
    scales."""
    q, k, v, do = _card_inputs(cuda_device, shape, lk, q_scale, seed=0)
    scale = 1.0 / shape[-1] ** 0.5 if scale is None else scale
    out, lse = fa.flash_attention_with_lse(q, k, v, scale)
    before = fa.LAUNCHES_BWD
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BWD == before + 1
    _hold_backward(q, k, v, do, scale, grads)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lk", [((2, 1000, 3, 64), 777), ((1, 2500, 2, 128), 1000)])
def test_pre_and_post_kernels_match_plain_on_card(cuda_device, shape, lk):
    """The preprocess kernel's Di within 1e-5 of max|Di| (f32 sums in
    another order) and its padded LSE exactly as the plain version's; the
    postprocess kernel's dq bitwise the plain version's on the workspace the
    main kernel wrote."""
    q, k, v, do = _card_inputs(cuda_device, shape, lk, 1.0, seed=3)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    scale = 1.0 / shape[-1] ** 0.5
    dq, _, _, di, lse2, acc = fa.backward_kernels(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    di_ref, lse2_ref = fa.flash_attention_bwd_preprocess_reference(out, do, lse, fa.BWD_Q_TILE[shape[-1]])
    assert float((di - di_ref).abs().max()) <= 1e-5 * float(di_ref.abs().max())
    assert torch.equal(lse2, lse2_ref)
    assert torch.equal(dq, fa.flash_attention_dq_postprocess_reference(acc, scale, shape[1]))


@pytest.mark.cuda
def test_backward_run_to_run_on_card(cuda_device):
    """Two calls on the same inputs: dk and dv bitwise equal (each block owns
    its keys). dq's key-block partials are added into the f32 workspace in
    the order the blocks finish: the workspaces within 1e-4 of their max (32
    partials reordered: ~1e-6; one lost or doubled: ~3e-2), and dq within
    one bf16 ulp of each element plus 1e-4 of max|dq| (a sum near a rounding
    boundary flips its last bit, 2^-9 to 2^-8 of max|dq| at the largest
    elements; an element near 0 is the workspace's noise and may change
    sign)."""
    q, k, v, do = _card_inputs(cuda_device, (2, 4096, 5, 64), None, 1.0, seed=4)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    a = fa.backward_kernels(q, k, v, out, lse, do, 0.125)
    b = fa.backward_kernels(q, k, v, out, lse, do, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert float((a[5] - b[5]).abs().max()) <= 1e-4 * float(a[5].abs().max())
    dqa, dqb = a[0].float(), b[0].float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(dqa.abs(), dqb.abs()))) - 7)
    assert bool(((dqa - dqb).abs() <= ulp + 1e-4 * float(dqa.abs().max())).all())


@pytest.mark.cuda
def test_backward_smaller_call_after_larger_on_card(cuda_device):
    """A call at the main shape, then a smaller one: the second is right
    (its workspace is zeroed again, whatever the allocator hands back)."""
    for shape, lk in (((2, 4096, 5, 64), None), ((1, 300, 2, 64), 200), ((1, 130, 3, 128), None)):
        q, k, v, do = _card_inputs(cuda_device, shape, lk, 1.0, seed=5)
        out, lse = fa.flash_attention_with_lse(q, k, v)
        grads = fa.flash_attention_backward(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        _hold_backward(q, k, v, do, 1.0 / shape[-1] ** 0.5, grads)


@pytest.mark.cuda
def test_requires_grad_accepted_on_card(cuda_device):
    """On the card `flash_attention` differentiates: one forward launch with
    its LSE, one backward launch, gradients within 2e-2 of the plain
    autograd's; under no_grad it writes no LSE and saves nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((2, 2048, 2, 64), generator=g, device=cuda_device, dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    f0, b0 = fa.LAUNCHES, fa.LAUNCHES_BWD
    out = fa.flash_attention(q, k, v)
    assert out.requires_grad
    out.float().square().sum().backward()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == (f0 + 1, b0 + 1)
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    fa.flash_attention_reference(qf, kf, vf).float().square().sum().backward()
    for a, r in ((q, qf), (k, kf), (v, vf)):
        assert float((a.grad.float() - r.grad).abs().max() / r.grad.abs().max()) < 2e-2
    with torch.no_grad():
        assert not fa.flash_attention(q, k, v).requires_grad
    assert fa.LAUNCHES_BWD == b0 + 1
