"""The flash-attention backward of the port against voxe_tpu on the CPU:
`flash_attention_backward_reference` against the JAX library's own reference
backward (`mha_reference_bwd`, reached as its custom VJP reaches it), the
autograd of the port's `flash_attention` against `jax.vjp` of
`mha_reference`, the UNet's `CrossAttention` at a gate-admitted shape and the
tiny UNet's latent gradient against `jax.grad` of the JAX modules. Inputs are
made with numpy from a seed; everything runs in f32. Tests marked `cuda` hold
the backward kernels against the plain backward on a card (skipped without
one). The card's machine has no JAX, so the JAX imports are optional and only
the `cuda` tests run there."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lk,q_scale", [
    ((2, 4096, 5, 64), None, 1.0),  # the UNet's 64x64 level (CFG batch 2)
    ((1, 1000, 3, 64), None, 4.0),  # peaked scores
    ((2, 1000, 3, 64), 777, 1.0),  # ragged, Lq != Lk
    ((1, 2500, 2, 128), None, 1.0),
])
def test_backward_kernels_match_plain_on_card(cuda_device, shape, lk, q_scale):
    """dq, dk and dv of the kernels against the plain f32 backward from the
    same bf16 inputs, within 2e-2 of max|ref| (P and dS are bf16 operands)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    kv = shape if lk is None else (shape[0], lk, *shape[2:])
    q = torch.randn(shape, generator=g, device=cuda_device, dtype=torch.bfloat16) * q_scale
    k, v = (torch.randn(kv, generator=g, device=cuda_device, dtype=torch.bfloat16) for _ in range(2))
    do = torch.randn(shape, generator=g, device=cuda_device, dtype=torch.bfloat16)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    before = fa.LAUNCHES_BWD
    grads = fa.flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BWD == before + 1
    qf, kf, vf = q.float(), k.float(), v.float()
    refs = fa.flash_attention_backward_reference(
        qf, kf, vf, fa.flash_attention_reference(qf, kf, vf), fa.flash_attention_lse_reference(qf, kf), do)
    for a, r in zip(grads, refs):
        assert float((a.float() - r).abs().max() / r.abs().max()) < 2e-2


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
