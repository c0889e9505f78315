"""Parity of the PyTorch port's Stable Diffusion stack against voxe_tpu on
the CPU, at the tiny test config with parameters carried across by
`from_flax_params`. Both sides run in f32 so the comparison is of the
algorithm; random draws are made on the JAX side and replayed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxe_tpu.models.sd.norms import ReduceFirstGroupNorm
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.models.sd.tokenizer import HashTokenizer as JTok
from voxe_tpu.models.sd.tokenizer import get_num_tokens as j_num_tokens
from voxe_tpu.models.sd.unet import timestep_embedding as j_temb
from voxe_tpu_torch.models.sd import config as tconfig
from voxe_tpu_torch.models.sd.norms import GroupNorm
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.sd.tokenizer import HashTokenizer as TTok
from voxe_tpu_torch.models.sd.tokenizer import get_num_tokens as t_num_tokens
from voxe_tpu_torch.models.sd.unet import timestep_embedding as t_temb
from voxe_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _nchw(x):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _numpy_params(shapes, seed=0):
    """Seeded numpy parameters for a flax tree: kernels ~ N(0, 1/fan_in),
    norm scales near 1, small biases and embeddings."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "embedding":
            return 0.5 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny SD in f32 and the port with the same parameters. The
    JAX side is built shape-only (zeros init) and both get numpy params."""
    jsd = JSD("tiny", unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD("tiny", unet_dtype=torch.float32, device="cpu", seed=1)
    tsd.load_flax_params(params)
    return jsd, tsd


@pytest.mark.parametrize("shape,groups,eps", [((2, 6, 5, 16), 4, 1e-5), ((1, 8, 8, 32), 8, 1e-6)])
def test_group_norm_matches_reduce_first(shape, groups, eps):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = ReduceFirstGroupNorm(num_groups=groups, epsilon=eps).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x)
    )
    gn = GroupNorm(groups, shape[-1], eps)
    gn.weight.data = torch.from_numpy(scale)
    gn.bias.data = torch.from_numpy(bias)
    out = _nhwc(gn(_nchw(x)))
    # same E[x^2]-E[x]^2 f32 formula, other summation order
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "shape,lk",
    [
        ((2, 64, 2, 64), None),
        ((1, 48, 3, 128), None),
        ((2, 37, 3, 64), None),  # B = 2 with a ragged length, as on the card
        ((2, 40, 2, 64), 131),  # Lq != Lk
    ],
)
def test_flash_reference_matches_jax_sdpa(shape, lk):
    rng = np.random.default_rng(1)
    kv_shape = shape if lk is None else (shape[0], lk, *shape[2:])
    q = rng.standard_normal(shape).astype(np.float32)
    k, v = (rng.standard_normal(kv_shape).astype(np.float32) for _ in range(2))
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    # the wrapper on a CPU tensor is the plain version (and counts nothing)
    out = flash_attention(tq, tk, tv).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out, flash_attention_reference(tq, tk, tv).numpy())


def _no_plain_attention(*args, **kwargs):
    raise AssertionError("the plain attention was reached")


@pytest.mark.parametrize(
    "q_len,kv_len,heads,head_dim",
    [
        (1024, None, 10, 64),  # SD 2.x's 32x32 self-attention: below the flash gate
        (1024, 77, 10, 64),  # its cross-attention over the 77 text tokens
        (1024, None, 8, 40),  # SD 1.x's head_dim 40 (its 64x64 level has 4096 queries)
    ],
)
def test_unet_attention_sdpa_route_matches_jax(q_len, kv_len, heads, head_dim, monkeypatch):
    """A UNet CrossAttention that the flash gate does not admit goes to the
    library's SDPA, as the JAX package's goes to
    `jax.nn.dot_product_attention`: the module with the same parameters, in
    f32, within 1e-5 of the JAX module; the plain version is not reached."""
    from voxe_tpu.models.sd import unet as junet
    from voxe_tpu_torch.models.sd import unet as tunet
    from voxe_tpu_torch.models.sd.weights import from_flax_params
    from voxe_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention_reference", _no_plain_attention)
    rng = np.random.default_rng(7)
    width = heads * head_dim
    x = rng.standard_normal((2, q_len, width)).astype(np.float32)
    ctx = None if kv_len is None else rng.standard_normal((2, kv_len, 96)).astype(np.float32)
    jm = junet.CrossAttention(heads)
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    params = _numpy_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"], seed=8)
    ref = jax.jit(lambda prm, *a: jm.apply({"params": prm}, *a))(params, *args)
    tm = tunet.CrossAttention(width, width if ctx is None else 96, heads)
    tm.load_state_dict(from_flax_params(params), strict=True)
    assert not tunet.flash_self_attention_enabled(q_len, head_dim)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_tokenizer_and_schedule_copies():
    jt, tt = JTok(1024), TTok(1024)
    for prompt in ("a dog made of yarn, side view", "", "  Two   words "):
        np.testing.assert_array_equal(jt(prompt), tt(prompt))
        assert j_num_tokens(jt, prompt) == t_num_tokens(tt, prompt)
    assert tconfig.SD_VERSIONS["2.0"].unet.block_out_channels == (320, 640, 1280, 1280)
    t = np.array([0.0, 17.0, 999.0], np.float32)
    # f32 rounding of the angle t * freq is ~6e-5 at t = 999
    np.testing.assert_allclose(
        t_temb(torch.from_numpy(t), 320).numpy(), np.asarray(j_temb(jnp.asarray(t), 320)),
        rtol=2e-4, atol=2e-4,
    )


def test_scheduler_matches(pair):
    jsd, tsd = pair
    np.testing.assert_allclose(
        tsd.alphas.numpy(), np.asarray(jsd.scheduler.alphas_cumprod), rtol=1e-6
    )
    rng = np.random.default_rng(2)
    x, n = rng.standard_normal((2, 1, 4, 4, 4)).astype(np.float32)
    ref = jsd.scheduler.add_noise(jnp.asarray(x), jnp.asarray(n), 417)
    out = tsd.scheduler.add_noise(torch.from_numpy(x), torch.from_numpy(n), 417)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_clip_matches(pair):
    jsd, tsd = pair
    for prompt in ("a dog made of yarn, front view", "a cat"):
        ref = np.asarray(jsd.get_text_embeds(prompt))
        out = tsd.get_text_embeds(prompt).numpy()
        # f32 transformer, other matmul order: float rounding
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_vae_encode_and_decode_match(pair):
    jsd, tsd = pair
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jsd.vae.apply({"params": jsd.params["vae"]}, jnp.asarray(img), key, method=jsd.vae.encode)
    mean, _ = jsd.vae.apply({"params": jsd.params["vae"]}, jnp.asarray(img), method=jsd.vae.encode_moments)
    eps = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))  # vae.py:146-148
    out = tsd.vae.encode(_nchw(img), _nchw(eps))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-4)
    dec_ref = jsd.vae.apply({"params": jsd.params["vae"]}, ref, method=jsd.vae.decode)
    dec = tsd.vae.decode(out)
    np.testing.assert_allclose(_nhwc(dec), np.asarray(dec_ref), rtol=1e-3, atol=1e-3)


def test_unet_matches(pair, monkeypatch):
    """The tiny UNet's forward against JAX, with `flash_attention_reference`
    patched to raise: every attention reaches the library's SDPA (or, on a
    card, the flash kernel)."""
    from voxe_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention_reference", _no_plain_attention)
    jsd, tsd = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ref = jsd.unet.apply({"params": jsd.params["unet"]}, jnp.asarray(x), jnp.asarray(321), jnp.asarray(ctx))
    out = tsd.unet(_nchw(x), torch.tensor(321), torch.from_numpy(ctx))
    assert _rel_err(_nhwc(out), ref) < 1e-4


@pytest.mark.parametrize("base", [48, 80])
def test_sds_loss_gradient_matches(pair, base):
    """Gradient of sds_loss w.r.t. the image with the JAX key's draws
    replayed. base 80 > image_size 64 exercises the antialiased shrink."""
    jsd, tsd = pair
    rng = np.random.default_rng(base)
    img = rng.uniform(0, 1, (1, base, base, 3)).astype(np.float32)
    text = jsd.get_text_embeds("a dog made of yarn, side view")
    key, t, gs = jax.random.PRNGKey(11), 600, 100.0

    jgrad = jax.grad(lambda im: jsd.sds_loss(jsd.params, text, im, key, jnp.asarray(t), gs))(jnp.asarray(img))
    k_enc, k_noise = jax.random.split(key)  # sds.py:242-251
    lat_shape = (1, 32, 32, 4)
    vae_eps = np.asarray(jax.random.normal(k_enc, lat_shape, jnp.float32))
    noise = np.asarray(jax.random.normal(k_noise, lat_shape, jnp.float32))

    timg = torch.from_numpy(img).requires_grad_(True)
    loss = tsd.sds_loss(
        torch.from_numpy(np.asarray(text)), timg, t, gs,
        noise=torch.from_numpy(noise), vae_eps=torch.from_numpy(vae_eps),
    )
    assert float(loss.detach()) == 0.0
    loss.backward()
    # guidance 100 scales UNet rounding differences by ~100: 1e-3 of the max
    assert _rel_err(timg.grad.numpy(), jgrad) < 1e-3


@pytest.mark.parametrize("src", [80, 48])
def test_bilinear_resize_matches_jax(src):
    """jax.image.resize "bilinear" antialiases a shrink; F.interpolate
    matches it with antialias=True (80 -> 64 shrinks, 48 -> 64 grows)."""
    import torch.nn.functional as F

    img = np.random.default_rng(src).uniform(0, 1, (1, src, src, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (1, 64, 64, 3), method="bilinear")
    out = F.interpolate(_nchw(img), size=(64, 64), mode="bilinear", antialias=True, align_corners=False)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
