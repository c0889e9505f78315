"""Parity of the port's text-to-image sampling against voxe_tpu on the CPU:
the DDIM schedule and step, `produce_latents`, `decode_latents`,
`prompt_to_img`, the reference-shaped `training_step`, and the validate CLI
at the tiny size. Both packages run the tiny SD in f32 with the same numpy
parameters; JAX's random draws are replayed into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_sd import _numpy_params
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.models.sd.sds import scoreDistillationLoss as JSDS
from voxe_tpu_torch.cli import validate_sd_weights
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.sd.sds import scoreDistillationLoss as TSDS

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

LATENT = (1, 32, 32, 4)  # the tiny SD: 64^2 images, VAE factor 2


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    jsd = JSD("tiny", unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=31)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD("tiny", unet_dtype=torch.float32, device="cpu", seed=1)
    tsd.load_flax_params(params)
    return jsd, tsd


@pytest.mark.parametrize("n", [50, 3, 7, 1000])
def test_timesteps_match(pair, n):
    jsd, tsd = pair
    ts = tsd.scheduler.timesteps(n)
    assert ts.dtype == torch.int64
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jsd.scheduler.timesteps(n)).astype(np.int64))
    if n == 50:
        assert ts[0] == 981 and ts[-1] == 1


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("t,t_prev", [(981, 961), (501, 481), (21, 1), (1, -1)])
def test_ddim_step_matches(pair, eta, t, t_prev):
    """One DDIM update, deterministic and with JAX's sigma_t noise passed
    in: within 1e-5 of max|ref|."""
    jsd, tsd = pair
    rng = np.random.default_rng(t)
    lat, eps = (rng.standard_normal(LATENT).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t + 1)
    ref = jsd.scheduler.step(jnp.asarray(eps), t, t_prev, jnp.asarray(lat), eta=eta, key=key)
    noise = np.array(jax.random.normal(key, LATENT, jnp.float32))  # scheduler.py:57
    out = tsd.scheduler.step(
        torch.from_numpy(eps), t, t_prev, torch.from_numpy(lat), eta=eta,
        noise=torch.from_numpy(noise) if eta > 0 else None,
    )
    assert _rel_err(out.numpy(), ref) < 1e-5


def test_stochastic_step_needs_a_draw(pair):
    _, tsd = pair
    x = torch.zeros(LATENT)
    with pytest.raises(ValueError):
        tsd.scheduler.step(x, 501, 481, x, eta=0.5)
    gen = torch.Generator().manual_seed(0)
    a = tsd.scheduler.step(x, 501, 481, x, eta=0.5, generator=gen)
    assert a.abs().max() > 0  # the sigma_t noise came from the generator


@pytest.fixture(scope="module")
def sampled(pair):
    """Three CFG DDIM steps at guidance 7.5 in both packages, the port
    starting from JAX's draw."""
    jsd, tsd = pair
    prompt = "a photograph of an astronaut riding a horse"
    key = jax.random.PRNGKey(4)
    ref = jsd.produce_latents(jsd.get_text_embeds(prompt, ""), key, num_inference_steps=3, guidance_scale=7.5)
    start = np.array(jax.random.normal(key, LATENT))  # sds.py:310-318
    out = tsd.produce_latents(
        tsd.get_text_embeds(prompt, ""), num_inference_steps=3, guidance_scale=7.5, latents=torch.from_numpy(start)
    )
    return np.asarray(ref), out


def test_produce_latents_matches(sampled):
    ref, out = sampled
    assert out.shape == (1, 4, 32, 32) and out.dtype == torch.float32
    assert np.isfinite(ref).all()
    assert _rel_err(_nhwc(out), ref) < 1e-4


def test_decode_latents_matches(pair, sampled):
    jsd, tsd = pair
    ref_lat, _ = sampled
    ref = jsd.decode_latents(jsd.params["vae"], jnp.asarray(ref_lat))
    out = tsd.decode_latents(torch.from_numpy(ref_lat.copy()).permute(0, 3, 1, 2))
    assert out.shape == (1, 3, 64, 64) and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=0, atol=1e-5)


def test_prompt_to_img_matches(pair):
    """uint8 images from replayed latents differ by at most 1 on any pixel."""
    jsd, tsd = pair
    ref = jsd.prompt_to_img("a red cube", key=jax.random.PRNGKey(0), num_inference_steps=2)
    start = np.array(jax.random.normal(jax.random.PRNGKey(0), LATENT))
    out = tsd.prompt_to_img("a red cube", num_inference_steps=2, latents=torch.from_numpy(start))
    assert out.dtype == np.uint8 and out.shape == ref.shape == (1, 64, 64, 3)
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_training_step_matches(pair):
    """The directional host API over two directions, JAX's t and draws
    replayed: the gradient w.r.t. the rendered colours."""
    jsd, tsd = pair
    jsds = JSDS("a yarn doll", sd_model=jsd, directional=True)
    tsds = TSDS("a yarn doll", sd_model=tsd, directional=True)
    assert tsds.get_current_max_step_ratio() == jsds.get_current_max_step_ratio() == 0.98
    rng = np.random.default_rng(8)
    out = rng.uniform(0, 1, (48 * 48, 3)).astype(np.float32)
    directions, key = ["front", "side"], jax.random.PRNGKey(9)
    jgrad = jax.jit(jax.grad(lambda o: jsds.training_step(o, 48, 48, directions=directions, key=key)))(
        jnp.asarray(out)
    )

    draws = []
    for _ in directions:  # sds.py:491-507, 282-296, 242-251
        key, sub = jax.random.split(key)
        k_t, k_loss = jax.random.split(sub)
        k_enc, k_noise = jax.random.split(k_loss)
        draws.append({
            "t": int(jsd.sample_timestep(k_t)),
            "vae_eps": torch.from_numpy(np.array(jax.random.normal(k_enc, LATENT))),
            "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, LATENT))),
        })
    assert draws[0]["t"] != draws[1]["t"]
    tout = torch.from_numpy(out).requires_grad_(True)
    loss = tsds.training_step(tout, 48, 48, directions=directions, draws=draws)
    assert float(loss.detach()) == 0.0
    loss.backward()
    assert _rel_err(tout.grad.numpy(), jgrad) < 1e-5


def test_validate_cli_writes_the_sanity_png(tmp_path):
    png = tmp_path / "out" / "sanity.png"
    img = validate_sd_weights.main(
        ["--sd_version", "tiny", "--device", "cpu", "--sanity_image", str(png), "--sanity_steps", "2"]
    )
    read = np.asarray(Image.open(png))
    assert read.shape == (64, 64, 3) and read.dtype == np.uint8
    np.testing.assert_array_equal(read, img)


def test_validate_cli_flags():
    p = validate_sd_weights.build_parser()
    c = p.parse_args([])
    assert (c.device, c.sd_version, c.run_smoke, c.sanity_steps, c.weights_dir) == ("cuda", "2.0", True, 50, None)
    assert c.sanity_prompt == "a photograph of an astronaut riding a horse"
    with pytest.raises(SystemExit):  # a real version needs a snapshot
        validate_sd_weights.main(["--sd_version", "2.0", "--device", "cpu"])
