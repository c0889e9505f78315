"""Parity of the port's refinement stage against voxe_tpu on the CPU, on the
Stable Diffusion side: the UNet's attention capture, the token-map
aggregation (gaussian blur, bilinear upsampling), `get_attn_map`, and one
whole shear-warp refinement iteration (RGB frame, VAE encode, capture UNet,
token targets, the two-channel attention render, masked L1 + TV, two Adam
steps) against `make_refine_iter_shearwarp`, with the JAX iteration's
`jax.random.split(key, 5)` draws replayed into the port; and SD 1.4's
published widths (CLIP ViT-L/14, a 320-channel cross-attention transformer
with 8 heads of 40) through `from_flax_params`.

The tiny SD runs at 32^2 (16^2 latents: three 16x16 cross-attention maps a
pass) in f32 on both sides with the same seeded numpy parameters; the JAX
iteration is jitted once for the module."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_recon import _capture
from tests.test_torch_sd import _numpy_params
from voxe_tpu.grid import voxels as jvox
from voxe_tpu.models.sd import cross_attn as jca
from voxe_tpu.models.sd.config import tiny_test_config as j_tiny
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.render.interface import SHVoxGridRenderConfig as JRenderConfig
from voxe_tpu.train import refine as jrefine
from voxe_tpu.utils import camera as jcam
from voxe_tpu_torch.grid import voxels as tvox
from voxe_tpu_torch.models.sd import cross_attn as tca
from voxe_tpu_torch.models.sd.config import tiny_test_config as t_tiny
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.render.interface import SHVoxGridRenderConfig as TRenderConfig
from voxe_tpu_torch.train import refine as trefine
from voxe_tpu_torch.utils import camera as tcam

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PROMPT = "a dog wearing a party hat, side view"
GRID_KW = dict(density_preactivation="identity", density_postactivation="softplus", expected_density_scale=3.0)
LR = 0.03


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def sd_pair():
    """The JAX tiny SD at 32^2 in f32 (shape-only init) and the port with
    the same seeded numpy parameters."""
    jsd = JSD(config=j_tiny(image_size=32), unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros")
    params = _numpy_params(jsd.params, seed=21)
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD(config=t_tiny(image_size=32), unet_dtype=torch.float32, device="cpu")
    tsd.load_flax_params(params)
    return jsd, tsd


def _captured(jmaps):
    """The [B, Q, K] leaves of the JAX capture collection."""
    return [leaf for leaf in jax.tree_util.tree_leaves(jmaps) if getattr(leaf, "ndim", 0) == 3]


def test_capture_unet_path(sd_pair):
    """The capture pass gives the fast path's noise prediction (the probs
    path differs only in rounding) and one head-averaged map per tagged
    cross-attention, in call order, each row a distribution. Its maps are
    held against JAX through `get_attn_map` below."""
    _, tsd = sd_pair
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 16, 16)).astype(np.float32))
    text = tsd.get_text_embeds(PROMPT)
    out, store = tsd.unet_noise_pred(lat, 300, text, capture_attn=True)
    assert _rel(out.numpy(), tsd.unet_noise_pred(lat, 300, text).numpy()) < 1e-5
    # tiny SD at 16^2 latents: down_0 (16^2), mid (8^2), up_1's two blocks (16^2)
    assert [(tag, tuple(m.shape)) for tag, m in store] == [
        ("down", (2, 256, 77)), ("mid", (2, 64, 77)), ("up", (2, 256, 77)), ("up", (2, 256, 77))
    ]
    for _, m in store:
        np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, atol=1e-5)
    agg = tca.aggregate_attention(store)
    torch.testing.assert_close(agg, torch.stack([store[i][1][1] for i in (0, 2, 3)]).mean(0).reshape(16, 16, 77))
    with pytest.raises(ValueError, match="32x32"):
        tca.aggregate_attention(store, res=32)


@pytest.mark.parametrize("hw", [(384, 384), (37, 52), (16, 16)])
def test_token_map_blur_and_resize_match_jax(hw):
    """Blur + bilinear upsampling of aggregated maps, the refinement's
    16 -> 384 and odd sizes, against jax.image.resize (f32, 1e-6)."""
    rng = np.random.default_rng(1)
    maps = rng.random((2, 3, 256, 77)).astype(np.float32)
    maps /= maps.sum(-1, keepdims=True)
    jstore = {"down": tuple(jnp.asarray(m) for m in maps)}
    tstore = [("down", torch.from_numpy(m)) for m in maps]
    j = jca.aggregate_token_maps(jstore, jnp.asarray([0, 5, 76]), orig_im_h=hw[0], orig_im_w=hw[1])
    t = tca.aggregate_token_maps(tstore, [0, 5, 76], *hw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    j_norm = jca.normalize_attn_map(j[0])
    np.testing.assert_allclose(tca.normalize_attn_map(t[0]).numpy(), np.asarray(j_norm), rtol=0, atol=1e-5)


def test_get_attn_map_matches_jax(sd_pair):
    """`get_attn_map` with t drawn (timestamp 0), the JAX draws replayed:
    VAE encode, add_noise, the capture UNet and the token maps (blur and
    upsampling to a non-square frame), to 1e-4 of their max."""
    jsd, tsd = sd_pair
    rgb = np.random.default_rng(2).random((1, 20, 28, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = [1, 2, 4, 7]
    jmaps, jt = jsd.get_attn_map(PROMPT, jnp.asarray(rgb), key, timestamp=0, indices_to_fetch=idx)
    k_t, k_run = jax.random.split(key)
    k_enc, k_noise = jax.random.split(k_run)
    eps, noise = (torch.tensor(np.asarray(jax.random.normal(k, (1, 16, 16, 4)))) for k in (k_enc, k_noise))
    assert jt == int(jsd.sample_timestep(k_t))
    tmaps = tsd.attention_maps(tsd.get_text_embeds(PROMPT), torch.from_numpy(rgb), jt, idx, noise=noise, vae_eps=eps)
    assert tmaps.shape == (4, 20, 28)
    assert _rel(tmaps.numpy(), np.stack([np.asarray(m) for m in jmaps])) < 1e-4
    gen = torch.Generator().manual_seed(0)
    maps, t = tsd.get_attn_map(PROMPT, torch.from_numpy(rgb), 0, idx, generator=gen)
    lo, hi = tsd.t_bounds()
    assert len(maps) == 4 and maps[0].shape == (20, 28) and lo <= t <= hi


def _iteration_inputs():
    rng = np.random.default_rng(4)
    res = 12
    dens = rng.uniform(-1.0, 2.0, (res, res, res, 1)).astype(np.float32)
    feats = rng.uniform(-1.0, 1.0, (res, res, res, 3)).astype(np.float32)
    attn = rng.normal(0.0, 1.0, (res, res, res, 2)).astype(np.float32)
    pose = jcam.pose_spherical(40.0, 60.0, 4.0311)
    return dens, feats, attn, pose, [3.0 / res] * 3


@pytest.fixture(scope="module")
def jax_iteration(sd_pair):
    """One JAX refinement iteration (jitted once), t drawn, fused
    compositing (the card's tail): its inputs, draws, gradients and
    outputs."""
    jsd, _ = sd_pair
    dens, feats, attn, pose, vs = _iteration_inputs()
    grid = jvox.VoxelGrid(jnp.asarray(dens), jnp.asarray(feats),
                          jvox.VoxelGridConfig(voxel_size=jvox.VoxelSize(*vs), **GRID_KW), attn=jnp.asarray(attn[..., :1]))
    cfg = JRenderConfig(num_samples_per_ray=32, camera_bounds=jcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                        use_fused_kernel=True)
    sched = optax.exponential_decay(LR, 1, 0.1, staircase=True)
    opt_e = optax.chain(_capture(), optax.adam(sched))
    opt_o = optax.chain(_capture(), optax.adam(sched))
    it = jrefine.make_refine_iter_shearwarp(jsd, cfg, opt_e, opt_o, grid, (24, 24), 0, 0.01)
    n_tok = jsd.get_num_tokens(PROMPT)
    idxs = np.zeros(8 * ((n_tok + 7) // 8), np.int32)
    idxs[:n_tok] = np.arange(1, n_tok + 1)
    emask = np.zeros_like(idxs, np.float32)
    emask[[3, 4]] = 1.0  # tokens 4 and 5
    omask = np.zeros_like(emask)
    omask[:n_tok] = 1.0 - emask[:n_tok]
    e0, o0 = jnp.asarray(attn[..., :1]), jnp.asarray(attn[..., 1:])
    key = jax.random.PRNGKey(7)
    new_e, new_o, st_e, st_o, metrics = it(
        e0, o0, opt_e.init(e0), opt_o.init(o0), jsd.params, jsd.get_text_embeds(PROMPT),
        jnp.asarray(pose.rotation), jnp.asarray(pose.translation).reshape(3, 1),
        jnp.asarray(idxs), jnp.asarray(emask), jnp.asarray(omask), key,
    )
    k_enc, k_noise, k_t, _, _ = jax.random.split(key, 5)
    draws = dict(
        vae_eps=torch.tensor(np.asarray(jax.random.normal(k_enc, (1, 16, 16, 4)))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (1, 16, 16, 4)))),
        t=int(jsd.sample_timestep(k_t)),
    )
    return dict(n_tok=n_tok, emask=emask[:n_tok], omask=omask[:n_tok], draws=draws, grads=(st_e[0], st_o[0]),
                new=(new_e, new_o), metrics=metrics)


def _check_update(t_new, t_grad, j_new, j_old, j_grad):
    """Adam's first step is ~lr * g / (|g| + eps): compare the packages'
    updates where |g| > 1e-2 of its max, bound them by 2 lr elsewhere, and
    hold the port's update to optax.adam on the port's own gradient."""
    jg, diff = np.asarray(j_grad), np.abs(t_new.detach().numpy() - np.asarray(j_new))
    clear = np.abs(jg) > 1e-2 * np.abs(jg).max()
    assert clear.mean() > 0.05
    assert diff[clear].max() < 1e-6, diff[clear].max()
    assert diff.max() <= 2 * LR + 1e-6
    adam = optax.adam(LR)
    upd, _ = adam.update(jnp.asarray(t_grad.numpy()), adam.init(jnp.asarray(j_old)))
    np.testing.assert_allclose(t_new.detach().numpy(), np.asarray(j_old) + np.asarray(upd), rtol=0, atol=1e-6)


def test_refine_iteration_matches_jax(sd_pair, jax_iteration):
    """One whole iteration: the losses (1e-5 relative), both attention
    gradients (1e-4 of their max) and both Adam updates."""
    _, tsd = sd_pair
    ref = jax_iteration
    dens, feats, attn, pose, vs = _iteration_inputs()
    grid = tvox.VoxelGrid(torch.from_numpy(dens), torch.from_numpy(feats),
                          tvox.VoxelGridConfig(voxel_size=tvox.VoxelSize(*vs), **GRID_KW))
    cfg = TRenderConfig(num_samples_per_ray=32, camera_bounds=tcam.CameraBounds(2.0, 6.0), white_bkgd=True,
                        use_fused_kernel=True)
    e, o = torch.tensor(attn[..., :1]), torch.tensor(attn[..., 1:])
    opt_e, opt_o = trefine.make_attn_adam(e, LR), trefine.make_attn_adam(o, LR)
    sched = trefine.exponential_decay_staircase(LR, 1, 0.1)
    it = trefine.make_refine_iter_shearwarp(tsd, cfg, opt_e, opt_o, grid, (24, 24), 0, 0.01, sched)
    idxs, emask, omask = trefine.token_selection(ref["n_tok"], [4, 5], None)
    np.testing.assert_array_equal(emask.numpy(), ref["emask"])
    np.testing.assert_array_equal(omask.numpy(), ref["omask"])
    m = it(e, o, tsd.get_text_embeds(PROMPT), torch.from_numpy(pose.rotation.astype(np.float32)),
           torch.from_numpy(pose.translation.astype(np.float32)), idxs, emask, omask, **ref["draws"])
    assert m["t"] == ref["draws"]["t"]
    for name in ("attn_loss_edit", "tv_loss_edit", "attn_loss_object", "tv_loss_object"):
        np.testing.assert_allclose(float(m[name]), float(ref["metrics"][name]), rtol=1e-5, atol=1e-7)
    for t_new, opt, j_grad, j_new, j_old in zip((e, o), (opt_e, opt_o), ref["grads"], ref["new"],
                                                 (attn[..., :1], attn[..., 1:])):
        assert _rel(t_new.grad.numpy(), j_grad) < 1e-4, _rel(t_new.grad.numpy(), j_grad)
        _check_update(t_new, t_new.grad, j_new, j_old, j_grad)


def test_select_targets_without_object_tokens():
    """An empty object mask gives a zero object target; the edit target is
    the max over the selected maps."""
    maps = torch.rand(3, 5, 6)
    e, o = trefine.select_targets(maps, torch.tensor([1.0, 0.0, 1.0]), torch.zeros(3))
    torch.testing.assert_close(e, torch.maximum(maps[0], maps[2]), rtol=0, atol=0)
    assert float(o.abs().max()) == 0.0
    _, emask, omask = trefine.token_selection(4, [2], 3)
    assert emask.tolist() == [0, 1, 0, 0] and omask.tolist() == [0, 0, 1, 0]


def test_sd14_widths_through_from_flax_params():
    """SD 1.4's published widths, held numerically through `from_flax_params`
    (f32): the CLIP ViT-L/14 text tower (768 wide, 12 heads, quick-GELU,
    49,408 tokens; depth cut to 2 of its 12 layers) and a 64x64-level
    cross-attention transformer of the UNet (320 channels, 8 heads of 40,
    context 768) with its capture on, against the JAX modules."""
    import dataclasses

    from voxe_tpu.models.sd import clip_text as jclip
    from voxe_tpu.models.sd import unet as junet
    from voxe_tpu.models.sd.config import SD_VERSIONS as J_VERSIONS
    from voxe_tpu_torch.models.sd import clip_text as tclip
    from voxe_tpu_torch.models.sd import unet as tunet
    from voxe_tpu_torch.models.sd.config import SD_VERSIONS as T_VERSIONS
    from voxe_tpu_torch.models.sd.weights import from_flax_params

    rng = np.random.default_rng(12)
    jcfg = dataclasses.replace(J_VERSIONS["1.4"].clip, num_hidden_layers=2)
    tcfg = dataclasses.replace(T_VERSIONS["1.4"].clip, num_hidden_layers=2)
    assert (tcfg.hidden_size, tcfg.num_attention_heads, tcfg.hidden_act, tcfg.vocab_size) == (768, 12, "quick_gelu", 49408)
    ids = rng.integers(0, 49408, (2, 77))
    jm = jclip.CLIPTextModel(jcfg)
    params = _numpy_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))["params"], seed=13)
    je = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(ids))
    tm = tclip.CLIPTextModel(tcfg)
    tm.load_state_dict(from_flax_params(params), strict=True)
    with torch.no_grad():
        te = tm(torch.from_numpy(ids))
    assert _rel(te.numpy(), je) < 1e-4

    ucfg = T_VERSIONS["1.4"].unet
    ch, heads, ctx = ucfg.block_out_channels[0], ucfg.attention_head_dim[0], ucfg.cross_attention_dim
    assert (ch, heads, ctx) == (320, 8, 768)
    x = rng.standard_normal((2, 8, 8, ch)).astype(np.float32)
    c = rng.standard_normal((2, 77, ctx)).astype(np.float32)
    jt = junet.Transformer2D(heads, 32, capture="down")
    tparams = _numpy_params(jax.eval_shape(lambda: jt.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c)))["params"], seed=14)
    jout, jstate = jax.jit(lambda p, a, b: jt.apply({"params": p}, a, b, capture_attn=True, mutable=["attn_maps"]))(
        tparams, jnp.asarray(x), jnp.asarray(c))
    tt = tunet.Transformer2D(ch, ctx, heads, 32, capture="down")
    tt.load_state_dict(from_flax_params(tparams), strict=True)
    store = []
    with torch.no_grad():
        tout = tt(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(c), store)
    assert _rel(tout.permute(0, 2, 3, 1).numpy(), jout) < 1e-4
    (jmap,) = _captured(jstate)
    assert len(store) == 1 and _rel(store[0][1].numpy(), jmap) < 1e-4
