"""Parity of the port's real-weight route against voxe_tpu on the CPU: the
BPE tokenizer, the safetensors reader, HF snapshots loaded by both packages
(tiny SD in f32), the HF name map at SD 2.0 and 1.4 published widths (meta
device against jax.eval_shape: no weights are built), the t schedule and the
directional text encodings."""
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sd_weights import _synthesize_hf_dict
from tests.test_torch_sd import _numpy_params
from voxe_tpu.models.sd import weights as jw
from voxe_tpu.models.sd.clip_text import CLIPTextModel as JCLIP
from voxe_tpu.models.sd.config import SD_VERSIONS as J_VERSIONS
from voxe_tpu.models.sd.sds import StableDiffusion as JSD
from voxe_tpu.models.sd.sds import scoreDistillationLoss as JSDL
from voxe_tpu.models.sd.tokenizer import CLIPTokenizer as JTok
from voxe_tpu.models.sd.tokenizer import _bytes_to_unicode
from voxe_tpu.models.sd.unet import UNet2DConditionModel as JUNet
from voxe_tpu.models.sd.vae import AutoencoderKL as JVAE
from voxe_tpu_torch.models.sd import weights as tw
from voxe_tpu_torch.models.sd.config import SD_VERSIONS as T_VERSIONS
from voxe_tpu_torch.models.sd.config import tiny_test_config
from voxe_tpu_torch.models.sd.sds import DIRECTION_PROMPTS
from voxe_tpu_torch.models.sd.sds import StableDiffusion as TSD
from voxe_tpu_torch.models.sd.sds import scoreDistillationLoss as TSDL
from voxe_tpu_torch.models.sd.tokenizer import CLIPTokenizer as TTok

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PROMPTS = [
    "a dog wearing a hat", "The dog's HAT!!", "café, 2 dogs & a cat", "", "  the   hat  ",
    "a dog " * 60,  # truncated to 75 tokens
]
MERGES = ["d o", "do g</w>", "h a", "ha t</w>", "t h", "th e</w>", "a </w>", "c a", "ca t</w>", "' s</w>"]


def _write_vocab(out_dir, merges=(), pad_token=None, gz=False):
    """A byte-level BPE vocab: every byte token, with and without </w>,
    each merge's product, then the specials."""
    out_dir.mkdir(parents=True, exist_ok=True)
    vocab = {}
    for tok in _bytes_to_unicode().values():
        vocab[tok] = len(vocab)
    for tok in _bytes_to_unicode().values():
        vocab[tok + "</w>"] = len(vocab)
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (out_dir / "vocab.json").write_text(json.dumps(vocab))
    text = "#version: 0.2\n" + "\n".join(merges) + "\n"
    if gz:
        with gzip.open(out_dir / "bpe_simple_vocab_16e6.txt.gz", "wb") as f:
            f.write(text.encode())
    else:
        (out_dir / "merges.txt").write_text(text)
    if pad_token is not None:
        (out_dir / "special_tokens_map.json").write_text(json.dumps({"pad_token": {"content": pad_token}}))
    return out_dir


@pytest.mark.parametrize("pad_token,gz", [(None, False), ("!", False), (None, True)])
def test_bpe_tokenizer_matches_jax(tmp_path, pad_token, gz):
    """Ids must be equal: real merges, EOS padding (SD 1.x), the "!" pad of
    SD 2.x (id 0), OpenAI's gzipped merges."""
    d = _write_vocab(tmp_path / "tok", MERGES, pad_token, gz)
    jt, tt = JTok(d), TTok(d)
    for prompt in PROMPTS:
        np.testing.assert_array_equal(tt(prompt), jt(prompt))
    np.testing.assert_array_equal(tt(PROMPTS), jt(PROMPTS))
    assert (tt.bos_token_id, tt.eos_token_id, tt.pad_token_id) == (jt.bos_token_id, jt.eos_token_id, jt.pad_token_id)
    assert tt.pad_token_id == (0 if pad_token == "!" else tt.eos_token_id)
    assert len(tt.encode("dog")) == 1  # the merges ran: "d o" then "do g</w>"


def test_safetensors_reader_and_bin_route(tmp_path):
    """F32 and F16 against safetensors.numpy, BF16 against safetensors.torch
    (numpy has no bf16), a .bin through torch.load; bitwise."""
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as t_load
    from safetensors.torch import save_file as t_save

    rng = np.random.default_rng(0)
    arrays = {
        "a.weight": rng.standard_normal((5, 3, 2, 2)).astype(np.float32),
        "b.bias": rng.standard_normal((7,)).astype(np.float16),
        "c.scalar": np.array(2.5, np.float32),
        "d.empty": np.zeros((0, 4), np.float32),
    }
    (tmp_path / "np").mkdir()
    np_save(arrays, str(tmp_path / "np" / "model.safetensors"))
    got = tw.load_tensor_files(tmp_path / "np")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == torch.from_numpy(v).dtype and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)

    bf = {"e": torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32)).to(torch.bfloat16)}
    t_save(bf, str(tmp_path / "bf16.safetensors"))
    got = tw.read_safetensors(tmp_path / "bf16.safetensors")
    assert got["e"].dtype == torch.bfloat16
    assert torch.equal(got["e"], t_load(str(tmp_path / "bf16.safetensors"))["e"])

    (tmp_path / "bin").mkdir()
    torch.save({"x": torch.arange(6.0).reshape(2, 3)}, tmp_path / "bin" / "pytorch_model.bin")
    assert torch.equal(tw.load_tensor_files(tmp_path / "bin")["x"], torch.arange(6.0).reshape(2, 3))

    t_save({"i": torch.arange(3)}, str(tmp_path / "int.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        tw.read_safetensors(tmp_path / "int.safetensors")
    with pytest.raises(FileNotFoundError):
        tw.load_tensor_files(tmp_path / "missing")


def _write_snapshot(root, params, linear_projection=False):
    """An HF snapshot of the JAX trees through the JAX converter's own
    inverse name map; SD 2.x stores proj_in / proj_out as linears."""
    from safetensors.numpy import save_file

    for name, fn, sub in (("clip", jw.clip_name_fn, "text_encoder"), ("vae", jw.vae_name_fn, "vae"),
                          ("unet", jw.unet_name_fn, "unet")):
        hf = _synthesize_hf_dict(jax.tree_util.tree_map(np.asarray, params[name]), fn, {})
        if linear_projection:
            hf = {k: (v[:, :, 0, 0] if (".proj_in." in k or ".proj_out." in k) and v.ndim == 4 else v)
                  for k, v in hf.items()}
        (root / sub).mkdir(parents=True)
        save_file({k: np.ascontiguousarray(v, np.float32) for k, v in hf.items()}, str(root / sub / "model.safetensors"))
    _write_vocab(root / "tokenizer", MERGES, pad_token="!")
    return root


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny SD in f32 (shape-only init), seeded numpy parameters for
    it, and its CLIP / VAE-encode / UNet calls jitted."""
    jsd = JSD("tiny", unet_dtype=jnp.float32, vae_dtype=jnp.float32, init_mode="zeros",
              t_sched_start=4000, t_sched_freq=600, t_sched_gamma=0.75)
    params = _numpy_params(jsd.params, seed=4)
    calls = dict(
        clip=jax.jit(lambda p, ids: jsd.clip.apply({"params": p}, ids)),
        vae=jax.jit(lambda p, x: jsd.encode_imgs(p, x, key=None)),
        unet=jax.jit(lambda p, x, c: jsd.unet_noise_pred(p, x, jnp.asarray(500), c)),
    )
    return jsd, params, calls


@pytest.mark.parametrize("linear_projection", [False, True])
def test_snapshot_loads_in_both_packages(tmp_path, jax_tiny, linear_projection):
    """The same tiny snapshot through both converters (the JAX package's
    `convert_params` on its tree, the port's `StableDiffusion(weights_dir=)`)
    and both BPE tokenizers: CLIP embeddings, the VAE encoder's mean latents
    and the UNet noise prediction, all f32."""
    jsd, params, calls = jax_tiny
    root = _write_snapshot(tmp_path / "snap", params, linear_projection)
    jp = {
        name: jw.convert_params(params[name], jw._load_tensor_files(root / sub), fn)
        for name, fn, sub in (("clip", jw.clip_name_fn, "text_encoder"), ("vae", jw.vae_name_fn, "vae"),
                              ("unet", jw.unet_name_fn, "unet"))
    }
    tsd = TSD(config=tiny_test_config(), weights_dir=root, unet_dtype=torch.float32, device="cpu")
    assert isinstance(tsd.tokenizer, TTok) and tsd.tokenizer.pad_token_id == 0

    prompt = "a dog wearing a hat"
    jtok = JTok(root / "tokenizer")
    np.testing.assert_array_equal(tsd.tokenizer(prompt), jtok(prompt))
    je = np.asarray(calls["clip"](jp["clip"], jnp.asarray(np.concatenate([jtok(""), jtok(prompt)]))))
    te = tsd.get_text_embeds(prompt, "").numpy()
    assert np.abs(te - je).max() <= 1e-4 * np.abs(je).max()  # f32, two summation orders

    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jl = np.asarray(calls["vae"](jp["vae"], jnp.asarray(img)))
    tl_ = tsd.encode_imgs(torch.from_numpy(img).permute(0, 3, 1, 2), None).permute(0, 2, 3, 1).numpy()
    assert np.abs(tl_ - jl).max() <= 1e-4 * np.abs(jl).max()

    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    jn = np.asarray(calls["unet"](jp["unet"], jnp.asarray(lat), jnp.asarray(je)))
    tn = tsd.unet_noise_pred(torch.from_numpy(lat).permute(0, 3, 1, 2), 500, torch.from_numpy(te))
    assert np.abs(tn.permute(0, 2, 3, 1).numpy() - jn).max() <= 1e-4 * np.abs(jn).max()


def _jax_shapes_by_hf_name(cfg):
    key = jax.random.PRNGKey(0)
    lat = cfg.latent_size
    trees = {
        "clip": (jax.eval_shape(lambda: JCLIP(cfg.clip).init(key, jnp.zeros((1, 77), jnp.int32))), jw.clip_name_fn),
        "vae": (jax.eval_shape(lambda: JVAE(cfg.vae).init(key, jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))),
                jw.vae_name_fn),
        "unet": (jax.eval_shape(lambda: JUNet(cfg.unet).init(
            key, jnp.zeros((1, lat, lat, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, cfg.unet.cross_attention_dim)))),
            jw.unet_name_fn),
    }
    out = {}
    for name, (tree, fn) in trees.items():
        names = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree["params"]):
            p = "/".join(k.key for k in path)
            (first, *_), kind = fn(p)
            shape = tuple(leaf.shape)
            if p.endswith("kernel"):  # flax layout -> torch layout
                shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
            names[first] = shape
        out[name] = names
    return out


@pytest.mark.parametrize("version", ["2.0", "1.4"])
def test_name_map_at_published_widths(version):
    """Every port key maps to the HF name and shape of the JAX converter's
    leaf, and no two keys share a name."""
    jax_names = _jax_shapes_by_hf_name(J_VERSIONS[version])
    modules = tw.build_sd_modules(T_VERSIONS[version], device="meta")
    for name, module in modules.items():
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        port = {}
        for key, (candidates, _) in tw.hf_names(module, tw.NAME_FNS[name]).items():
            assert candidates[0] not in port, f"{name}: {key} and another key share {candidates[0]}"
            port[candidates[0]] = shapes[key]
        assert port == jax_names[name], name


@pytest.fixture(scope="module")
def sd_pair(jax_tiny):
    jsd, params, _ = jax_tiny
    jsd.params = jax.tree_util.tree_map(jnp.asarray, params)
    tsd = TSD("tiny", unet_dtype=torch.float32, device="cpu", t_sched_start=4000, t_sched_freq=600, t_sched_gamma=0.75)
    tsd.load_flax_params(params)
    return jsd, tsd


def test_t_schedule_matches_jax(sd_pair):
    """The CLI's schedule (start 4000, every 600, gamma 0.75) over steps
    0-6000: the same max ratio and the same integer bounds at every step;
    sampled t stays inside them."""
    jsd, tsd = sd_pair
    gen = torch.Generator().manual_seed(0)
    for step in range(0, 6001):
        jsd.update_t_schedule(step)
        tsd.update_t_schedule(step)
        assert tsd.get_max_step_ratio() == jsd.get_max_step_ratio()
        if step % 500 == 0:
            lo, hi = tsd.t_bounds()
            assert (lo, hi) == (int(1000 * jsd.min_step_ratio), int(1000 * jsd.max_step_ratio))
            assert lo <= tsd.sample_timestep(gen) <= hi
    assert tsd.get_max_step_ratio() == pytest.approx(0.98 * 0.75**4)
    for _ in range(200):  # the annealing floor
        tsd.update_t_schedule(6000)
    assert tsd.get_max_step_ratio() == 0.22


def test_directional_encodings_match_jax(sd_pair):
    jsd, tsd = sd_pair
    prompt = "a dog wearing a hat"
    jl, tl_ = JSDL(prompt, sd_model=jsd), TSDL(prompt, sd_model=tsd)
    for d in DIRECTION_PROMPTS:
        j, t = np.asarray(jl.encoding_for_direction(d)), tl_.encoding_for_direction(d).numpy()
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()  # f32 CLIP, two summation orders
    stacked = tl_.stacked_encodings()
    assert stacked.shape == (4, 2, 77, 32) and torch.equal(stacked[1], tl_.encoding_for_direction("overhead"))
    jn, tn = JSDL(prompt, sd_model=jsd, directional=False), TSDL(prompt, sd_model=tsd, directional=False)
    j, t = np.asarray(jn.encoding_for_direction(None)), tn.encoding_for_direction(None).numpy()
    assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()
