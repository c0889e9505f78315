"""Parity of the port's prompt-to-prompt machinery against voxe_tpu on the
CPU: the UNet's `attn_edit_fn` hook, the sequence aligner's mappers, and
the attention controllers (Store, Replace, Refine, Reweight, LocalBlend).
The UNet pair is the tiny config's in f32 with the same numpy parameters;
the aligner runs on both packages' hash tokenizers and on a small
byte-level BPE vocab in which some words split into several tokens."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sd import _numpy_params
from voxe_tpu.models.sd import controllers as jctl
from voxe_tpu.models.sd import seq_aligner as jsa
from voxe_tpu.models.sd import tokenizer as jtok
from voxe_tpu.models.sd import unet as junet
from voxe_tpu.models.sd.config import tiny_test_config as j_tiny
from voxe_tpu_torch.models.sd import controllers as tctl
from voxe_tpu_torch.models.sd import seq_aligner as tsa
from voxe_tpu_torch.models.sd import tokenizer as ttok
from voxe_tpu_torch.models.sd import unet as tunet
from voxe_tpu_torch.models.sd.config import tiny_test_config as t_tiny
from voxe_tpu_torch.models.sd.weights import from_flax_params

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

REFINE_PAIRS = [
    ("a dog", "a fluffy dog"),  # insertion
    ("a cat sitting on a red mat", "a black cat on a mat"),  # insertion and deletion
    ("fluffy dog wearing a hat", "dog"),  # the target shorter than the source
    ("a photo of a dog", "a watercolor painting of a dog wearing a hat"),
]
REPLACE_PAIRS = [
    ("a red dog", "a blue dog"),
    ("a cat on a mat", "a squirrel on a mat"),  # one token against several (BPE)
    ("a dog wearing a hat", "a cat wearing a crown"),  # two words replaced
    ("dog", "cat"),
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _write_bpe_vocab(root):
    """Byte-level vocab with a few merges: "dog", "cat", "hat", "red" and
    "a" are one token each, every other word one token per character."""
    byte_tokens = list(ttok._bytes_to_unicode().values())
    vocab = byte_tokens + [t + "</w>" for t in byte_tokens]
    merges = ["d o", "do g</w>", "c a", "ca t</w>", "h a", "ha t</w>", "r e", "re d</w>"]
    vocab += [m.replace(" ", "") for m in merges]
    enc = {tok: i for i, tok in enumerate(dict.fromkeys(vocab))}
    enc.update({"<|startoftext|>": len(enc), "<|endoftext|>": len(enc) + 1})
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.json").write_text(json.dumps(enc))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return root


@pytest.fixture(scope="module", params=["hash", "bpe"])
def tokenizers(request, tmp_path_factory):
    if request.param == "hash":
        return jtok.HashTokenizer(), ttok.HashTokenizer()
    root = _write_bpe_vocab(tmp_path_factory.mktemp("bpe"))
    jt, tt = jtok.CLIPTokenizer(root), ttok.CLIPTokenizer(root)
    assert len(tt.encode("squirrel")) > 1 and len(tt.encode("dog")) == 1
    return jt, tt


@pytest.mark.parametrize("x,y", REFINE_PAIRS)
def test_refinement_mapper_bitwise(tokenizers, x, y):
    jt, tt = tokenizers
    jm, ja = jsa.get_refinement_mapper([x, y, x], jt)
    tm, ta = tsa.get_refinement_mapper([x, y, x], tt)
    assert tm.dtype == jm.dtype and ta.dtype == ja.dtype
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    seq_x, seq_y = tt.encode(x), tt.encode(y)
    for got, want in zip(tsa.global_align(seq_x, seq_y, tsa.ScoreParams(0, 1, -1)),
                         jsa.global_align(seq_x, seq_y, jsa.ScoreParams(0, 1, -1))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x,y", REPLACE_PAIRS)
def test_replacement_mapper_and_word_inds_bitwise(tokenizers, x, y):
    jt, tt = tokenizers
    np.testing.assert_array_equal(tsa.get_replacement_mapper([x, y], tt), jsa.get_replacement_mapper([x, y], jt))
    for text in (x, y):
        for place in list(range(len(text.split(" ")))) + text.split(" "):
            np.testing.assert_array_equal(tsa.get_word_inds(text, place, tt), jsa.get_word_inds(text, place, jt))


def test_replacement_mapper_needs_same_word_count():
    with pytest.raises(ValueError):
        tsa.get_replacement_mapper_("a dog", "a big dog", ttok.HashTokenizer())


def _probs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight", "reweight_on_refine"])
@pytest.mark.parametrize("cur_step", [0, 3])
def test_controllers_match(tokenizers, kind, cur_step):
    """Each controller on the same [1 + T, h, Q, K] maps, cross (K = 77) and
    self (K = Q), inside the replace windows (step 0) and past the cross
    window (step 3 of 10 at cross_replace_steps 0.25): within 1e-6."""
    jt, tt = tokenizers
    if kind == "replace":
        prompts = ["a cat on a mat", "a squirrel on a mat", "a dog on a mat"]
    else:
        prompts = ["a dog", "a fluffy dog", "a dog wearing a red hat"]
    kw = dict(cross_replace_steps=0.25, self_replace_steps=0.5)

    def build(ctl, tok):
        if kind == "replace":
            return ctl.AttentionReplace(prompts, tok, 10, **kw)
        if kind == "refine":
            return ctl.AttentionRefine(prompts, tok, 10, **kw)
        eq = ctl.get_equalizer(prompts[1], ("fluffy", "dog"), (2.0, 0.5), tok)
        prev = ctl.AttentionRefine(prompts, tok, 10, **kw) if kind == "reweight_on_refine" else None
        return ctl.AttentionReweight(prompts, tok, 10, equalizer=eq, prev_controller=prev, **kw)

    jc, tc = build(jctl, jt), build(tctl, tt)
    np.testing.assert_array_equal(
        tctl.get_equalizer(prompts[1], "dog", (3.0,), tt).numpy(), np.asarray(jctl.get_equalizer(prompts[1], "dog", (3.0,), jt))
    )
    jc.cur_step = tc.cur_step = cur_step
    rng = np.random.default_rng(cur_step + len(kind))
    for k in (77, 64):
        attn = _probs(rng, (3, 2, 64, k))
        ref = np.asarray(jc(jnp.asarray(attn), "down"))
        out = tc(torch.from_numpy(attn), "down").numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_attention_store_average_matches():
    rng = np.random.default_rng(5)
    js, ts = jctl.AttentionStore(), tctl.AttentionStore()
    for _ in range(3):
        # the store keeps maps with at most 32^2 queries: down_self's 33^2 go
        for place, q, k in (("down_cross", 256, 77), ("mid_cross", 64, 77), ("up_self", 1024, 64),
                            ("down_self", 1089, 8)):
            a = _probs(rng, (2, 2, q, k))
            ta = torch.from_numpy(a)
            assert ts(ta, place) is ta
            js(jnp.asarray(a), place)
        js.between_steps()
        ts.between_steps()
    jav, tav = js.get_average_attention(), ts.get_average_attention()
    assert set(jav) == set(tav) and len(tav["down_self"]) == 0 and len(tav["up_self"]) == 1
    for key in jav:
        for j, t in zip(jav[key], tav[key]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_local_blend_matches(tokenizers):
    """The masks agree except where the normalized map lies within 1e-5 of
    the threshold; the blended latents agree wherever the masks do."""
    jt, tt = tokenizers
    prompts, words = ["a red dog", "a red cat"], ["dog", "cat"]
    jb, tb = jctl.LocalBlend(prompts, words, jt), tctl.LocalBlend(prompts, words, tt)
    rng = np.random.default_rng(6)
    maps = _probs(rng, (2, 16, 16, 77))
    maps[:, 4:9, 3:11, 3] += 0.5  # the words' token: a blob to mask
    # source zeros, target ones: the blend's row 1 is the mask itself
    ones = np.stack([np.zeros((32, 32, 4), np.float32), np.ones((32, 32, 4), np.float32)])
    jmask = np.asarray(jb(jnp.asarray(ones), jnp.asarray(maps)))[1, ..., 0]
    tmask = tb(torch.from_numpy(ones).permute(0, 3, 1, 2), torch.from_numpy(maps)).numpy()[1, 0]
    norm = tb.normalized_map(torch.from_numpy(maps), 32, 32).numpy()[1]
    certain = np.abs(norm - tb.threshold) > 1e-5
    assert 0 < jmask.sum() < jmask.size
    np.testing.assert_array_equal(tmask[certain], jmask[certain])
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    ref = np.asarray(jb(jnp.asarray(lat), jnp.asarray(maps)))
    out = tb(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(maps)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out[1][certain], ref[1][certain])
    np.testing.assert_array_equal(out[0], ref[0])


# ----------------------------------------------------------------------
# the UNet's probs-edit hook
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_pair():
    """The tiny UNet in both packages with the same numpy parameters, and a
    [2, 16, 16, 4] CFG-sized input: 16x16 and 8x8 attention levels."""
    cfg = j_tiny(image_size=32).unet
    jm = junet.UNet2DConditionModel(cfg)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros(()), jnp.asarray(ctx)))
    params = _numpy_params(shapes["params"], seed=13)
    tm = tunet.UNet2DConditionModel(t_tiny(image_size=32).unet)
    tm.load_state_dict(from_flax_params(params), strict=True)
    tm.eval().requires_grad_(False)
    return jm, params, tm, x, ctx


def _run_pair(unet_pair, jfn, tfn, t=321):
    jm, params, tm, x, ctx = unet_pair
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), attn_edit_fn=jfn)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(t), torch.from_numpy(ctx), attn_edit_fn=tfn)
    return np.asarray(ref), out.permute(0, 2, 3, 1).numpy()


def test_hook_identity_matches_no_edit(unet_pair):
    _, _, tm, x, ctx = unet_pair
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(10), torch.from_numpy(ctx))
    with torch.no_grad():
        base = tm(*args)
        same = tm(*args, attn_edit_fn=lambda p, place, is_cross: p)
    np.testing.assert_allclose(same.numpy(), base.numpy(), rtol=0, atol=2e-5)


def test_hook_uniformizing_edit_matches_jax(unet_pair):
    """The same edit in both packages: the outputs within 1e-5 of max|ref|,
    and the ordered (place, is_cross, K) calls identical: two a
    transformer, self-attention as "self"."""
    calls = {"jax": [], "torch": []}

    def make(name, ones_like):
        def uniformize(probs, place, is_cross):
            calls[name].append((place, is_cross, probs.shape[-1]))
            return ones_like(probs) / probs.shape[-1]
        return uniformize

    ref, out = _run_pair(unet_pair, make("jax", jnp.ones_like), make("torch", torch.ones_like))
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) == 8  # 4 transformers at the tiny config
    assert [c[:2] for c in calls["torch"][:2]] == [("self", False), ("down", True)]
    assert _rel(out, ref) < 1e-5


def test_hook_controller_in_unet_matches_jax(unet_pair):
    """AttentionRefine plugged into both UNets through a lambda (source row
    0, target row 1): within 1e-5 of max|ref|."""
    tok_j, tok_t = jtok.HashTokenizer(), ttok.HashTokenizer()
    prompts = ["a dog", "a fluffy dog"]
    jc = jctl.AttentionRefine(prompts, tok_j, 10, self_replace_steps=0.5)
    tc = tctl.AttentionRefine(prompts, tok_t, 10, self_replace_steps=0.5)
    ref, out = _run_pair(unet_pair, lambda p, place, c: jc(p, place), lambda p, place, c: tc(p, place))
    assert _rel(out, ref) < 1e-5


def test_hook_takes_every_attention_off_flash_and_sdpa(unet_pair, monkeypatch):
    """With the hook set neither the flash wrapper nor SDPA is reached, and
    a captured map is the edited one."""
    _, _, tm, x, ctx = unet_pair

    def unreachable(*args, **kwargs):
        raise AssertionError("a fast attention route was taken")

    monkeypatch.setattr(tunet, "flash_attention", unreachable)
    monkeypatch.setattr(tunet.F, "scaled_dot_product_attention", unreachable)
    monkeypatch.setattr(tunet, "flash_self_attention_enabled", lambda q, d: True)
    store = []
    with torch.no_grad():
        tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(5), torch.from_numpy(ctx), attn_store=store,
           attn_edit_fn=lambda p, place, is_cross: torch.ones_like(p) / p.shape[-1])
    assert [tag for tag, _ in store] == ["down", "mid", "up", "up"]
    for _, m in store:
        np.testing.assert_allclose(m.numpy(), 1.0 / 77, rtol=1e-6)
