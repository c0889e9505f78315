"""SDXL base 1.0 as the port's SDS prior (`StableDiffusion(sd_version="xl")`),
held against the benchmark's plain float32 reference
(`portbench/reference/sdxl.py`), which imports neither the port nor JAX: the
JAX package has no SDXL.

On the CPU, at a tiny SDXL (three levels with no attention at the first,
transformer depths (1, 2, 3), two 2-layer towers of different widths, the
text_time added embedding) with seeded random weights handed over under the
published diffusers names through the port's loader (strict): the context
and pooled rows, the UNet with the added conditioning, one edit step's loss
and grid gradients, and the cell's check; the tiny SD 2.0 and 1.4 UNets keep
their state-dict names and their outputs bitwise; the edit CLI with
`--sd_version xl` runs two steps from an HF snapshot, reading
`text_encoder_2/`. On the card (marked `cuda`, skipped without one; run with
`--noconftest`, the card has no JAX): the UNet's CUDA graph fills the context,
pooled row and time ids of each call, the flash kernel at SDXL's
[2, 4096, 10, 64], and the self-attention counters at full width.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench.entries import edit_xl
from portbench.lib import inputs
from portbench.lib.manifest import Cell, merge
from portbench.lib.seeds import generator
from portbench.reference import sdxl
from portbench.reference.precision import Rounding
from portbench.reference.steps_xl import build_sdxl
from portbench.run import run
from portbench.tests.tiny_xl import F32, OVERRIDES
from voxe_tpu_torch.models.sd import config as sd_config
from voxe_tpu_torch.models.sd import unet as unet_mod
from voxe_tpu_torch.models.sd.sds import StableDiffusion, SDXLText, empty_negative_pairs, select_text
from voxe_tpu_torch.models.sd.weights import HF_SUBFOLDERS, NAME_FNS, hf_names
from voxe_tpu_torch.ops import flash_attention as fa
from voxe_tpu_torch.utils import tracing

torch.set_num_threads(1)
SEED = 2**31 + 4242


def _tiny_cell(f32: bool = True) -> Cell:
    return Cell("edit-sdxl", overrides=merge(OVERRIDES["edit-sdxl"], F32) if f32 else OVERRIDES["edit-sdxl"])


@pytest.fixture(scope="module")
def pair():
    """(configuration, the port's tiny SDXL in f32, the reference's modules,
    the conditional ids of the four view buckets)."""
    cell = _tiny_cell()
    model = edit_xl.build_sd(cell.config, SEED, "cpu")
    _, ref = build_sdxl(cell.config, SEED, "cpu", Rounding())
    ids = inputs.token_ids(SEED, cell.config["sd"]["text_encoder"], 14, "cpu")[:, 1]
    return cell.config, model, ref, ids


def _close(got, want, tol):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-30), err


def test_context_and_pooled_rows_match_the_reference(pair):
    cfg, model, ref, ids = pair
    got = empty_negative_pairs(model.encode_text_xl(ids, ids))
    want = sdxl.encode_text(ref, ids, cfg["sd"]["add_time_ids"])
    assert got.context.shape == (4, 2, 77, 32 + 48) and got.pooled.shape == (4, 2, 40)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5
    assert float(got.context[:, 0].abs().max()) == 0.0 and float(got.pooled[:, 0].abs().max()) == 0.0
    # the prompt API: an empty negative prompt gives zeros, another prompt its own rows
    text = model.get_text_embeds("a dog wearing a hat")
    assert isinstance(text, SDXLText) and float(text.context[0].abs().max()) == 0.0
    assert torch.equal(text.time_ids, torch.tensor([[32.0, 32, 0, 0, 32, 32]] * 2))
    neg = model.get_text_embeds("a dog wearing a hat", "blurry")
    assert float(neg.pooled[0].abs().max()) > 0.0 and torch.equal(neg.pooled[1], text.pooled[1])


def test_unet_with_the_added_conditioning_matches_the_reference(pair):
    cfg, model, ref, ids = pair
    text = empty_negative_pairs(model.encode_text_xl(ids, ids))
    g = torch.Generator().manual_seed(5)
    lat = torch.randn((1, 4, 16, 16), generator=g)
    for d, t in ((0, 37), (3, 911)):
        got = model.unet_noise_pred(torch.cat([lat] * 2), t, select_text(text, d))
        want = sdxl.unet_pair(ref["unet"], lat, t, sdxl.encode_text(ref, ids, cfg["sd"]["add_time_ids"]), d)
        _close(got, want, 1e-5)
    # the added embedding moves the prediction: another pooled row, another output
    other = select_text(text, 0)._replace(pooled=torch.flip(select_text(text, 0).pooled, [0]))
    assert not torch.allclose(model.unet_noise_pred(torch.cat([lat] * 2), 37, other),
                              model.unet_noise_pred(torch.cat([lat] * 2), 37, select_text(text, 0)))
    with pytest.raises(ValueError):  # the SDXL UNet refuses a call without its added conditioning
        model.unet(torch.cat([lat] * 2), 37, text.context[0])


def test_edit_step_matches_the_reference_and_the_cell_check():
    """The cell's program (make_sds_train_multi_step with SDXL) against the
    reference in float32: the first step's loss and grid-gradient norms
    within 1e-4, and the cell's check correct; in the configured bfloat16,
    correct too."""
    cell = _tiny_cell()
    prog = cell.entry.setup(cell.config, cell.spec, SEED, "cpu").readings
    ref = cell.entry.reference(cell.config, cell.spec, SEED, "cpu", Rounding("f32"))
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-4 * max(abs(ref["loss"][0]), 1.0)
    for k in ("densities", "features"):
        assert abs(prog["grad_norm"][k] - ref["grad_norm"][k]) <= 1e-4 * ref["grad_norm"][k]
    result, compared = run("edit-sdxl", SEED, 0.1, False, "cpu", OVERRIDES["edit-sdxl"])
    assert result["correct"] and result["failed"] == 0, compared


def test_loader_maps_the_diffusers_names_strictly(pair):
    """Every port key of the four modules names a reference parameter of the
    same shape (transformer_blocks.{i}, add_embedding.linear_{1,2},
    text_projection, text_encoder_2/), and no two keys share one."""
    _, model, ref, _ = pair
    for port, hf in HF_SUBFOLDERS.items():
        module = getattr(model, port)
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        theirs = {k: tuple(v.shape) for k, v in ref[hf].state_dict().items()}
        names = {c[0]: key for key, (c, _) in hf_names(module, NAME_FNS[port]).items()}
        assert set(names) == set(theirs), port
        for name, key in names.items():  # a linear where the port has a 1x1 conv keeps its two dims
            assert shapes[key][:2] == theirs[name][:2] and torch.Size(shapes[key]).numel() == torch.Size(theirs[name]).numel()
    keys = set(model.unet.state_dict())
    assert {"add_embedding_linear_1.weight", "down_2_attn_0.transformer_blocks_2.ff.out_proj.bias", "up_0_attn_1.transformer_blocks_2.attn1.to_q.weight"} <= keys
    assert "text_projection.weight" in model.clip_2.state_dict() and "text_projection.weight" not in model.clip.state_dict()


def _seed_transformer_forward(self, x, context, attn_store=None, attn_edit_fn=None):
    """Transformer2D.forward as it was before stacks deeper than one block."""
    B, C, H, W = x.shape
    h = self.proj_in(self.norm(x))
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    h = self.transformer_blocks_0(h, context, attn_store, attn_edit_fn)
    h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return self.proj_out(h) + x


@pytest.mark.parametrize("heads", [(4, 8), (1, 1)], ids=["sd2-like", "sd14-like"])
def test_sd1_and_sd2_unets_keep_their_names_and_outputs(heads, monkeypatch):
    cfg = dataclasses.replace(sd_config.tiny_test_config().unet, attention_head_dim=heads)
    torch.manual_seed(0)
    unet = unet_mod.UNet2DConditionModel(cfg)
    keys = list(unet.state_dict())
    blocks = {k.split(".")[1] for k in keys if ".transformer_blocks_" in k}
    assert blocks == {"transformer_blocks_0"} and not any("add_embedding" in k for k in keys)
    g = torch.Generator().manual_seed(1)
    lat, ctx = torch.randn((2, 4, 8, 8), generator=g), torch.randn((2, 77, 32), generator=g)
    with torch.no_grad():
        now = unet(lat, 321, ctx)
        monkeypatch.setattr(unet_mod.Transformer2D, "forward", _seed_transformer_forward)
        assert torch.equal(now, unet(lat, 321, ctx))


def _write_snapshot(root, cfg: dict, seed: int) -> None:
    """A tiny SDXL HF snapshot: the reference's seeded draws under the
    published names (*.bin), and a byte-level BPE tokenizer."""
    from voxe_tpu_torch.models.sd.tokenizer import _bytes_to_unicode
    from portbench.lib.weights import draw

    names = sdxl.build(cfg["sd"], {k: Rounding() for k in sdxl.MODULES})
    for name, module in names.items():
        (root / name).mkdir(parents=True)
        torch.save(draw(module, generator(seed, name, "cpu"), torch.float32), root / name / "pytorch_model.bin")
    byte_tokens = list(_bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(byte_tokens + [t + "</w>" for t in byte_tokens])}
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (root / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")


def test_edit_cli_runs_sdxl_from_a_snapshot(tmp_path, monkeypatch):
    """`--sd_version xl` (its published widths swapped for the tiny SDXL's)
    with `--sd_weights_dir`: two edit steps on the CPU, the second tower
    read from text_encoder_2/; without that folder the load fails."""
    from voxe_tpu_torch.cli import edit_pretrained_relu_field as cli
    from voxe_tpu_torch.cli import train_sh_based_voxel_grid_with_posed_images as recon_cli
    from voxe_tpu_torch.data.synthetic import generate_synthetic_scene
    from voxe_tpu_torch.models.sd.weights import load_tensor_files

    scene = tmp_path / "scene"
    generate_synthetic_scene(scene, num_train=2, num_test=1, image_size=32, focal=32.0, grid_res=16, device="cpu")
    for split in ("train", "test"):
        (scene / split).mkdir()
        for p in (scene / "images").glob(f"{split}_*.png"):
            p.rename(scene / split / p.name)
    recon_cli.main(["-d", str(scene), "-o", str(tmp_path / "recon"), "--grid_dims", "16", "16", "16",
                    "--num_stages", "1", "--num_iterations_per_stage", "1", "--fast_debug_mode", "True",
                    "--device", "cpu"])
    cell = _tiny_cell(f32=False)
    snap = tmp_path / "sdxl"
    _write_snapshot(snap, cell.config, SEED)
    monkeypatch.setitem(sd_config.SD_VERSIONS, "xl", edit_xl.sd_config(cell.config["sd"]))
    args = ["-i", str(tmp_path / "recon" / "saved_models" / "model_final.pth"), "-o", str(tmp_path / "edit"),
            "-p", "a dog wearing a hat", "-d", str(scene), "--data_downsample_factor", "1", "--sd_version", "xl",
            "--sd_weights_dir", str(snap), "--num_iterations_edit", "2", "--fast_debug_mode", "True",
            "--device", "cpu"]
    loaded = []
    real = load_tensor_files
    monkeypatch.setattr("voxe_tpu_torch.models.sd.weights.load_tensor_files",
                        lambda d: loaded.append(d.name) or real(d))
    model = cli.main(args)
    assert sorted(loaded) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    assert (tmp_path / "edit" / "saved_models" / "model_final.pth").exists()
    assert bool(torch.isfinite(model.grid.densities).all())
    (snap / "text_encoder_2" / "pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError):
        cli.main(args)


def test_flash_share_reader_reads_the_route_counters(monkeypatch):
    """`flash_flops_pct.xl` reads the program's counters as deltas over the
    profiled steps: 10 flash calls at 64^2 against 60 SDPA calls at 32^2 a
    pass read 4 / 7 = 57.14 % (FLOPs 4:3); a program without the counters
    reads None."""
    from portbench.lib.manifest import counters_of, reader
    from portbench.lib.trace import Trace
    from portbench.metrics.lib import attn_flops
    from portbench.run import _counter_values, _snapshot

    name = "flash_flops_pct.xl"
    assert name in {m["name"] for m in Cell("edit-sdxl").per_layer()}
    assert name not in {m["name"] for m in Cell("edit-sd2").per_layer()}
    module = reader(name)
    counters = counters_of({name: module})
    before = _snapshot(counters)
    for counter, flops, n in (("ATTN_FLASH_FLOPS", 4 * 2 * 4096**2 * 640, 10),
                              ("ATTN_SDPA_FLOPS", 4 * 2 * 1024**2 * 1280, 60)):
        for _ in range(n):
            tracing.count("tracing." + counter, flops, torch.device("cpu"))
    values = _counter_values(counters, before, _snapshot(counters))
    assert module.read(Trace([], 0.0, 0.0, 1, 1.0, values, {}, {})) == pytest.approx(400 / 7)
    real = attn_flops.importlib.import_module

    def missing(mod):
        if mod == attn_flops.MODULE:
            raise ModuleNotFoundError(mod)
        return real(mod)

    monkeypatch.setattr(attn_flops.importlib, "import_module", missing)
    values = _counter_values(counters, _snapshot(counters), _snapshot(counters))
    assert set(values.values()) == {0} and module.read(Trace([], 0.0, 0.0, 1, 1.0, values, {}, {})) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the flash kernel have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replays_fill_each_views_pooled_row(cuda_device):
    """A reduced SDXL (full topology, 64 channels at 64^2, head 64: two
    flash launches a pass): the first call captures, and the replays with
    another view's context, pooled row and time ids equal the eager call
    bitwise. A replay that kept the captured pooled row would not."""
    cfg = dataclasses.replace(
        sd_config.tiny_xl_test_config(), unet=dataclasses.replace(
            sd_config.tiny_xl_test_config().unet, block_out_channels=(32, 64, 64), attention_head_dim=(1, 1, 1),
            norm_num_groups=16, transformer_layers_per_block=(1, 1, 2)),
    )
    sd = StableDiffusion(config=cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(0, 1000, (4, 77), generator=g, device=cuda_device)
    table = empty_negative_pairs(sd.encode_text_xl(ids, ids))
    table = table._replace(time_ids=table.time_ids + torch.arange(4, device=cuda_device)[:, None, None])
    replays = tracing.UNET_REPLAYS
    for i in range(6):
        lat = torch.randn((2, 4, 128, 128), generator=g, device=cuda_device)
        text = select_text(table, i % 4)
        got = sd.unet_noise_pred(lat, 100 + 50 * i, text)
        x = lat.to(sd.unet_dtype).contiguous(memory_format=torch.channels_last)
        eager = sd.unet(x, 100 + 50 * i, text.context.to(sd.unet_dtype),
                        added_cond=(text.pooled, text.time_ids)).float()
        assert torch.equal(got, eager), i
    assert tracing.UNET_REPLAYS - replays == 5 and len(sd._unet_graphs) == 1


@pytest.mark.cuda
def test_flash_kernel_at_the_sdxl_shape(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((2, 4096, 10, 64), generator=g, device=cuda_device).bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v).float()
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), 64**-0.5)
    # relative, as chip_smoke.py's FLASH_REL_TOL: an output element's std is
    # ~0.03 here, so an absolute 2e-2 would pass a wrong rescale
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


@pytest.mark.cuda
def test_attention_counters_at_full_width(cuda_device):
    """The published SDXL UNet: 10 self-attentions a pass through the flash
    kernel (64^2 tokens, 10 heads of 64) and 60 through SDPA (32^2), each
    counted once from its shapes, eagerly and at every graph replay."""
    sd = StableDiffusion("xl", init_mode="zeros", device=cuda_device)
    flash_call, sdpa_call = 4 * 2 * 4096**2 * 640, 4 * 2 * 1024**2 * 1280
    lat = torch.zeros((2, 4, 128, 128), device=cuda_device)
    text = SDXLText(torch.zeros((2, 77, 2048), device=cuda_device), torch.zeros((2, 1280), device=cuda_device),
                    torch.zeros((2, 6), device=cuda_device))
    for i in range(3):  # the capture's warm-up, then two replays
        before = (tracing.ATTN_FLASH_FLOPS, tracing.ATTN_SDPA_FLOPS, tracing.ATTN_PROBS_FLOPS, fa.LAUNCHES)
        sd.unet_noise_pred(lat, 500, text)
        after = (tracing.ATTN_FLASH_FLOPS, tracing.ATTN_SDPA_FLOPS, tracing.ATTN_PROBS_FLOPS, fa.LAUNCHES)
        assert tuple(b - a for a, b in zip(before, after)) == (10 * flash_call, 60 * sdpa_call, 0, 10), i
    (graph,) = sd._unet_graphs.values()
    assert (graph.tally["tracing.ATTN_FLASH_FLOPS"], graph.tally["tracing.ATTN_SDPA_FLOPS"]) == (
        10 * flash_call, 60 * sdpa_call)
