"""StableDiffusion.unet_noise_pred as a CUDA graph's replay.

On the CPU (no card): the call runs eagerly and equals a direct UNet call,
the counters count it as a call and not as a replay, and the rule that
picks the graph refuses a CPU call and the probs-edit hook and keys apart
shapes, dtypes, memory formats, the capture flag and the float32 matmul
precision. On the card (marked `cuda`, skipped without one): at a small
SD 2.0-like UNet whose 64x64 self-attention takes the flash kernel (5
launches a pass) and at a small SD 1.4-like one on the capture path (head
40, no flash), replays equal the eager call bitwise, returned tensors
survive later calls, the flash launch counter counts what ran and agrees
with a profile, new weights drop the graphs, and the hook never replays.
The card has no JAX: run the card part with `--noconftest`."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from voxe_tpu_torch.models.sd.config import CLIPTextConfig, SDConfig, UNetConfig, VAEConfig
from voxe_tpu_torch.models.sd.sds import StableDiffusion, unet_graph_key, unet_replays
from voxe_tpu_torch.models.sd.weights import flax_path
from voxe_tpu_torch.ops import flash_attention as fa
from voxe_tpu_torch.utils import tracing

torch.set_num_threads(1)


def _counts():
    return tracing.UNET_CALLS, tracing.UNET_REPLAYS


def _plain_unet(sd, latents, t, text, **kw):
    x = latents.to(sd.unet_dtype)
    if latents.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    return sd.unet(x, t, text.to(sd.unet_dtype), **kw).float()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cpu():
    sd = StableDiffusion("tiny", seed=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    lat = torch.randn((2, 4, 8, 8), generator=g)
    return sd, lat, sd.get_text_embeds("a dog wearing a hat")


def test_cpu_call_stays_eager_and_equals_the_unet(tiny_cpu):
    sd, lat, text = tiny_cpu
    calls, replays = _counts()
    out = sd.unet_noise_pred(lat, 500, text)
    assert torch.equal(out, _plain_unet(sd, lat, 500, text))
    got, maps = sd.unet_noise_pred(lat, 300, text, capture_attn=True)
    store = []
    assert torch.equal(got, _plain_unet(sd, lat, 300, text, attn_store=store))
    assert [tag for tag, _ in maps] == [tag for tag, _ in store] and len(maps) > 0
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(maps, store))
    hooked = sd.unet_noise_pred(lat, 500, text, attn_edit_fn=lambda p, place, is_cross: p)
    assert hooked.shape == out.shape
    assert _counts() == (calls + 3, replays)
    assert sd._unet_graphs == {}


def test_the_rule_refuses_a_cpu_call_and_the_hook():
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert unet_replays(on_card, None)
    assert not unet_replays(on_card, lambda p, place, is_cross: p)
    assert not unet_replays(torch.zeros(2, 4, 8, 8), None)


def test_the_key_parts_shapes_dtypes_formats_and_capture():
    lat = torch.zeros(2, 4, 8, 8)
    text = torch.zeros(2, 77, 32)
    keys = [
        unet_graph_key(lat, text, False),
        unet_graph_key(lat, text, True),
        unet_graph_key(torch.zeros(4, 4, 8, 8), text, False),
        unet_graph_key(torch.zeros(2, 4, 16, 16), text, False),
        unet_graph_key(lat.bfloat16(), text, False),
        unet_graph_key(lat.contiguous(memory_format=torch.channels_last), text, False),
        unet_graph_key(lat, torch.zeros(4, 77, 32), False),
        unet_graph_key(lat, text.bfloat16(), False),
    ]
    assert len(set(keys)) == len(keys)
    # the same signature from other tensors is the same key
    assert unet_graph_key(torch.ones(2, 4, 8, 8), torch.ones(2, 77, 32), False) == keys[0]
    precision = torch.get_float32_matmul_precision()
    try:  # a capture keeps the float32 products' kernels its precision chose
        torch.set_float32_matmul_precision("high")
        assert unet_graph_key(lat, text, False) not in keys
    finally:
        torch.set_float32_matmul_precision(precision)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# 64x64 latents; level 0 of 64 channels in 1 head (head 64, 4096 queries:
# the flash kernel's gate), 2 down and 3 up transformers there: 5 launches
SD2_LIKE = UNetConfig(
    block_out_channels=(64, 128), layers_per_block=2, cross_attention_dim=64, attention_head_dim=(1, 2),
    norm_num_groups=32, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
)
# head 40 at both levels, as SD 1.4's 8 heads of 40 at 320 channels: SDPA
SD14_LIKE = UNetConfig(
    block_out_channels=(80, 160), layers_per_block=2, cross_attention_dim=48, attention_head_dim=(2, 4),
    norm_num_groups=16, down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
)


def _sd(unet: UNetConfig, seed: int, device) -> StableDiffusion:
    config = SDConfig(
        version="tiny",
        clip=CLIPTextConfig(vocab_size=1024, hidden_size=unet.cross_attention_dim, intermediate_size=64,
                            num_hidden_layers=1, num_attention_heads=4),
        vae=VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4),
        unet=unet,
    )
    return StableDiffusion(config=config, seed=seed, device=device)


def _inputs(sd, g, device):
    lat = torch.randn((2, 4, 64, 64), generator=g, device=device)
    text = torch.randn((2, 77, sd.config.unet.cross_attention_dim), generator=g, device=device)
    t = int(torch.randint(20, 981, (), generator=g, device=device))
    return lat, t, text


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the flash kernel have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replays_equal_the_eager_call_bitwise_and_count_flash_launches(cuda_device):
    sd = _sd(SD2_LIKE, 0, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    table = torch.randn((4, 2, 77, 64), generator=g, device=cuda_device)  # the edit's table of directions
    calls, replays = _counts()
    for i in range(6):
        lat, t, _ = _inputs(sd, g, cuda_device)
        text = table[i % 4]
        with tracing.counted() as c:
            got = sd.unet_noise_pred(lat, t, text)
        torch.cuda.synchronize()
        # the first call's warm-up ran 5 and its capture recorded 5; each replay runs 5
        (graph,) = sd._unet_graphs.values()
        assert c["flash_attention.LAUNCHES"] == graph.tally["flash_attention.LAUNCHES"] == 5
        assert got.dtype == torch.float32
        assert torch.equal(got, _plain_unet(sd, lat, t, text))
    assert _counts() == (calls + 6, replays + 5)
    assert len(sd._unet_graphs) == 1


@pytest.mark.cuda
def test_captured_maps_equal_the_eager_maps(cuda_device):
    sd = _sd(SD14_LIKE, 0, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    launches = fa.LAUNCHES
    for _ in range(4):
        lat, t, text = _inputs(sd, g, cuda_device)
        got, maps = sd.unet_noise_pred(lat, t, text, capture_attn=True)
        store = []
        assert torch.equal(got, _plain_unet(sd, lat, t, text, attn_store=store))
        assert [tag for tag, _ in maps] == [tag for tag, _ in store] and len(maps) == 11
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(maps, store))
    assert fa.LAUNCHES == launches  # head 40: no flash kernel


@pytest.mark.cuda
def test_a_returned_tensor_survives_the_next_calls(cuda_device):
    sd = _sd(SD14_LIKE, 0, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    held = [sd.unet_noise_pred(*_inputs(sd, g, cuda_device), capture_attn=True) for _ in range(3)]
    kept = [(out.clone(), [m.clone() for _, m in maps]) for out, maps in held]
    for _ in range(2):
        sd.unet_noise_pred(*_inputs(sd, g, cuda_device), capture_attn=True)
    torch.cuda.synchronize()
    for (out, maps), (out0, maps0) in zip(held, kept):
        assert torch.equal(out, out0) and all(torch.equal(m, m0) for (_, m), m0 in zip(maps, maps0))
    assert not torch.equal(held[1][0], held[2][0])


def _flax_tree(sd) -> dict:
    """The JAX package's parameter tree of `sd`'s modules (numpy leaves)."""
    tree = {}
    for name in ("clip", "vae", "unet"):
        module = getattr(sd, name)
        for key, value in module.state_dict().items():
            *path, leaf = flax_path(module, key).split("/")
            arr = value.float().cpu().numpy()
            if leaf == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
            node = tree.setdefault(name, {})
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(arr)
    return tree


@pytest.mark.cuda
def test_new_weights_drop_the_graphs(cuda_device):
    sd, other = _sd(SD2_LIKE, 0, cuda_device), _sd(SD2_LIKE, 1, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    lat, t, text = _inputs(sd, g, cuda_device)
    for _ in range(2):
        sd.unet_noise_pred(lat, t, text)
    sd.load_flax_params(_flax_tree(other))
    assert sd._unet_graphs == {}
    want = _plain_unet(other, lat, t, text)
    for _ in range(3):  # the capture's warm-up, then replays
        assert torch.equal(sd.unet_noise_pred(lat, t, text), want)


@pytest.mark.cuda
def test_the_hook_never_replays(cuda_device):
    sd = _sd(SD2_LIKE, 0, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    calls, replays = _counts()
    for _ in range(3):
        lat, t, text = _inputs(sd, g, cuda_device)
        got = sd.unet_noise_pred(lat, t, text, attn_edit_fn=lambda p, place, is_cross: p)
        assert torch.equal(got, _plain_unet(sd, lat, t, text, attn_edit_fn=lambda p, place, is_cross: p))
    assert _counts() == (calls + 3, replays) and sd._unet_graphs == {}


@pytest.mark.cuda
def test_a_profile_of_replays_holds_their_flash_kernels(cuda_device):
    """The benchmark's flash roofline holds the launch counter against the
    kernels in a trace: a graph captured before the profiler starts must
    show its kernels when it replays under it."""
    from torch.profiler import ProfilerActivity, profile

    sd = _sd(SD2_LIKE, 0, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    sd.unet_noise_pred(*_inputs(sd, g, cuda_device))
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sd.unet_noise_pred(*_inputs(sd, g, cuda_device))
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if "flash_fwd_kernel" in e.key)
    assert fa.LAUNCHES - launches == kernels == 15
