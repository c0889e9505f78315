"""The PyTorch port stands alone: no module of voxe_tpu_torch (nor
chip_smoke.py or flash_bwd_ablations.py) imports jax, flax, optax, safetensors, voxe_tpu, matplotlib
or imageio (the card has none of the last three: the port reads safetensors
itself and writes images and videos with Pillow), and its
native segmentation backend is built from the port's own C++ sources into
its own build directory. Plus the
flash kernel's wrapper contract, and the kernel held against its plain
version on the card (marked `cuda`: skipped without one). The backward
kernels' card tests are in test_torch_flash_bwd.py."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import voxe_tpu_torch
from voxe_tpu_torch.ops import flash_attention as fa

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(voxe_tpu_torch.__path__, "voxe_tpu_torch.")
    )


def test_port_imports_no_jax_or_reference_package():
    mods = _modules()
    assert "voxe_tpu_torch.ops.flash_attention" in mods and len(mods) >= 20
    for name in ("cli.render_sh_based_voxel_grid", "cli.render_sh_based_voxel_grid_attn", "viz.animations",
                 "viz.video", "models.lpips", "cli.validate_sd_weights", "cli.convert_from_nerf_blender_dataset",
                 "models.sd.controllers", "models.sd.seq_aligner", "data.blender", "grid.feature_voxels",
                 "train.grid_refine", "parallel.mesh", "parallel.distributed"):
        assert f"voxe_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import flash_bwd_ablations\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'safetensors', 'voxe_tpu', 'matplotlib', 'imageio'))\n"
        "from voxe_tpu_torch.seg import native\n"
        "native.get_lib()\n"
        "srcs = [native.SEG_SRC_DIR / s for s in native.SOURCES]\n"
        "bad += [str(s) for s in srcs if not (s.is_file() and 'voxe_tpu_torch/csrc/seg' in s.as_posix())]\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if 'voxeseg' in l}\n"
        "bad += sorted(l for l in libs if '/voxe_tpu_torch/_build/' not in l)\n"
        "bad += [] if libs else ['no seg library loaded']\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_wrapper_cpu_path_counts_no_launch():
    """A CPU tensor takes the plain version, which autograd differentiates
    (requires_grad is accepted: the card's route has a backward kernel), and
    counts no forward or backward launch."""
    q = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    out = fa.flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    out.float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,lk,q_scale",
    [
        ((2, 4096, 5, 64), None, 1.0),  # the UNet's 64x64 level (CFG batch 2)
        ((1, 2500, 2, 128), None, 1.0),
        ((1, 100, 3, 64), None, 1.0),
        ((1, 1000, 3, 64), None, 4.0),
        ((2, 1000, 3, 64), None, 1.0),  # B = 2, ragged: a tile must not read the next batch
        ((2, 4096, 5, 64), 1000, 1.0),  # Lq != Lk, ragged keys
        ((1, 100, 2, 64), 4096, 1.0),  # few queries, many keys
        ((1, 130, 2, 64), 1, 1.0),  # one key: out = v
        ((2, 4096, 5, 128), None, 1.0),  # d = 128 at the main length
    ],
)
def test_flash_kernel_matches_plain_on_card(cuda_device, shape, lk, q_scale):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    kv_shape = shape if lk is None else (shape[0], lk, *shape[2:])
    q = torch.randn(shape, generator=g, device=cuda_device, dtype=torch.bfloat16)
    k, v = (torch.randn(kv_shape, generator=g, device=cuda_device, dtype=torch.bfloat16) for _ in range(2))
    q = q * q_scale  # 4.0: peaked scores, so the running max moves between key tiles
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.flash_attention_reference(q, k, v).float()
    # Relative to max|ref|: an output element has std ~sqrt(e/L), so an
    # absolute limit would follow the shape. Both sides round to bf16 (one ulp
    # at max|ref| is 2^-8..2^-7 of it); 2e-2 is ~2.5-5 ulps, while a wrong
    # rescale or row sum is O(1) relative.
    assert float((out.float() - ref).abs().max() / ref.abs().max()) < 2e-2


@pytest.mark.cuda
def test_flash_kernel_rejects_unsupported_inputs(cuda_device):
    q = torch.randn(1, 64, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # head dim 32
    q = torch.randn(1, 64, 2, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # f32
    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, scale=-0.125)  # the kernel's running max needs scale > 0
    before = fa.LAUNCHES
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :1], q)  # k's heads differ from q's
    assert fa.LAUNCHES == before
