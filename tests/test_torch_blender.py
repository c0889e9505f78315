"""The port's NeRF-blender converter (library and CLI) against voxe_tpu's:
the `*_camera_params.json` files it writes are byte-equal, on a small
synthetic blender scene (three splits, non-square images)."""
import json

import numpy as np
import pytest
from PIL import Image

from voxe_tpu.data.blender import convert_nerf_blender_dataset as j_convert
from voxe_tpu_torch.cli import convert_from_nerf_blender_dataset as t_cli
from voxe_tpu_torch.data.blender import convert_nerf_blender_dataset as t_convert

SPLITS = ("train", "val", "test")


@pytest.fixture
def blender_scene(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "lego"
    for s, split in enumerate(SPLITS):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(2 + s):
            Image.fromarray(rng.integers(0, 255, (6, 10, 4), dtype=np.uint8)).save(root / split / f"r_{i}.png")
            pose = np.eye(4)
            pose[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            pose[:3, 3] = rng.standard_normal(3) * 4
            frames.append({"file_path": f"./{split}/r_{i}", "rotation": 0.012566, "transform_matrix": pose.tolist()})
        meta = {"camera_angle_x": 0.6911112070083618 + 0.1 * s, "frames": frames}
        (root / f"transforms_{split}.json").write_text(json.dumps(meta, indent=4))
    return root


@pytest.mark.parametrize("route", ["library", "cli"])
def test_camera_params_json_byte_equal(blender_scene, tmp_path, route):
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    j_convert(blender_scene, j_out)
    if route == "library":
        t_convert(blender_scene, t_out)
    else:
        t_cli.main(["-d", str(blender_scene), "-o", str(t_out)])
    for split in SPLITS:
        got = (t_out / f"{split}_camera_params.json").read_bytes()
        assert got == (j_out / f"{split}_camera_params.json").read_bytes()
    params = json.loads((t_out / "val_camera_params.json").read_text())
    entry = params["r_2.png"]
    assert (entry["intrinsic"]["height"], entry["intrinsic"]["width"]) == (6, 10)
    assert entry["intrinsic"]["bounds"] == [2.0, 6.0]
