"""NeRF-blender `transforms_*.json` -> `*_camera_params.json` converter
(counterpart of voxe_tpu/data/blender.py, on the port's JSON keys; the JSON
it writes is byte for byte the JAX package's). The CLI is
`python -m voxe_tpu_torch.cli.convert_from_nerf_blender_dataset`.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from voxe_tpu_torch.data import constants as keys
from voxe_tpu_torch.utils.logging import log

SPLITS = ("train", "val", "test")
NEAR, FAR = 2.0, 6.0


def convert_nerf_blender_dataset(data_path: Path, output_path: Path) -> None:
    data_path, output_path = Path(data_path), Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    meta_jsons = {}
    for split in SPLITS:
        with open(data_path / f"transforms_{split}.json") as f:
            meta_jsons[split] = json.load(f)

    for split, meta in meta_jsons.items():
        out = {}
        first_name = meta["frames"][0]["file_path"].split("/")[-1] + ".png"
        with Image.open(data_path / split / first_name) as img:
            width, height = img.size
        focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))

        for frame in meta["frames"]:
            filename = frame["file_path"].split("/")[-1] + ".png"
            transform = np.array(frame["transform_matrix"])
            out[filename] = {
                keys.INTRINSIC: {
                    keys.BOUNDS: [NEAR, FAR],
                    keys.HEIGHT: height,
                    keys.WIDTH: width,
                    keys.FOCAL: focal,
                },
                keys.EXTRINSIC: {
                    keys.ROTATION: transform[:3, :3].tolist(),
                    keys.TRANSLATION: transform[:3, -1:].tolist(),
                },
            }

        with open(output_path / f"{split}_camera_params.json", "w", encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=4)
    log.info(f"converted data written to: {output_path}")
