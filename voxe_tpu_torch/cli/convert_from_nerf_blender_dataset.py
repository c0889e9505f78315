"""CLI: convert a NeRF-blender dataset into the camera-params layout the
recon CLI reads (counterpart of tools/convert_from_nerf_blender_dataset.py:
the same flags, parsed with argparse).

    python -m voxe_tpu_torch.cli.convert_from_nerf_blender_dataset \\
        -d nerf_synthetic/lego -o lego_converted

Reads `transforms_{train,val,test}.json` and the first image of each split
for its size; writes `{train,val,test}_camera_params.json`.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

from voxe_tpu_torch.data.blender import convert_nerf_blender_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="convert a NeRF-blender scene's camera parameters")
    p.add_argument("-d", "--data_path", required=True, help="path to the original nerf synthetic dataset scene")
    p.add_argument("-o", "--output_path", required=True, help="path for outputting the converted scene")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    config = build_parser().parse_args(argv)
    convert_nerf_blender_dataset(Path(config.data_path), Path(config.output_path))


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()
