"""CLI: CLIP / FID / PSNR quality metrics over a Vox-E result folder with
the PyTorch port (counterpart of evaluation/calculate_metrics.py: the same
flags, parsed with argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.calculate_metrics -d results \\
        [--clip_model_dir clip] [--inception_model_dir inception] [--device cpu]

Walks results/<scene>/{inputs,recon,<prompt>...}/ folders of PNG frames
(the "color_" prefix stripped from file names in place) and writes
results/output_metrics.csv with columns [text CLIP, dir CLIP, FID recon,
FID input, PSNR recon], one block per scene, byte for byte as the JAX CLI's
pandas writer lays it out: the scene title, the header with an empty index
label, one row a prompt folder, floats as pandas prints them (the shortest
repr of their column's dtype) and an empty field for NaN. It writes with
`csv`, so it needs no pandas. CLIP and FID need locally provided weights;
without `--clip_model_dir` the CLIP columns are NaN, without
`--inception_model_dir` the FID columns (both logged). A metric computed
from weights that comes out NaN is logged as a warning. `--clip_model_dir`
without `transformers` installed fails at once.
"""
from __future__ import annotations

import argparse
import csv
import logging
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import check_device
from voxe_tpu_torch.evaluation.metrics_lib import (
    ClipScorer,
    InceptionEmbedder,
    avg_clip_directional_sim,
    avg_clip_text_sim,
    fid_between_folders,
    get_images,
    get_psnrs,
    load_prompt,
    remove_word_from_filenames,
)
from voxe_tpu_torch.utils.logging import log

COLUMNS = ["text CLIP", "dir CLIP", "FID recon", "FID input", "PSNR recon"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a = p.add_argument
    a("-d", "--result_folder", required=True, help="path to result folder")
    a("--clip_model_dir", default=None,
      help="local CLIP ViT-B/32 snapshot (transformers format); CLIP columns NaN without it")
    a("--inception_model_dir", default=None, help="dir containing inception_v3.pth; FID columns NaN without it")
    a("--device", default="cuda", help="device the embedders run on (cuda or cpu)")
    return p


def _column_fields(values: Sequence) -> List[str]:
    """A column's fields as pandas' `to_csv` prints them: a column of only
    np.float32 values keeps float32 (its shortest repr), any other is
    float64; NaN is an empty field."""
    as_f32 = len(values) > 0 and all(isinstance(v, np.float32) for v in values)
    return ["" if math.isnan(v) else (str(v) if as_f32 else repr(float(v))) for v in values]


def write_metrics_csv(path: Path, tables: Sequence[tuple]) -> None:
    """`tables`: (scene title, prompt folder names, {column: values})."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        for title, prompts, rows in tables:
            f.write(title + "\n")
            writer.writerow([""] + COLUMNS)
            fields = [_column_fields(rows[c]) for c in COLUMNS]
            for i, prompt in enumerate(prompts):
                writer.writerow([prompt] + [col[i] for col in fields])
            f.write("\n")


def _warn_nan(scene: str, prompt: str, column: str, value: float) -> float:
    if math.isnan(value):
        log.warning(f"{scene}/{prompt}: {column} came out NaN from the given weights")
    return value


def scene_metrics(scene_dir: Path, clip_scorer: Optional[ClipScorer], embedder: Optional[InceptionEmbedder]):
    """(prompt folder names, {column: values}) of one scene."""
    remove_word_from_filenames(scene_dir, "color_")
    recon_path, input_path = scene_dir / "recon", scene_dir / "inputs"
    recon_imgs = get_images(recon_path)
    if clip_scorer is not None:
        clip_recon_img_features = clip_scorer.image_features(recon_imgs)
        clip_input_features = clip_scorer.text_features(load_prompt(recon_path))
    rows: Dict[str, list] = {c: [] for c in COLUMNS}
    prompts = []
    for prompt_dir_name in sorted(os.listdir(scene_dir)):
        if prompt_dir_name in ("inputs", "recon"):
            continue
        prompt_dir = scene_dir / prompt_dir_name
        if not prompt_dir.is_dir():
            continue
        prompts.append(prompt_dir_name)
        output_imgs = get_images(prompt_dir)
        for column, ref_path in (("FID recon", recon_path), ("FID input", input_path)):
            fid = fid_between_folders(prompt_dir, ref_path, embedder)
            rows[column].append(fid if embedder is None else _warn_nan(scene_dir.name, prompt_dir_name, column, fid))
        rows["PSNR recon"].append(get_psnrs(output_imgs, recon_imgs))
        if clip_scorer is not None:
            out_text_features = clip_scorer.text_features(load_prompt(prompt_dir))
            out_img_features = clip_scorer.image_features(output_imgs)
            sims = (avg_clip_text_sim(out_img_features, out_text_features),
                    avg_clip_directional_sim(clip_input_features, clip_recon_img_features, out_text_features,
                                             out_img_features))
            for column, value in zip(("text CLIP", "dir CLIP"), sims):
                rows[column].append(_warn_nan(scene_dir.name, prompt_dir_name, column, value))
        else:
            rows["text CLIP"].append(float("nan"))
            rows["dir CLIP"].append(float("nan"))
    return prompts, rows


def main(argv: Optional[Sequence[str]] = None) -> Path:
    config = build_parser().parse_args(argv)
    check_device(config.device)
    if config.clip_model_dir:
        try:
            import transformers  # noqa: F401
        except ImportError as e:
            raise RuntimeError("--clip_model_dir needs the transformers package, which is not installed") from e
    result_path = Path(config.result_folder)
    clip_scorer = ClipScorer(Path(config.clip_model_dir), config.device) if config.clip_model_dir else None
    embedder = InceptionEmbedder(Path(config.inception_model_dir), config.device) if config.inception_model_dir \
        else None
    if clip_scorer is None:
        log.info("no CLIP weights given -> CLIP columns will be NaN")
    if embedder is None:
        log.info("no Inception weights given -> FID columns will be NaN")

    tables = []
    for scene_dir_name in sorted(os.listdir(result_path)):
        scene_dir = result_path / scene_dir_name
        if scene_dir.is_file():
            continue
        tables.append((scene_dir_name, *scene_metrics(scene_dir, clip_scorer, embedder)))
    output_csv_path = result_path / "output_metrics.csv"
    write_metrics_csv(output_csv_path, tables)
    log.info(f"metrics written to {output_csv_path}")
    return output_csv_path


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()
