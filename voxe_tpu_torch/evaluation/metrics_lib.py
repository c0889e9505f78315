"""Quality-metric library: CLIP similarities, FID, PSNR over image folders
(counterpart of evaluation/metrics_lib.py).

Rebuild of reference: evaluation/calculate_metrics.py:150-247. The embedders
(CLIP ViT-B/32, InceptionV3 for FID) need pretrained weights from a local
model directory (`--clip_model_dir` / `--inception_model_dir`: a
transformers CLIP snapshot, a torchvision `inception_v3.pth`). Without
weights the CLIP and FID columns are NaN; PSNR (pure math) is always
computed. Both embedders run on a `device`; on a CUDA card TF32 is off
inside them (`_full_f32`), so their features are f32 products as the CPU
computes them. The Frechet distance stays numpy/scipy on the host, as in the
JAX package. `transformers` is imported by `ClipScorer` only.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.utils.logging import log

INCEPTION_BATCH = 32  # images a forward pass on the Inception embedder


# ----------------------------------------------------------------------------------
# image IO
# ----------------------------------------------------------------------------------


def get_images(im_dir: Path) -> List[Image.Image]:
    ims = []
    for name in sorted(os.listdir(im_dir)):
        if name.endswith(".png"):
            ims.append(Image.open(Path(im_dir) / name).convert("RGB"))
    return ims


def remove_word_from_filenames(folder_path, word_to_remove):
    """(reference calculate_metrics.py:224-241)"""
    for root, _dirs, files in os.walk(folder_path):
        for filename in files:
            if word_to_remove in filename:
                new_name = os.path.join(root, filename).replace(word_to_remove, "")
                os.rename(os.path.join(root, filename), new_name)


# ----------------------------------------------------------------------------------
# PSNR (always available)
# ----------------------------------------------------------------------------------


def get_psnrs(out_imgs: Sequence[Image.Image], ref_imgs: Sequence[Image.Image]) -> float:
    """Mean PSNR over paired images at 400x400 (reference :150-162)."""
    total = 0.0
    for out_img, ref_img in zip(out_imgs, ref_imgs):
        a = np.asarray(out_img.resize((400, 400), Image.BILINEAR), np.float32) / 255.0
        b = np.asarray(ref_img.resize((400, 400), Image.BILINEAR), np.float32) / 255.0
        mse = np.mean((a - b) ** 2)
        total += -10.0 * np.log10(mse + 1e-12)
    return total / max(len(out_imgs), 1)


# ----------------------------------------------------------------------------------
# embedders
# ----------------------------------------------------------------------------------


@contextlib.contextmanager
def _full_f32(device: torch.device):
    """TF32 off for cuBLAS and cuDNN while an embedder runs on a card (both
    flags restored on exit), so its features are f32 products."""
    if device.type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class ClipScorer:
    """CLIP embedder backed by a local transformers snapshot, on `device`."""

    def __init__(self, model_dir: Path, device="cuda"):
        from transformers import CLIPModel, CLIPProcessor

        self.device = torch.device(device)
        self.model = CLIPModel.from_pretrained(str(model_dir)).to(self.device)
        self.processor = CLIPProcessor.from_pretrained(str(model_dir))
        self.model.eval()
        log.info(f"CLIP embedder on {self.device}")

    def _run(self, tower, projection, inputs) -> np.ndarray:
        """The projected pooled output of `tower`: what transformers 4's
        `get_{image,text}_features` return (transformers 5 wraps it in a
        model output), spelled out so either version gives the array."""
        inputs = {k: v.to(self.device) for k, v in inputs.items()}
        with torch.no_grad(), _full_f32(self.device):
            return projection(tower(**inputs).pooler_output).cpu().numpy()

    def image_features(self, imgs: Sequence[Image.Image]) -> np.ndarray:
        inputs = self.processor(images=list(imgs), return_tensors="pt")
        return self._run(self.model.vision_model, self.model.visual_projection, inputs)

    def text_features(self, prompt: str) -> np.ndarray:
        inputs = self.processor(text=[prompt], return_tensors="pt", padding=True, truncation=True)
        return self._run(self.model.text_model, self.model.text_projection, inputs)


def _normed(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def avg_clip_text_sim(img_features: np.ndarray, text_features: np.ndarray) -> float:
    """Mean cos-sim between each image feature and the prompt feature
    (reference :183-190)."""
    sims = _normed(img_features) @ _normed(text_features).T
    return float(sims.mean())


def avg_clip_directional_sim(
    ref_text_features: np.ndarray,
    ref_img_features: np.ndarray,
    out_text_features: np.ndarray,
    out_img_features: np.ndarray,
) -> float:
    """Directional CLIP similarity: (delta text) . (delta image)
    (reference :164-181)."""
    text_dir = _normed(ref_text_features) - _normed(out_text_features)
    total = 0.0
    for out_f, ref_f in zip(out_img_features, ref_img_features):
        im_dir = _normed(ref_f[None]) - _normed(out_f[None])
        total += float((text_dir @ im_dir.T).item())
    return total / len(out_img_features)


# ----------------------------------------------------------------------------------
# FID (Frechet distance on the host; embedder weight-gated)
# ----------------------------------------------------------------------------------


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two gaussians (standard FID formula)."""
    from scipy import linalg

    diff = mu1 - mu2
    try:
        covmean = linalg.sqrtm(sigma1 @ sigma2)
    except linalg.LinAlgError:  # singular product: retry with jitter below
        covmean = np.full_like(sigma1, np.nan)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class InceptionEmbedder:
    """Pool3 features from a local torchvision-layout InceptionV3 state dict
    (`model_dir/inception_v3.pth`, loaded strictly), on `device`. Images are
    resized and scaled on the host as in the JAX package, then embedded
    `INCEPTION_BATCH` at a time (eval-mode BatchNorm: each image's features
    do not depend on its batch)."""

    def __init__(self, model_dir: Path, device="cuda"):
        from voxe_tpu_torch.evaluation.inception import load_inception_v3

        self.device = torch.device(device)
        state = torch.load(Path(model_dir) / "inception_v3.pth", map_location="cpu", weights_only=True)
        self.model = load_inception_v3(state).to(self.device)
        log.info(f"Inception embedder on {self.device}")

    def features(self, imgs: Sequence[Image.Image]) -> np.ndarray:
        arrs = []
        for img in imgs:
            arr = np.asarray(img.resize((299, 299), Image.BILINEAR), np.float32)
            arrs.append((arr / 255.0 - 0.5) / 0.5)
        feats = []
        with torch.no_grad(), _full_f32(self.device):
            for start in range(0, len(arrs), INCEPTION_BATCH):
                batch = torch.from_numpy(np.stack(arrs[start:start + INCEPTION_BATCH])).permute(0, 3, 1, 2)
                feats.append(self.model.pool3_features(batch.to(self.device)).cpu().numpy())
        return np.concatenate(feats) if feats else np.zeros((0, 2048), np.float32)


def fid_between_folders(path_a: Path, path_b: Path, embedder: Optional[InceptionEmbedder]) -> float:
    if embedder is None:
        return float("nan")
    feats_a = embedder.features(get_images(path_a))
    feats_b = embedder.features(get_images(path_b))
    mu_a, sigma_a = feats_a.mean(0), np.cov(feats_a, rowvar=False)
    mu_b, sigma_b = feats_b.mean(0), np.cov(feats_b, rowvar=False)
    return frechet_distance(mu_a, sigma_a, mu_b, sigma_b)


def load_prompt(prompt_dir: Path) -> str:
    return (Path(prompt_dir) / "prompt.txt").read_text().splitlines()[0]

