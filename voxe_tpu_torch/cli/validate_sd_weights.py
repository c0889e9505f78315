"""CLI: validate (and smoke-test) a local Stable Diffusion weights directory
with the PyTorch port (counterpart of tools/validate_sd_weights.py: the same
flags, parsed with argparse, plus `--device`).

    python -m voxe_tpu_torch.cli.validate_sd_weights -d sd2_snapshot \\
        [--sd_version 2.0] [--sanity_image sanity.png] [--device cpu]
    python -m voxe_tpu_torch.cli.validate_sd_weights --sd_version tiny \\
        --sanity_image sanity.png --sanity_steps 2 --device cpu

Loads an HF snapshot (unet/, vae/, text_encoder/, tokenizer/) through the
port's loader (`--sd_version tiny` needs no snapshot: seeded random tiny
weights), logs the parameter count and the tokenizer, and with `--run_smoke`
takes one SDS gradient of a 64x64 image and requires it finite.
`--sanity_image` runs text-to-image sampling (tokenize, CLIP,
`--sanity_steps` DDIM steps, VAE decode), requires the float latents and
pixels finite, and writes the image as a PNG.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.cli.train_sh_based_voxel_grid_with_posed_images import _bool, check_device
from voxe_tpu_torch.models.sd.sds import StableDiffusion
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.timing import FrameClock


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="validate a local SD weights directory (PyTorch port)")
    a = p.add_argument
    a("-d", "--weights_dir", default=None, help="HF snapshot directory (optional for --sd_version tiny)")
    a("--sd_version", default="2.0")
    a("--run_smoke", type=_bool, default=True, help="run a 64x64 SDS gradient after loading")
    a("--sanity_image", default=None, help="run text-to-image sampling and write the image here (PNG)")
    a("--sanity_prompt", default="a photograph of an astronaut riding a horse")
    a("--sanity_steps", type=int, default=50, help="DDIM inference steps for --sanity_image")
    a("--device", default="cuda", help="torch device of the models")
    return p


def _require_finite(x: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{what} — the staged weights are corrupt or mis-converted")


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    """Load, smoke-test and sample; returns the sanity image (uint8
    [H, W, 3]) when one was asked for."""
    parser = build_parser()
    config = parser.parse_args(argv)
    if config.weights_dir is None and config.sd_version != "tiny":
        parser.error("--weights_dir is required unless --sd_version tiny (random init)")
    check_device(config.device)
    weights_dir = Path(config.weights_dir) if config.weights_dir else None
    sd = StableDiffusion(config.sd_version, weights_dir=weights_dir, device=config.device)
    n_params = sum(p.numel() for m in sd.networks() for p in m.parameters())
    log.info(f"conversion OK: {n_params / 1e6:.1f}M parameters loaded")
    log.info(f"tokenizer: {type(sd.tokenizer).__name__}")
    ids = sd.tokenizer("a photo of a dog")[0]
    log.info(f"tokenized sample: first ids {ids[:6].tolist()}")

    if config.run_smoke:
        emb = sd.get_text_embeds("a photo of a dog", "")
        pred_rgb = torch.full((1, 64, 64, 3), 0.5, device=sd.device, requires_grad=True)
        gen = torch.Generator(device=sd.device).manual_seed(0)
        sd.sds_loss(emb, pred_rgb, 500, 100.0, generator=gen).backward()
        _require_finite(pred_rgb.grad, "non-finite SDS gradients")
        g = pred_rgb.grad.abs()
        log.info(f"SDS smoke OK: grad mean|.|={float(g.mean()):.3e} (finite, non-zero={float(g.sum()) > 0})")

    if config.sanity_image is None:
        log.info("weights directory is ready for --sd_weights_dir")
        return None
    log.info(f"sampling sanity image ({config.sanity_steps} DDIM steps): {config.sanity_prompt!r}")
    # the stages run one by one so that finiteness is checked on the FLOAT
    # latents and pixels, before the uint8 cast hides a NaN
    text_embeds = sd.get_text_embeds(config.sanity_prompt, "")
    gen = torch.Generator(device=sd.device).manual_seed(0)
    latents = sd.produce_latents(text_embeds, gen, num_inference_steps=config.sanity_steps)
    _require_finite(latents, "DDIM sampling produced non-finite latents")
    clock = FrameClock(sd.device)
    imgs_f = sd.decode_latents(latents)
    clock.tick()
    decode_ms = clock.ms()[0]
    _require_finite(imgs_f, "VAE decode produced non-finite pixels")
    img = (imgs_f[0].permute(1, 2, 0).cpu().numpy() * 255).round().astype("uint8")
    out = Path(config.sanity_image)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(out)
    log.info(f"sanity image written: {out} ({img.shape[0]}x{img.shape[1]}), decode {decode_ms:.2f} ms",
             extra={"decode_ms": decode_ms})
    log.info("weights directory is ready for --sd_weights_dir")
    return img


if __name__ == "__main__":
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    main()
