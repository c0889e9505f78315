"""LPIPS-VGG perceptual distance for the held-out evaluation (counterpart of
voxe_tpu/models/lpips.py).

The VGG16 feature stack is built here with torchvision's layer indices for
`vgg16().features`, so a torchvision-layout state dict loads directly; the
per-layer linear heads load from the lpips package's checkpoint layout.
Weights load only from a local directory:

    <weights_dir>/vgg16.pth        torchvision VGG16 state dict: the full
                                   model's (`features.*` keys, `classifier.*`
                                   ignored) or the features' alone
    <weights_dir>/lpips_vgg.pth    lpips 'vgg' heads (lin0..lin4 .model.1.weight)

The network runs on the device of the images it is given. Without weights
the tester reports PSNR and SSIM only (`try_load_lpips` returns None).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from voxe_tpu_torch.utils.logging import log

# torchvision vgg16 feature indices: conv/ReLU pairs with maxpools at
# 4/9/16/23/30; LPIPS taps the stack after relu1_2/2_2/3_3/4_3/5_3
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
_VGG_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def build_vgg16_features() -> nn.Sequential:
    """A Sequential with the indices and shapes of torchvision's
    `vgg16().features`."""
    layers, in_ch = [], 3
    for v in _VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers += [nn.Conv2d(in_ch, v, kernel_size=3, padding=1), nn.ReLU(inplace=True)]
            in_ch = v
    return nn.Sequential(*layers)


def _features_state(state: dict) -> dict:
    """A full torchvision vgg16 state dict or a features-only one."""
    if any(k.startswith("features.") for k in state):
        return {k[len("features."):]: v for k, v in state.items() if k.startswith("features.")}
    return state


class LPIPS:
    def __init__(self, weights_dir: Path):
        weights_dir = Path(weights_dir)
        features = build_vgg16_features()
        state = torch.load(weights_dir / "vgg16.pth", map_location="cpu", weights_only=True)
        features.load_state_dict(_features_state(state), strict=True)
        self.features = features.eval()
        lin_state = torch.load(weights_dir / "lpips_vgg.pth", map_location="cpu", weights_only=True)
        # lpips stores its 1x1 conv heads as lin{i}.model.1.weight [1, C, 1, 1]
        self.lins = []
        for i in range(len(_VGG_SLICES)):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if key in lin_state:
                    self.lins.append(lin_state[key].float())
                    break
            else:
                raise KeyError(f"lin{i} head not found in lpips_vgg.pth")

    def _to(self, device: torch.device) -> None:
        if self.lins[0].device != device:
            self.features = self.features.to(device)
            self.lins = [lin.to(device) for lin in self.lins]

    def _feature_stack(self, x):
        feats, h = [], x
        for start, end in _VGG_SLICES:
            for layer in list(self.features)[start:end]:
                h = layer(h)
            feats.append(h)
        return feats

    @torch.no_grad()
    def __call__(self, img0, img1) -> float:
        """LPIPS distance between two [H, W, 3] images in [0, 1] (tensors,
        or arrays, which go to the CPU)."""
        img0, img1 = (torch.as_tensor(np.array(x, np.float32)) if not isinstance(x, torch.Tensor) else x
                      for x in (img0, img1))
        device = img0.device
        self._to(device)
        shift = torch.from_numpy(_SHIFT).to(device).view(1, 3, 1, 1)
        scale = torch.from_numpy(_SCALE).to(device).view(1, 3, 1, 1)

        def prep(img):
            t = img.to(device, torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0  # lpips input range
            return (t - shift) / scale

        total = 0.0
        for a, b, lin in zip(self._feature_stack(prep(img0)), self._feature_stack(prep(img1)), self.lins):
            an = a / (a.norm(dim=1, keepdim=True) + 1e-10)
            bn = b / (b.norm(dim=1, keepdim=True) + 1e-10)
            total += F.conv2d((an - bn) ** 2, lin).mean(dim=(2, 3)).item()
        return float(total)


def try_load_lpips(weights_dir) -> "LPIPS | None":
    """LPIPS from `weights_dir`, or None (with a log line) when it does not
    load."""
    if weights_dir is None:
        return None
    try:
        return LPIPS(Path(weights_dir))
    except Exception as e:
        log.info(f"LPIPS unavailable ({e}); falling back to SSIM")
        return None
