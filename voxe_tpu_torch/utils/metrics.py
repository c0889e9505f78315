"""Image quality metrics: MSE, PSNR and windowed SSIM
(counterpart of voxe_tpu/utils/metrics.py)."""
import math

import torch
import torch.nn.functional as F


def mse(pred, target):
    return torch.mean((torch.as_tensor(pred) - torch.as_tensor(target)) ** 2)


def mse2psnr(mse_value):
    return -10.0 * torch.log(torch.as_tensor(mse_value) + 1e-12) / math.log(10.0)


def psnr(pred, target):
    return mse2psnr(mse(pred, target))


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03):
    """Windowed SSIM over [H, W, C] images: separable gaussian window, valid
    padding, the usual skimage/tf constants."""
    img0 = torch.as_tensor(img0, dtype=torch.float32)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
    if img0.dim() == 2:
        img0, img1 = img0[..., None], img1[..., None]
    hw = filter_size // 2
    offsets = torch.arange(-hw, hw + 1, dtype=torch.float32, device=img0.device)
    g = torch.exp(-0.5 * (offsets / filter_sigma) ** 2)
    g = g / g.sum()

    def blur(x):  # [H, W, C] -> [H', W', C], per channel
        x = x.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
        x = F.conv2d(x, g.reshape(1, 1, -1, 1))
        x = F.conv2d(x, g.reshape(1, 1, 1, -1))
        return x[:, 0].permute(1, 2, 0)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = blur(img0 * img0) - mu00
    sigma11 = blur(img1 * img1) - mu11
    sigma01 = blur(img0 * img1) - mu01
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    numerator = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denominator = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(numerator / denominator)
