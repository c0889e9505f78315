"""The inputs a cell hands to the program and to the reference alike, made
from `--seed` by plain code of the benchmark's own: the grid values, the
prompts' token ids, the token selections of the refinement and the recon
stage's posed training views."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.seeds import generator, host_rng

DIRECTIONS = 4  # side, overhead, back, front: the prompt's view word


def grid_values(seed: int, name: str, res: int, channels: int, device) -> torch.Tensor:
    """[res, res, res, channels] float32 values ~ U(-1, 1) of the stream
    `name`."""
    g = generator(seed, name, device)
    return torch.rand((res, res, res, channels), generator=g, device=g.device) * 2.0 - 1.0


def token_ids(seed: int, text: dict, prompt_tokens: int, device) -> torch.Tensor:
    """[4, 2, T] prompt ids, one (unconditional, conditional) pair a view
    direction: BOS, `prompt_tokens` ids of which the last two name the view
    (as ", side view" does), EOS, then EOS padding to the context length.
    The ids below the two specials are drawn from the seed."""
    vocab, length = int(text["vocab_size"]), int(text["max_position_embeddings"])
    bos, eos = vocab - 2, vocab - 1
    rng = host_rng(seed, "tokens")
    shared = rng.integers(0, vocab - 2, prompt_tokens - 2)
    views = rng.integers(0, vocab - 2, (DIRECTIONS, 2))
    ids = np.full((DIRECTIONS, 2, length), eos, np.int64)
    ids[:, :, 0] = bos
    for d in range(DIRECTIONS):
        ids[d, 1, 1:prompt_tokens + 1] = np.concatenate([shared, views[d]])
    return torch.as_tensor(ids, device=device)


def token_selection(prompt_tokens: int, edit_tokens, device):
    """(positions 1..n, edit mask, object mask) of an n-token prompt: the
    edit mask marks `edit_tokens`, the object mask every other token."""
    idxs = list(range(1, prompt_tokens + 1))
    emask = torch.tensor([1.0 if i in edit_tokens else 0.0 for i in idxs], device=device)
    return idxs, emask, 1.0 - emask


def hemisphere_pose(pitch_deg: float, yaw_deg: float, radius: float):
    """(rotation [3, 3], translation [3, 1]) float32 numpy camera-to-world
    pose: yaw about z after pitch about x, `radius` along the camera's z."""
    p, y = math.radians(pitch_deg), math.radians(yaw_deg)
    rp = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]])
    ry = np.array([[math.cos(y), -math.sin(y), 0], [math.sin(y), math.cos(y), 0], [0, 0, 1]])
    rot = ry @ rp
    return rot.astype(np.float32), (rot @ np.array([[0.0], [0.0], [radius]])).astype(np.float32)


def training_views(seed: int, views: dict, device):
    """The recon stage's posed views: images [N, H, W, 3] in [0, 1] (soft
    coloured discs on white, drawn on the device) and poses [N, 3, 4]
    (numpy) on the hemisphere, pitch 15-85 degrees."""
    n, size, radius = int(views["num_train_views"]), int(views["image_size"]), float(views["radius"])
    rng = host_rng(seed, "view_poses")
    poses = []
    for _ in range(n):
        rot, trans = hemisphere_pose(15.0 + 70.0 * rng.random(), 360.0 * rng.random(), radius)
        poses.append(np.concatenate([rot, trans], axis=1))
    g = generator(seed, "view_images", device)
    discs = int(views["discs"])
    centres = torch.rand((n, discs, 2), generator=g, device=g.device) * 0.6 + 0.2
    radii = torch.rand((n, discs, 1), generator=g, device=g.device) * 0.15 + 0.05
    colours = torch.rand((n, discs, 3), generator=g, device=g.device)
    axis = (torch.arange(size, device=centres.device, dtype=torch.float32) + 0.5) / size
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    pix = torch.stack([yy, xx], dim=-1)  # [H, W, 2]
    d2 = ((pix[None, None] - centres[:, :, None, None]) ** 2).sum(-1)  # [n, discs, H, W]
    alpha = torch.exp(-d2 / (2.0 * radii[..., None] ** 2))  # soft discs
    cover = 1.0 - torch.prod(1.0 - alpha, dim=1)  # [n, H, W]
    paint = (alpha[..., None] * colours[:, :, None, None]).sum(1) / alpha.sum(1).clamp(min=1e-6)[..., None]
    images = cover[..., None] * paint + (1.0 - cover[..., None])
    return images.contiguous(), np.stack(poses).astype(np.float32)
