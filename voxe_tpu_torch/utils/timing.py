"""Per-frame timing of the camera-path renders.

`render_frames` is the one loop that every camera-path route runs: it calls
the route's per-pose render, marks the end of each frame, stacks the frames
and logs their times (`frame_ms`). On a card a frame's time is the time
between two CUDA events on the stream, with no sync inside the loop: for a
route that keeps its frames on the device (both colour routes, and the
shear-warp attention route) that is the device time a frame takes; a route
that finishes each frame on the host (the exact attention routes) waits for
its fetch inside the frame. On the CPU every operation finishes before the
next starts, and the host clock is read.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from voxe_tpu_torch.utils.logging import log


class FrameClock:
    """Marks on a card's stream (CUDA events, read once after the last one
    has completed) or on the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = [self._now()]

    def _now(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def tick(self) -> None:
        self.marks.append(self._now())

    def ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _stack(parts) -> np.ndarray:
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts).cpu().numpy()
    return np.stack(parts)


def render_frames(poses, render_one, device, what: str) -> list:
    """`render_one(pose)` gives a tuple of frame parts for each pose, as
    tensors on `device` or as host arrays; returns one stacked host array
    a part (device tensors are fetched once, at the end) and logs each
    frame's ms."""
    clock, outs = FrameClock(device), []
    for idx, pose in enumerate(poses):
        log.debug(f"rendering {what} frame {idx + 1}/{len(poses)}")
        outs.append(render_one(pose))
        clock.tick()
    stacked = [_stack(parts) for parts in zip(*outs)]
    frame_ms = clock.ms()
    log.info(f"{what} camera path: {len(frame_ms)} frames, median {float(np.median(frame_ms)):.2f} ms a frame",
             extra={"frame_ms": frame_ms})
    return stacked
