"""Posed-images dataset: an images dir + a `*_camera_params.json`
(counterpart of voxe_tpu/data/dataset.py, eager mode).

Images decode once with Pillow (resized with `Image.BILINEAR` when a
downsample factor asks for it, exactly as the JAX package does) into a
[N, H, W, 3] float32 array: in RAM, or, with `cache_backing="memmap"` (and
with "auto" when the decoded scene exceeds `max_ram_gib`), into a
`np.memmap` in a temporary file. A RAM-backed scene goes to the dataset's
device once (`device_arrays()`); a memmap-backed one is `streaming`: the
trainers gather each step's pixels on the host (`sample_pixels`). Batches
are index arrays drawn from a numpy Generator.
"""
from __future__ import annotations

import json
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from voxe_tpu_torch.data.constants import (
    BOUNDS,
    DIRECTION,
    EXTRINSIC,
    FOCAL,
    HEIGHT,
    INTRINSIC,
    ROTATION,
    TRANSLATION,
    WIDTH,
)
from voxe_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    CameraPose,
    adjust_dynamic_range,
)
from voxe_tpu_torch.utils.logging import log


class PosedImagesDataset:
    def __init__(
        self,
        images_dir: Path,
        camera_params_json: Path,
        image_data_range: Tuple[float, float] = (0.0, 1.0),
        normalize_scene_scale: bool = False,
        downsample_factor: float = 1.0,
        rgba_white_bkgd: bool = False,
        directional: bool = False,
        cache_on_device: bool = True,
        cache_backing: str = "auto",
        max_ram_gib: float = 4.0,
        device="cuda",
    ) -> None:
        """`device` holds the images when `cache_on_device` (else the CPU).
        `cache_backing`: "ram", "memmap" (decode to disk: bounded host RAM)
        or "auto" (memmap above `max_ram_gib` of decoded float32)."""
        images_dir, camera_params_json = Path(images_dir), Path(camera_params_json)
        if not images_dir.exists():
            raise FileNotFoundError(f"Images dir doesn't exist: {images_dir}")
        if not camera_params_json.exists():
            raise FileNotFoundError(f"CameraParams file doesn't exist: {camera_params_json}")

        self.directional = directional
        self._images_dir = images_dir
        self._camera_params_json = camera_params_json
        self._image_data_range = tuple(image_data_range)
        self._normalize_scene_scale_bool = normalize_scene_scale
        self._downsample_factor = downsample_factor
        self._rgba_white_bkgd = rgba_white_bkgd
        self._cache_on_device = cache_on_device
        self._requested_cache_backing = cache_backing
        self._max_ram_gib = max_ram_gib
        self._device = device

        with open(camera_params_json) as f:
            self._camera_parameters: Dict[str, Any] = json.load(f)
        # keep only images that have a pose (membership, not count)
        self._image_file_paths = [
            p for p in sorted(images_dir.iterdir()) if p.name in self._camera_parameters
        ]
        self._camera_bounds = self._setup_camera_bounds()
        self._camera_intrinsics = self._setup_camera_intrinsics()
        if normalize_scene_scale:
            self._normalize_scene_scale()

        n = len(self._image_file_paths)
        h, w = self._camera_intrinsics.height, self._camera_intrinsics.width
        decoded_gib = n * h * w * 3 * 4 / 1024**3
        backing = cache_backing
        if backing == "auto":
            backing = "memmap" if decoded_gib > max_ram_gib else "ram"
        if backing not in ("ram", "memmap"):
            raise ValueError(f"cache_backing must be 'ram', 'memmap' or 'auto', got {cache_backing!r}")
        self._streaming = backing == "memmap"
        self._memmap_file = None
        if self._streaming:
            self._memmap_file = tempfile.NamedTemporaryFile(prefix="voxe_dataset_", suffix=".mm")
            self._images = np.memmap(self._memmap_file.name, dtype=np.float32, mode="w+", shape=(n, h, w, 3))
            log.info(f"dataset: {decoded_gib:.2f} GiB decoded -> memmap cache ({self._memmap_file.name}); "
                     "trainers stream per-step pixel batches")
        else:
            self._images = np.empty((n, h, w, 3), dtype=np.float32)
        poses, directions = [], []
        for i, path in enumerate(self._image_file_paths):
            with Image.open(path) as im:
                img = self._process_image(im)
            if self._image_data_range != (0.0, 1.0):
                img = adjust_dynamic_range(img, (0.0, 1.0), self._image_data_range)
            self._images[i] = img
            params = self._camera_parameters[path.name]
            pose = self.extract_pose(params)
            poses.append(np.hstack((pose.rotation, pose.translation)))
            if directional:
                directions.append(str(params[DIRECTION]))
        self._poses = np.stack(poses).astype(np.float32)  # [N, 3, 4]
        self._directions: Optional[List[str]] = directions if directional else None
        self._device_arrays = None
        log.info(f"PosedImagesDataset: {n} images at [{h} x {w}]")

    @property
    def images(self) -> np.ndarray:
        """[N, H, W, 3] float32 (host; a memmap when streaming: index it)."""
        return self._images

    @property
    def poses(self) -> np.ndarray:
        """[N, 3, 4] float32 rows of [R | t] (host)."""
        return self._poses

    @property
    def directions(self) -> Optional[List[str]]:
        return self._directions

    @property
    def streaming(self) -> bool:
        """True when the decoded scene is memmap-backed: trainers gather each
        step's pixels on the host instead of caching the scene on the device."""
        return self._streaming

    def sample_pixels(self, flat_indices: np.ndarray, image_indices: np.ndarray) -> np.ndarray:
        """[R, 3] float32 pixels gathered on the host: pixel `flat_indices[k]`
        (row-major in its frame) of frame `image_indices[k]`."""
        w = self._camera_intrinsics.width
        rows, cols = flat_indices // w, flat_indices % w
        return np.ascontiguousarray(self._images[image_indices, rows, cols]).astype(np.float32)

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(images, poses) as tensors on the dataset's device (once); a
        streaming dataset refuses."""
        if self._streaming:
            raise RuntimeError(
                "streaming (memmap-backed) dataset: the decoded scene exceeds the cache budget; "
                "use sample_pixels() and the poses per step instead of caching the scene on the device"
            )
        if self._device_arrays is None:
            dev = self._device if self._cache_on_device else "cpu"
            self._device_arrays = (
                torch.from_numpy(self._images).to(dev), torch.from_numpy(self._poses).to(dev)
            )
        return self._device_arrays

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None) -> Iterator[np.ndarray]:
        """Infinite iterator over shuffled index batches."""
        rng = rng or np.random.default_rng()
        n = len(self)
        batch_size = min(batch_size, n)
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield perm[i : i + batch_size]

    @property
    def camera_bounds(self) -> CameraBounds:
        return self._camera_bounds

    @property
    def camera_intrinsics(self) -> CameraIntrinsics:
        return self._camera_intrinsics

    @property
    def camera_parameters(self) -> Dict[str, Any]:
        return self._camera_parameters

    def get_config_dict(self) -> Dict[str, Any]:
        return {
            "images_dir": self._images_dir,
            "camera_params_json": self._camera_params_json,
            "image_data_range": self._image_data_range,
            "normalize_scene_scale": self._normalize_scene_scale_bool,
            "downsample_factor": self._downsample_factor,
            "rgba_white_bkgd": self._rgba_white_bkgd,
            "directional": self.directional,
            "cache_on_device": self._cache_on_device,
            "cache_backing": self._requested_cache_backing,
            "max_ram_gib": self._max_ram_gib,
            "device": self._device,
        }

    def _normalize_scene_scale(self) -> None:
        """Scale camera locations into the unit-norm ball."""
        all_locations = np.concatenate(
            [self.extract_pose(p).translation for p in self._camera_parameters.values()], axis=-1
        )
        max_norm = float(np.max(np.linalg.norm(all_locations, axis=0)))
        for params in self._camera_parameters.values():
            translation = params[EXTRINSIC][TRANSLATION]
            for row in range(3):
                translation[row][0] = str(float(translation[row][0]) / max_norm)
        self._camera_bounds = CameraBounds(
            self._camera_bounds.near / max_norm, self._camera_bounds.far / max_norm
        )

    def get_hemispherical_radius_estimate(self) -> float:
        """Mean camera-origin norm."""
        locations = np.squeeze(
            np.array([p[EXTRINSIC][TRANSLATION] for p in self._camera_parameters.values()]).astype(np.float32)
        )
        return float(np.linalg.norm(locations, axis=-1).mean())

    def _setup_camera_bounds(self) -> CameraBounds:
        all_bounds = np.vstack(
            [np.array(p[INTRINSIC][BOUNDS]).astype(np.float32) for p in self._camera_parameters.values()]
        )
        return CameraBounds(float(all_bounds.min() * 0.9), float(all_bounds.max() * 1.1))

    def _setup_camera_intrinsics(self) -> CameraIntrinsics:
        all_intrinsics = np.vstack(
            [
                np.array([p[INTRINSIC][HEIGHT], p[INTRINSIC][WIDTH], p[INTRINSIC][FOCAL]]).astype(np.float32)
                for p in self._camera_parameters.values()
            ]
        )
        if not np.all(all_intrinsics == all_intrinsics[0, :]):
            raise ValueError("all cameras must share intrinsics")
        height, width, focal = all_intrinsics[0, :] / self._downsample_factor
        return CameraIntrinsics(int(height), int(width), float(focal))

    def _process_image(self, image: Image.Image) -> np.ndarray:
        """Decode -> resize -> RGBA handling -> [H, W, 3] float32 in [0, 1]."""
        target = (self._camera_intrinsics.width, self._camera_intrinsics.height)
        if image.size != target:
            image = image.resize(target, Image.BILINEAR)
        arr = np.asarray(image).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.shape[-1] == 4:
            rgb, alpha = arr[..., :3], arr[..., 3:]
            arr = rgb * alpha + (1.0 - alpha) if self._rgba_white_bkgd else rgb * alpha
        elif arr.shape[-1] > 3:
            arr = arr[..., :3]
        return arr

    @staticmethod
    def extract_pose(camera_params: Dict[str, Any]) -> CameraPose:
        rotation = np.array(camera_params[EXTRINSIC][ROTATION]).astype(np.float32)
        translation = np.array(camera_params[EXTRINSIC][TRANSLATION]).astype(np.float32)
        return CameraPose(rotation, translation)

    def __len__(self) -> int:
        return len(self._image_file_paths)
