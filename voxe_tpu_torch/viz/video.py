"""Video writing without ffmpeg or imageio (counterpart of
voxe_tpu/viz/video.py).

Frames are written as a Motion-JPEG AVI (RIFF) container, each frame a
Pillow JPEG at quality 92: the JAX package's muxer, byte for byte. The file
keeps the name the caller gives it (`rendered_video.mp4` for the reference's
output layout); players and ffmpeg sniff the content, not the extension.
`read_mjpeg_avi` reads such a file back.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image


def write_video(path: Path, frames: Sequence[np.ndarray], fps: int = 60) -> Path:
    """Write frames ([H, W, 3] uint8) as an MJPEG AVI. Returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_mjpeg_avi(path, [np.ascontiguousarray(f[..., :3]) for f in frames], fps)
    return path


def _encode_jpeg(frame: np.ndarray, quality: int = 92) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def _write_mjpeg_avi(path: Path, frames: Sequence[np.ndarray], fps: int) -> None:
    height, width = frames[0].shape[:2]
    jpegs = [_encode_jpeg(f) for f in frames]
    num_frames = len(jpegs)
    max_size = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I",
        int(1e6 / fps),  # dwMicroSecPerFrame
        max_size * fps,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        0x10,  # dwFlags: AVIF_HASINDEX
        num_frames,
        0,  # dwInitialFrames
        1,  # dwStreams
        max_size,  # dwSuggestedBufferSize
        width,
        height,
        0, 0, 0, 0,  # reserved
    )
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII",
        0,  # dwFlags
        0,  # wPriority
        0,  # wLanguage
        0,  # dwInitialFrames
        1,  # dwScale
        fps,  # dwRate
        0,  # dwStart
        num_frames,  # dwLength
        max_size,  # dwSuggestedBufferSize
        0xFFFFFFFF,  # dwQuality (default)
        0,  # dwSampleSize
    ) + struct.pack("<4h", 0, 0, width, height)  # rcFrame
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40,  # biSize
        width,
        height,
        1,  # planes
        24,  # bit count
        b"MJPG",
        width * height * 3,
        0, 0, 0, 0,
    )
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi = _list(b"movi", b"".join(_chunk(b"00dc", j) for j in jpegs))
    # idx1: offsets from the 'movi' list type's fourcc
    idx_entries, offset = [], 4
    for j in jpegs:
        idx_entries.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))
        offset += 8 + len(j) + (len(j) % 2)
    riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(idx_entries))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def read_mjpeg_avi(path: Path) -> Tuple[int, int, int, List[bytes]]:
    """(frames in the header, width, height, the JPEG of each `00dc` chunk of
    the `movi` list) of an MJPEG AVI; raises ValueError when the file is no
    RIFF/AVI with that layout."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI " or struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise ValueError(f"{path}: not a RIFF/AVI file")
    i = data.find(b"avih")
    if i < 0:
        raise ValueError(f"{path}: no avih header")
    num_frames, width, height = (struct.unpack("<I", data[i + 8 + 4 * k : i + 12 + 4 * k])[0] for k in (4, 8, 9))
    m = data.find(b"movi")
    if m < 8 or data[m - 8 : m - 4] != b"LIST":
        raise ValueError(f"{path}: no movi list")
    end = m + struct.unpack("<I", data[m - 4 : m])[0]
    pos, jpegs = m + 4, []
    while pos < end:
        fourcc, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        if fourcc == b"00dc":
            jpegs.append(data[pos + 8 : pos + 8 + size])
        pos += 8 + size + size % 2
    return num_frames, width, height, jpegs
