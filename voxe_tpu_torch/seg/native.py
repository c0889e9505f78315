"""The native (C++) segmentation backend, built with g++ and bound with
ctypes (counterpart of voxe_tpu/seg/native.py).

The sources are the port's own copies under `voxe_tpu_torch/csrc/seg/`:
Boykov-Kolmogorov max-flow (`bk_maxflow.cpp`), Dinic's max-flow for
cross-checks (`maxflow.cpp`) and 26/18/6-connected component labelling
(`components.cpp`). They are compiled at first use with
`g++ -O3 -shared -fPIC` into `voxe_tpu_torch/_build/`, named by the hash of
the sources so a changed source rebuilds; the library is written to a
process-unique temporary file and moved into place with `os.replace`, so
concurrent first uses never load a half-written file. A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SEG_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "seg"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("maxflow.cpp", "bk_maxflow.cpp", "components.cpp")

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the sources (once per source content); returns the library."""
    digest = hashlib.sha256(b"".join((SEG_SRC_DIR / s).read_bytes() for s in SOURCES)).hexdigest()[:12]
    lib_path = BUILD_DIR / f"libvoxeseg-{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *[str(SEG_SRC_DIR / s) for s in SOURCES], "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            mincut_args = [
                ctypes.c_int32, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            for name in ("maxflow_mincut", "bk_maxflow_mincut"):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_double, mincut_args
            lib.largest_k_components.restype = ctypes.c_int32
            lib.largest_k_components.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def maxflow_mincut(num_nodes, edge_u, edge_v, cap, cap_rev, cap_src, cap_snk, algo: str = "bk"):
    """Min cut of a graph given as flat arrays; returns (flow, labels
    [num_nodes] uint8, 0 = source / edit side). "bk" is Boykov-Kolmogorov
    (the algorithm of the reference's PyMaxflow), "dinic" the cross-check."""
    lib = get_lib()
    entry = lib.bk_maxflow_mincut if algo == "bk" else lib.maxflow_mincut
    edge_u = np.ascontiguousarray(edge_u, dtype=np.int32)
    edge_v = np.ascontiguousarray(edge_v, dtype=np.int32)
    cap, cap_rev, cap_src, cap_snk = (
        np.ascontiguousarray(x, dtype=np.float32) for x in (cap, cap_rev, cap_src, cap_snk)
    )
    labels = np.zeros(num_nodes, dtype=np.uint8)
    flow = entry(
        num_nodes, len(edge_u),
        _ptr(edge_u, ctypes.c_int32), _ptr(edge_v, ctypes.c_int32),
        _ptr(cap, ctypes.c_float), _ptr(cap_rev, ctypes.c_float),
        _ptr(cap_src, ctypes.c_float), _ptr(cap_snk, ctypes.c_float),
        _ptr(labels, ctypes.c_uint8),
    )
    return flow, labels


def largest_k(volume: np.ndarray, k: int = 10, connectivity: int = 26):
    """cc3d.largest_k-style labelling: the i-th largest component gets label
    k - i + 1 (the largest k), 0 elsewhere. Returns (labels, components)."""
    volume = np.ascontiguousarray(volume.astype(np.uint8))
    X, Y, Z = volume.shape
    labels = np.zeros(volume.shape, dtype=np.int32)
    n = get_lib().largest_k_components(
        _ptr(volume, ctypes.c_uint8), X, Y, Z, connectivity, k, _ptr(labels, ctypes.c_int32)
    )
    return labels, n
