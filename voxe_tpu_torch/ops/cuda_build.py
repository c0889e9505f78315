"""Build and load the port's hand-written CUDA kernels.

Each source under `voxe_tpu_torch/csrc/` is compiled by nvcc for sm_90a into
a shared library with a plain C interface, at first use, into
`voxe_tpu_torch/_build/` (gitignored), named by the hash of the source, so
it is rebuilt only when the source changes. The library is loaded with
ctypes; pointers and the stream go in as `c_void_p`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def nvcc() -> str:
    toolkit = Path("/usr/local/cuda/bin/nvcc")
    return str(toolkit) if toolkit.exists() else "nvcc"


class CudaLibrary:
    """One CUDA source and the C function it exports."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.src = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._fn = None
        self._lock = threading.Lock()
        self.report = None  # nvcc's output (ptxas' -v report) when this process built the library

    def build(self, verbose: bool = False) -> Path:
        """Compile the source (once per source content) and return the
        library path. `verbose` prints ptxas' report when a build happens."""
        digest = hashlib.sha256(self.src.read_bytes()).hexdigest()[:12]
        lib_path = BUILD_DIR / f"lib{self.src.stem}-{digest}.so"
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(self.src),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        self.report = proc.stdout + proc.stderr
        if verbose:
            print(self.report)
        os.replace(tmp, lib_path)
        return lib_path

    def function(self):
        """The exported C function (builds and loads on first call)."""
        with self._lock:
            if self._fn is None:
                self._fn = self.symbol_function(self.symbol, self.argtypes, ctypes.c_int)
        return self._fn

    def symbol_function(self, symbol: str, argtypes: Sequence, restype):
        """Another C function the same library exports (builds on first use)."""
        fn = getattr(ctypes.CDLL(str(self.build())), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


def ptxas_summary(report: str) -> dict:
    """{kernel entry (mangled): {"registers", "spill_stores", "spill_loads",
    "stack"}} from ptxas' -v report (bytes for the last three)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out
