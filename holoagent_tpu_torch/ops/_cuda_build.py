"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``_build/``
(keyed by a hash of the source and the flags), and loaded with ``ctypes``.
Nothing here runs when a module is imported: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class CudaLibrary:
    """One kernel source and its C entry points.  ``signatures`` maps each
    entry point to its ctypes argument types; every entry point returns the
    ``cudaError_t`` of its launch as an int."""

    def __init__(self, source: str, signatures: Dict[str, Sequence]):
        self.source = CSRC / source
        self.signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Build output, keyed by a hash of the source and the flags."""
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def build(self) -> Path:
        """Compile the source unless this exact source is already built.
        Writes the compiler's resource report (``-Xptxas -v``) beside the
        library.  Returns the library path."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        out.with_suffix(".log").write_text(r.stdout + r.stderr)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def check_input(x: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless `x` is a CUDA tensor of `dtype`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; all inputs must share the CUDA device")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")


def aligned_contiguous(x: torch.Tensor) -> torch.Tensor:
    """`x`, contiguous and 16-byte aligned (a copy when it is not)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def kernel_input(x: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
    """A CUDA tensor of `dtype`, contiguous and 16-byte aligned (a copy when
    it is not); raises on any other device or type."""
    check_input(x, name, dtype)
    return aligned_contiguous(x)


def launch(wrapper, key: tuple, stream: torch.cuda.Stream, entry, *args) -> None:
    """Launch one C entry point on ``stream``, raise if it reports an error,
    and count the launch in ``wrapper.launches``.  While ``wrapper.trace``
    is a list, append ``(key, start, end)``: CUDA events around the launch,
    so a caller can time the kernel inside a larger run without
    synchronising."""
    trace = wrapper.trace
    if trace is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
    err = entry(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    if trace is not None:
        end.record(stream)
        trace.append((key, start, end))
