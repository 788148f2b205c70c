"""Shared kernel utilities: device resolution, padding, and the nvcc build.

Kernels are CUDA C++ sources under ``<kernel>/csrc/`` with a plain C
interface.  They are compiled at first use with ``nvcc`` for ``sm_90a``
into ``build/`` at the repository root and loaded with ``ctypes``; a
library's file name carries the hash of its source and of the headers
beside it, so an edited source or header is rebuilt and a stale library
is never loaded.  :func:`build_all` starts one ``nvcc`` per source at
once, so a cold start pays for the slowest build, not for their sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# every kernel source of the port, by library name
SOURCES: Dict[str, Path] = {
    "csr_lookup": Path(__file__).parent / "csr_lookup" / "csrc"
    / "csr_lookup.cu",
    "knrm_pool": Path(__file__).parent / "knrm_pool" / "csrc"
    / "knrm_pool.cu",
    "seg_interact": Path(__file__).parent / "seg_interact" / "csrc"
    / "seg_interact.cu",
    "flash_attn": Path(__file__).parent / "flash_attn" / "csrc"
    / "flash_attn.cu",
    "flash_attn_bwd": Path(__file__).parent / "flash_attn" / "csrc"
    / "flash_attn_bwd.cu",
    "embed_bag": Path(__file__).parent / "embed_bag" / "csrc"
    / "embed_bag.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent —
    the port never falls back to the CPU on its own; callers that want
    the CPU (the tests) say so with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def pad_to(x: torch.Tensor, axis: int, multiple: int,
           value: float = 0) -> torch.Tensor:
    """Pad the end of ``axis`` of ``x`` with ``value`` up to a multiple
    of ``multiple``."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths, value=value)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _lib_path(name: str) -> Path:
    """The library's file, named by a hash of its source, the headers
    beside it (``*.cuh``) and the flags."""
    src = SOURCES[name]
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[tuple] = None) -> Dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: ptxas report}``
    for the sources compiled by this call; raises on a failed build."""
    names = tuple(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load_library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use.
    ``signatures`` maps each launch function to its ctypes argument
    types; every launch function returns its ``cudaError_t`` as int."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.kernel_error_string(rc).decode()}")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      device: torch.device, ndim: int) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has {t.ndim} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the kernels' launch stream."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
