"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own, with ``nvcc``, into a shared library with a
plain C interface that ``ctypes`` loads — no PyTorch headers, so a build takes
seconds rather than minutes. The library name carries a hash of the source and
the flags, so a stale library is never loaded; libraries land in
``build/kernels/`` at the root of the checkout, which ``.gitignore`` lists.

Nothing here runs at import: the first call to :func:`load` builds every
kernel source that has no library yet, all ``nvcc`` processes started
together, and prints each ``-Xptxas -v`` report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("dw_conv", "mbconv", "bn_bwd", "se")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
# Seconds of the builds this process ran, by source.
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that has no up-to-date library, in
    parallel. Raises with the compiler's output if any build fails."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        print(f"[build] {name}.cu: {build_seconds[name]:.1f} s, rc {proc.returncode}")
        print(log.rstrip())
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}; output above")


def load(name: str, prototypes: dict[str, tuple[list, type]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` and ``restype`` of each function in ``prototypes`` set."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn_name, (argtypes, restype) in prototypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call of ``what`` on ``tensors``: a
    kernel launched through ctypes returns a tensor with no ``grad_fn``, so
    everything upstream of it would silently get no gradient. The training
    route reaches the kernels through their ``torch.autograd.Function``s."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} launches a CUDA kernel that autograd cannot see, and an input "
            "requires grad: call it under torch.no_grad(), or through its "
            "autograd Function")
