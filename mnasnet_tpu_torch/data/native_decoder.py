"""ctypes bindings for the native fused JPEG decoder (``native/fused_decoder.cpp``).

Counterpart of ``mnasnet_tpu/data/native_decoder.py``. The C++ source is the
one the JAX package builds; this module builds its own library from it, with
``g++ -O3 ... -ljpeg`` on first use, into ``build/native/`` at the root of the
checkout (which ``.gitignore`` lists). Callers catch
``NativeDecoderUnavailable`` (or check :func:`available`) and fall back to the
PIL transforms, which decode on the host too.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from mnasnet_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    random_resized_crop_params,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "fused_decoder.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "native", "libfuseddec.so")
_lock = threading.Lock()
_lib = None
# Why the library could not be loaded, for callers that report it.
unavailable_reason: str | None = None


class NativeDecoderUnavailable(RuntimeError):
    pass


def _arch_flag() -> list[str]:
    """Deterministic arch flags: processes sharing a checkout must build the
    same binary, and -march=native breaks when the library outlives its build
    host. On x86: x86-64-v3 if the CPU has AVX2, else the baseline; on other
    ISAs the compiler's default."""
    if platform.machine() not in ("x86_64", "AMD64", "i686"):
        return []
    try:
        with open("/proc/cpuinfo") as f:
            if " avx2" in f.read():
                return ["-march=x86-64-v3"]
    except OSError:
        pass
    return ["-march=x86-64"]


def _stale() -> bool:
    return not os.path.exists(_LIB) or (
        os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
    )


def _build() -> None:
    """Build the library safely under concurrency: an fcntl file lock
    serialises concurrent builds across processes, the compile writes a temporary
    file that is renamed into place, and the staleness check runs again
    under the lock so that waiters skip the rebuild."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    with open(_LIB + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not _stale():
                return
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_LIB), suffix=".so")
            os.close(fd)
            try:
                cmd = ["g++", "-O3", *_arch_flag(), "-shared", "-fPIC", _SRC, "-o", tmp,
                       "-ljpeg"]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except FileNotFoundError as e:
                    raise NativeDecoderUnavailable(f"g++ not found: {e}") from e
                if proc.returncode != 0:
                    raise NativeDecoderUnavailable(f"g++ build failed:\n{proc.stderr[-2000:]}")
                os.replace(tmp, _LIB)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            if not os.path.exists(_SRC):
                raise NativeDecoderUnavailable(f"source missing: {_SRC}")
            _build()
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:  # e.g. libjpeg missing at run time
            raise NativeDecoderUnavailable(f"cannot load {_LIB}: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_dims.argtypes = [u8p, ctypes.c_size_t, i32p, i32p]
        lib.jpeg_dims.restype = ctypes.c_int
        lib.fused_decode_eval.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            f32p, f32p, ctypes.c_int, f32p,
        ]
        lib.fused_decode_eval.restype = ctypes.c_int
        lib.fused_decode_train.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p, f32p, ctypes.c_int, f32p,
        ]
        lib.fused_decode_train.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads; if not, the reason is in
    :data:`unavailable_reason`."""
    global unavailable_reason
    try:
        _load()
        return True
    except NativeDecoderUnavailable as e:
        unavailable_reason = str(e)
        return False


_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STD = np.ascontiguousarray(IMAGENET_STD, np.float32)


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(buf: bytes):
    arr = np.frombuffer(buf, np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size


def jpeg_dims(jpeg: bytes) -> tuple[int, int]:
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    p, n = _u8(jpeg)
    if lib.jpeg_dims(p, n, ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("corrupt JPEG")
    return w.value, h.value


def decode_eval(jpeg: bytes, size: int = 224, resize_size: int | None = None,
                fast: bool = True) -> np.ndarray:
    """Fused val pipeline: decode -> Resize(shorter) -> CenterCrop ->
    normalize. Returns (size, size, 3) float32 HWC."""
    if resize_size is None:
        resize_size = int(round(size * 256 / 224))
    lib = _load()
    out = np.empty((size, size, 3), np.float32)
    p, n = _u8(jpeg)
    rc = lib.fused_decode_eval(p, n, size, resize_size, _f32p(_MEAN), _f32p(_STD),
                               1 if fast else 0, _f32p(out))
    if rc == -2:
        raise ValueError("image smaller than crop (pad path unsupported)")
    if rc != 0:
        raise ValueError("corrupt JPEG")
    return out


def decode_train(jpeg: bytes, size: int, rng: np.random.Generator,
                 fast: bool = True) -> np.ndarray:
    """Fused train pipeline: decode -> RandomResizedCrop (parameters drawn
    with the PIL path's algorithm and rng order) -> flip -> normalize."""
    lib = _load()
    w, h = jpeg_dims(jpeg)
    top, left, ch, cw = random_resized_crop_params(rng, w, h)
    flip = 1 if rng.random() < 0.5 else 0
    out = np.empty((size, size, 3), np.float32)
    p, n = _u8(jpeg)
    rc = lib.fused_decode_train(p, n, size, top, left, ch, cw, flip, _f32p(_MEAN), _f32p(_STD),
                                1 if fast else 0, _f32p(out))
    if rc != 0:
        raise ValueError("corrupt JPEG")
    return out
