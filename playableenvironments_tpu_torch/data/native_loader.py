"""ctypes bindings for the repo's native C++ frame loader (native/pe_dataloader.cc).

Copy of playableenvironments_tpu/data/native_loader.py's binding (the port
imports nothing of the JAX package). A C++ thread pool decodes PNG frames
with libpng and writes float32 [0, 1] RGB straight into the numpy batch
buffer: no GIL, no worker processes, no pickling. The library is the repo's
`native/libpe_dataloader.so`; where that one does not load (another libpng,
or none), a copy of `native/` is built under the port's `_build/native/`
(gitignored; `native/` itself is never written). Without a toolchain or
libpng nothing loads, `available()` is false and the callers fall back to
Pillow.

API:
- available() -> bool
- png_size(path) -> (h, w)
- decode(path, target_size=None) -> (h, w, 3) float32
- decode_batch(paths, target_size, threads=0) -> (n, h, w, 3) float32
- encode(path, frame) / encode_batch(paths, frames, threads=0)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_NAME = "libpe_dataloader.so"
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "native")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _build() -> Optional[str]:
    """Build a copy of native/ under _BUILD_DIR; the library's path, or None."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        for name in ("Makefile", "pe_dataloader.cc"):
            shutil.copy(os.path.join(_NATIVE_DIR, name), os.path.join(_BUILD_DIR, name))
        subprocess.run(
            ["make", "-C", _BUILD_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        return None
    path = os.path.join(_BUILD_DIR, _SO_NAME)
    return path if os.path.isfile(path) else None


def _load() -> Optional[ctypes.CDLL]:
    """The repo's library, else a fresh build of it; None when neither loads."""
    for path in (os.path.join(_NATIVE_DIR, _SO_NAME), os.path.join(_BUILD_DIR, _SO_NAME)):
        if os.path.isfile(path):
            try:
                return ctypes.CDLL(path)
            except OSError:
                pass
    path = _build()
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _get_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        lib = _load()
        if lib is None:
            _load_failed = True
            return None
        lib.pe_png_size.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pe_png_size.restype = ctypes.c_int
        lib.pe_decode_png.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.pe_decode_png.restype = ctypes.c_int
        lib.pe_decode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.pe_decode_png_batch.restype = ctypes.c_int
        lib.pe_encode_png.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.pe_encode_png.restype = ctypes.c_int
        lib.pe_encode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.pe_encode_png_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native loader is usable (built or buildable)."""
    return _get_lib() is not None


def png_size(path: str) -> Tuple[int, int]:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.pe_png_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise IOError(f"pe_png_size({path}) failed with status {rc}")
    return h.value, w.value


def decode(path: str, target_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode one PNG to float32 [0,1] RGB, optionally bilinear-resized."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    if target_size is None:
        h, w = png_size(path)
    else:
        h, w = target_size
    out = np.empty((h, w, 3), np.float32)
    rc = lib.pe_decode_png(
        path.encode(),
        h if target_size is not None else 0,
        w if target_size is not None else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc:
        raise IOError(f"pe_decode_png({path}) failed with status {rc}")
    return out


def decode_batch(
    paths: Sequence[str],
    target_size: Tuple[int, int],
    threads: int = 0,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode many PNGs in a C++ thread pool into one contiguous batch.

    :param target_size: (h, w) every frame is resized to.
    :param threads: worker threads (0 = one per CPU, capped at 16).
    :param out: optional preallocated (n, h, w, 3) float32 destination.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    h, w = target_size
    if out is None:
        out = np.empty((n, h, w, 3), np.float32)
    else:
        assert out.shape == (n, h, w, 3) and out.dtype == np.float32
        assert out.flags["C_CONTIGUOUS"]
    if n == 0:
        return out
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    encoded: List[bytes] = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    rc = lib.pe_decode_png_batch(
        arr, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads
    )
    if rc:
        raise IOError(f"pe_decode_png_batch failed with status {rc}")
    return out


def encode(path: str, frame: np.ndarray):
    """Write one float32 [0,1] RGB (h, w, 3) frame as a PNG."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    frame = np.ascontiguousarray(frame, np.float32)
    h, w = frame.shape[:2]
    rc = lib.pe_encode_png(
        path.encode(), h, w,
        frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc:
        raise IOError(f"pe_encode_png({path}) failed with status {rc}")


def encode_batch(paths: Sequence[str], frames: np.ndarray, threads: int = 0):
    """Write (n, h, w, 3) float32 frames to n PNG files in a C++ thread pool."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w = frames.shape[:3]
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.pe_encode_png_batch(
        arr, n, h, w,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads,
    )
    if rc:
        raise IOError(f"pe_encode_png_batch failed with status {rc}")
