"""ctypes bindings to the native C++ data loader (native/png_loader.cpp).

Builds the shared library on first use if the toolchain is available;
falls back silently (io/tum.py then uses OpenCV or the bundled
numpy+zlib decoder).  Public surface:

- decode_png(path) -> np.ndarray | None  (uint8 [H,W,3] or uint16 [H,W])
- PrefetchLoader: multi-threaded decode-ahead over an (rgb, depth) path
  list, hiding PNG decode latency behind device compute.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libmslam_native.so")

_lib: Optional[ctypes.CDLL] = None
_unavailable = False   # build or load failed once: don't retry per call


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    try:
        if not os.path.exists(_SO_PATH) and not _build():
            raise OSError(f"cannot build {_SO_PATH}")
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        _unavailable = True
        return None
    lib.msl_png_info.restype = ctypes.c_int
    lib.msl_png_info.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.msl_png_read.restype = ctypes.c_int
    lib.msl_png_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.msl_prefetch_create.restype = ctypes.c_void_p
    lib.msl_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    if hasattr(lib, "msl_prefetch_create2"):
        lib.msl_prefetch_create2.restype = ctypes.c_void_p
        lib.msl_prefetch_create2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
    lib.msl_prefetch_get.restype = ctypes.c_int
    lib.msl_prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.msl_prefetch_destroy.restype = None
    lib.msl_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str) -> Optional[np.ndarray]:
    """uint8 [H,W,3] for color PNGs, uint16 [H,W] for 16-bit gray; None on
    any failure (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    depth = ctypes.c_int()
    if lib.msl_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch), ctypes.byref(depth)) != 0:
        return None
    if depth.value == 16 and ch.value == 1:
        out = np.empty((h.value, w.value), np.uint16)
    elif depth.value == 8 and ch.value == 3:
        out = np.empty((h.value, w.value, 3), np.uint8)
    elif depth.value == 8 and ch.value == 1:
        out = np.empty((h.value, w.value), np.uint8)
    else:
        return None
    if lib.msl_png_read(path.encode(),
                        out.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return out


class PrefetchLoader:
    """Decode-ahead loader over paired (rgb, depth) PNG lists.

    Frames must share one resolution (TUM sequences do); rgb is 8-bit
    color, depth 16-bit gray, matching the reference dataset layout.
    """

    def __init__(self, rgb_paths: List[str], depth_paths: List[str],
                 n_threads: int = 4, ring: int = 8,
                 to_gray: bool = False):
        """`to_gray=True`: decode threads convert rgb to 8-bit luma
        in-thread (wire-format streaming — the conversion overlaps PNG
        decode instead of costing main-thread time); `get` then returns
        gray uint8 [H,W].  Requires the create2 ABI (rebuilt lib)."""
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        if to_gray and not hasattr(lib, "msl_prefetch_create2"):
            raise RuntimeError("native loader lacks create2 (stale build)")
        assert len(rgb_paths) == len(depth_paths)
        self._lib = lib
        self._n = len(rgb_paths)
        self._to_gray = to_gray
        # probe resolution from frame 0
        probe = decode_png(rgb_paths[0])
        if probe is None or probe.ndim != 3:
            raise RuntimeError(f"bad rgb frame: {rgb_paths[0]}")
        self._h, self._w = probe.shape[:2]

        self._rgb_bufs = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths])
        self._depth_bufs = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths])
        if to_gray:
            self._handle = lib.msl_prefetch_create2(
                self._rgb_bufs, self._depth_bufs, self._n, n_threads,
                ring, 1)
        else:
            self._handle = lib.msl_prefetch_create(
                self._rgb_bufs, self._depth_bufs, self._n, n_threads, ring)
        if not self._handle:
            raise RuntimeError("prefetcher creation failed")

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb uint8 [H,W,3] — or gray uint8 [H,W] with to_gray —
        plus depth_raw uint16 [H,W]); blocks until decoded."""
        if self._to_gray:
            rgb = np.empty((self._h, self._w), np.uint8)
        else:
            rgb = np.empty((self._h, self._w, 3), np.uint8)
        dep = np.empty((self._h, self._w), np.uint16)
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.msl_prefetch_get(
            self._handle, idx, rgb.ctypes.data_as(ctypes.c_void_p),
            dep.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"frame {idx} failed to decode")
        return rgb, dep

    def close(self) -> None:
        if self._handle:
            self._lib.msl_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
