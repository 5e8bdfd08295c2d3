"""ctypes bindings for the native C++ EuRoC loader (native/euroc_loader.cc).

The native loader decodes PNGs and slices IMU on a background thread so the
SLAM loop's host-side cost is a memcpy. The shared library is built from the
committed sources with `make -C native` (g++ and zlib) at first use; a failed
build raises instead of switching readers. io/euroc.py is the pure-Python
reader the tests compare it with.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libeuroc_loader.so")
_lib = None


def build():
    """Build the shared library (no-op when it is up to date)."""
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.el_open.restype = ctypes.c_void_p
        lib.el_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.el_num_frames.argtypes = [ctypes.c_void_p]
        lib.el_width.argtypes = [ctypes.c_void_p]
        lib.el_height.argtypes = [ctypes.c_void_p]
        lib.el_frame_time.restype = ctypes.c_double
        lib.el_frame_time.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.el_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.el_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeEurocLoader:
    """Iterates (t_frame, image (H,W) float32, imu (N,7) float32 [gyro,acc,dt])."""

    def __init__(self, mav0_path: str, n_prefetch: int = 4, imu_cap: int = 64,
                 uint8: bool = True):
        lib = _load()
        self._lib = lib
        self._h = lib.el_open(mav0_path.encode(), n_prefetch)
        if not self._h:
            raise RuntimeError(f"native loader failed to open {mav0_path}")
        self.n_frames = lib.el_num_frames(self._h)
        self.width = lib.el_width(self._h)
        self.height = lib.el_height(self._h)
        self._imu_cap = imu_cap
        self._img = np.empty((self.height, self.width), np.float32)
        self._imu = np.empty((imu_cap, 7), np.float32)
        self._idx = 0
        # uint8: yield frames as u8 (EuRoC PNGs are 8-bit gray, so this is
        # lossless) — 4x less host->device upload than float32
        self._uint8 = uint8

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        n = self._lib.el_next(
            self._h,
            self._img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._imu.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._imu_cap)
        if n == -1:
            self.close()
            raise StopIteration
        if n == -2:
            raise RuntimeError(f"PNG decode failed at frame {self._idx}")
        t = self._lib.el_frame_time(self._h, self._idx)
        self._idx += 1
        img = self._img.astype(np.uint8) if self._uint8 else self._img.copy()
        return t, img, self._imu[:n].copy()

    def close(self):
        if self._h is not None:
            self._lib.el_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
