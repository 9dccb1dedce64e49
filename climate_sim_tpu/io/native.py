"""ctypes binding to the native (C++) CDF-5 async snapshot writer.

The reference's I/O layer is native C++ over PnetCDF (reference:
src/io.cpp:378-448); this is its counterpart here: a background writer
thread in ``native/src/cdf5_writer.cc`` does the big-endian conversion and
file writes off the Python thread, so snapshot I/O overlaps device compute
(the single-controller analogue of collective MPI-IO overlapping ranks).

The library self-builds on first use (``make -C native``) — the runtime
ships only a toolchain, not prebuilt artifacts.  Import raises if no
compiler is available; callers (io/snapshots.py) fall back to the pure-Python
codec, which writes byte-identical files.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libclimate_nc.so")

_lib = None
_lib_lock = threading.Lock()


def _needs_build() -> bool:
    src = os.path.join(_NATIVE_DIR, "src", "cdf5_writer.cc")
    return not os.path.exists(_LIB_PATH) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    )


def _build_library() -> None:
    """Build under an inter-process file lock: two processes importing
    concurrently must not CDLL-load a half-written .so (make's output is not
    atomic).  The lock holder builds; waiters re-check freshness after it."""
    import fcntl

    os.makedirs(os.path.join(_NATIVE_DIR, "build"), exist_ok=True)
    lock_path = os.path.join(_NATIVE_DIR, "build", ".build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _needs_build():  # another process may have built while we waited
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    text=True,
                )
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library; thread-safe."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ncw_create.restype = ctypes.c_int64
        lib.ncw_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.ncw_attach.restype = ctypes.c_int64
        lib.ncw_attach.argtypes = lib.ncw_create.argtypes
        lib.ncw_append.restype = ctypes.c_int64
        lib.ncw_append.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.ncw_append_region.restype = ctypes.c_int64
        lib.ncw_append_region.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.ncw_flush.restype = ctypes.c_int64
        lib.ncw_flush.argtypes = [ctypes.c_int64]
        lib.ncw_queue_depth.restype = ctypes.c_int64
        lib.ncw_queue_depth.argtypes = [ctypes.c_int64]
        lib.ncw_close.restype = ctypes.c_int64
        lib.ncw_close.argtypes = [ctypes.c_int64]
        lib.ncw_last_error.restype = ctypes.c_char_p
        lib.ncw_last_error.argtypes = []
        _lib = lib
        return lib


def _last_error(lib) -> str:
    msg = lib.ncw_last_error()
    return msg.decode("utf-8", errors="replace") if msg else "unknown native I/O error"


class NativeSnapshotWriter:
    """Async snapshot writer over the native library.

    Writes the reference's frozen schema — dims time/y/x, ``u(time,y,x)``
    NC_DOUBLE, global text attrs (io.cpp:428-448) — byte-identical to
    :class:`climate_sim_tpu.io.netcdf.NetCDFWriter` with version=5.
    """

    def __init__(self, path: str, cfg, attrs: Dict[str, str], create: bool = True):
        """``create=False`` attaches to a file another process created with
        the same schema (header byte-verified, numrecs left to the creator)
        — the per-rank half of parallel hyperslab writes."""
        self._lib = load_library()
        self.ny = cfg.ny
        self.nx = cfg.nx
        names = (ctypes.c_char_p * len(attrs))(
            *[k.encode("utf-8") for k in attrs]
        )
        values = (ctypes.c_char_p * len(attrs))(
            *[str(v).encode("utf-8") for v in attrs.values()]
        )
        open_fn = self._lib.ncw_create if create else self._lib.ncw_attach
        self._h = open_fn(
            path.encode("utf-8"), cfg.ny, cfg.nx, len(attrs), names, values
        )
        if not self._h:
            raise RuntimeError(
                f"ncw_{'create' if create else 'attach'} failed: "
                f"{_last_error(self._lib)}"
            )

    def append(self, irec: int, frame: np.ndarray) -> None:
        """Enqueue one (ny, nx) float64 frame; returns before the disk write."""
        frame = np.ascontiguousarray(frame, dtype=np.float64)
        if frame.shape != (self.ny, self.nx):
            raise ValueError(f"frame shape {frame.shape} != ({self.ny}, {self.nx})")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self._lib.ncw_append(self._h, ptr, irec) != 0:
            raise RuntimeError(f"ncw_append failed: {_last_error(self._lib)}")

    def append_region(self, irec: int, y0: int, x0: int, block: np.ndarray) -> None:
        """Enqueue one (by, bx) float64 hyperslab at rows y0.., cols x0..
        (async; copies the block) — ncmpi_put_vara_double_all analogue."""
        block = np.ascontiguousarray(block, dtype=np.float64)
        if block.ndim != 2:
            raise ValueError(f"region block must be 2D, got {block.shape}")
        by, bx = block.shape
        ptr = block.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self._lib.ncw_append_region(self._h, ptr, irec, y0, x0, by, bx) != 0:
            raise RuntimeError(
                f"ncw_append_region failed: {_last_error(self._lib)}"
            )

    def flush(self) -> None:
        if self._lib.ncw_flush(self._h) != 0:
            raise RuntimeError(f"ncw_flush failed: {_last_error(self._lib)}")

    def queue_depth(self) -> int:
        return int(self._lib.ncw_queue_depth(self._h))

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, 0
            if self._lib.ncw_close(h) != 0:
                raise RuntimeError(f"ncw_close failed: {_last_error(self._lib)}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
