"""Zstandard strips and tiles of a TIFF (compression 50000), decoded by
``csrc/zstd_decode.cpp`` (built with g++ into ``build/libzstd_decode.so``
at first use; a failed build raises) as libtiff's tif_zstd.c reads them
through libzstd: see that file for what it covers and how it mirrors
libzstd's stream decoder at the output's end.

The decoder counts the RFC 8878 paths each call reaches (frame header
forms, block types, literal and sequence modes, checksum, skippable
frames); :func:`path_counts` reads the running totals, so that a test can
show which paths a corpus reaches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

_LIB = None
_NAMES = ()
_COUNTS = None
_LOCK = threading.Lock()


def _lib():
    global _LIB, _NAMES, _COUNTS
    from mlinerf_tpu_torch.utils.image_io import _LIB_LOCK

    with _LIB_LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("zstd_decode")
            lib.zstd_decode.restype = ctypes.c_int64
            lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.zstd_paths.restype = ctypes.c_char_p
            lib.zstd_paths.argtypes = []
            _NAMES = tuple(lib.zstd_paths().decode().split(","))
            _COUNTS = np.zeros(len(_NAMES), np.int64)
            _LIB = lib
        return _LIB


def decode_into(path: str, chunk: bytes, out: np.ndarray, what: str) -> int:
    """Decodes ``chunk`` into the uint8 array ``out`` (at most its size) as
    libtiff's ZSTDDecode does; returns the bytes written (fewer than
    ``out.size`` where the data runs short). A frame libzstd rejects raises
    ValueError naming the reason."""
    lib = _lib()
    counts = np.zeros(len(_NAMES), np.int64)
    err = ctypes.create_string_buffer(256)
    n = lib.zstd_decode(chunk, len(chunk), out.ctypes.data, out.size, counts.ctypes.data, err, len(err))
    with _LOCK:
        _COUNTS[:] += counts
    if n < 0:
        raise ValueError(f"{path}: TIFF: ZSTD error in {what}: {err.value.decode()}")
    return int(n)


def path_counts() -> Dict[str, int]:
    """{path: times reached} over every call so far."""
    _lib()
    with _LOCK:
        return dict(zip(_NAMES, (int(c) for c in _COUNTS)))


def reset_path_counts():
    _lib()
    with _LOCK:
        _COUNTS[:] = 0
