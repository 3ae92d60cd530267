"""Deflate and XZ streams decoded as libtiff's codecs decode a strip, so a
damaged strip gives what libtiff gets: the bytes written before the error,
and whether the strip counts as read.

A stream that Python's ``zlib`` or ``lzma`` decodes to the strip's full
size without an error reads the same in libtiff, and takes that path. Any
other stream goes to ``csrc/stream_decode.cpp`` (built with g++ into
``build/libstream_decode.so`` at first use), whose inflate and XZ decoders
mirror zlib's and liblzma's state machines in libtiff 4.7's ZIPDecode and
LZMADecode loops: Python's modules keep no output past an error, and
Python's ``lzma`` reports errors that libtiff passes over once the strip
is full.
"""

from __future__ import annotations

import ctypes
import lzma
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("stream_decode")
            for name in ("inflate_strip", "xz_strip"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                               ctypes.c_int64]
            _LIB = lib
        return _LIB


def _strip(name: str, chunk: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    err = ctypes.create_string_buffer(256)
    n = getattr(_lib(), name)(bytes(chunk), len(chunk), out.ctypes.data, out.size, err, len(err))
    if n < 0:
        raise ValueError(f"{err.value.decode()} is not ported")
    return int(n), err.value.decode() or None


def inflate_strip(chunk: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    """csrc/stream_decode.cpp's inflate of ``chunk`` into the uint8 array
    ``out``, as libtiff's ZIPDecode runs zlib: (bytes written, None) or
    (bytes written, the error) where libtiff fails the strip."""
    return _strip("inflate_strip", chunk, out)


def xz_strip(chunk: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    """csrc/stream_decode.cpp's decode of the .xz stream ``chunk`` into
    ``out``, as libtiff's LZMADecode runs liblzma; returns as
    :func:`inflate_strip`. A stream it does not read (a filter chain other
    than LZMA2 alone, a SHA-256 check met before the strip is full) raises
    ValueError."""
    return _strip("xz_strip", chunk, out)


def _whole(decompressor, error, chunk: bytes, out: np.ndarray) -> bool:
    """Whether ``decompressor`` gives ``out.size`` bytes of ``chunk`` with
    no error; if so they are in ``out``."""
    try:
        got = decompressor.decompress(chunk, out.size)
    except error:
        return False
    if len(got) != out.size:
        return False
    out[:] = np.frombuffer(got, np.uint8)
    return True


def inflate_into(chunk: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    """libtiff's ZIPDecode of ``chunk`` into ``out``: (bytes written, None)
    or (bytes written, the error) where libtiff fails the strip."""
    if _whole(zlib.decompressobj(), zlib.error, chunk, out):
        return out.size, None
    return inflate_strip(chunk, out)


def unxz_into(chunk: bytes, out: np.ndarray) -> Tuple[int, Optional[str]]:
    """libtiff's LZMADecode of ``chunk`` into ``out``; returns as
    :func:`inflate_into`."""
    if _whole(lzma.LZMADecompressor(format=lzma.FORMAT_XZ), lzma.LZMAError, chunk, out):
        return out.size, None
    return xz_strip(chunk, out)
