"""JPEG 2000 frames, JP2 files and raw codestreams, as Pillow 12.1 reads them
through openjpeg 2.5: ``np.asarray(Image.open(path))`` as [H,W,C] and its
mode.

Pillow's side is mirrored here: its Jpeg2KImagePlugin gives the mode and
size (from the codestream's SIZ, or from a JP2's ``ihdr``, ``colr`` and
``pclr`` boxes), and its Jpeg2KDecode.c picks an unpacker by the colour
space openjpeg reports (a JP2's enumerated colour space; where there is
none, a raw codestream or an ICC profile, grey for one or two components
and sRGB for three or four), places each sample after its shift to 8 or
16 bits, and converts sYCC samples to RGB itself. openjpeg's side, the
codestream itself, is decoded by ``csrc/jpeg2000_decode.cpp`` (built with
g++ into ``build/libjpeg2000_decode.so`` at first use) to the tile buffers
openjpeg hands Pillow. Pillow decodes tile by tile, so openjpeg applies
neither a palette nor channel definitions: a ``P`` or ``PA`` file reads as
its indices, as ``np.asarray`` gives them.

Pillow's tile loop (``j2k_decode_entry``) is mirrored byte for byte: one
buffer for every tile, zeroed only where it grows, each tile's components
one after another as openjpeg writes them, and the unpackers' own strides.
For a subsampled component (XRsiz or YRsiz other than 1) the colour
unpackers step by ``w / dx`` samples a row and repeat each sample (past
openjpeg's samples they read what the buffer holds, as Pillow does); the
grey ones take none, and Pillow refuses the file.

What openjpeg or Pillow refuses, and what this module does not decode
(HTJ2K, multiple component transforms other than the RCT and ICT,
arbitrary wavelets), raises ValueError naming it.
"""

from __future__ import annotations

import base64
import ctypes
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from mlinerf_tpu_torch.utils.image_containers import _check_size

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
# The decoder's path counters (csrc/jpeg2000_decode.cpp, enum Count).
COUNTS = ("lrcp", "rlcp", "rpcl", "pcrl", "cprl", "layers", "tiles", "tile_parts", "precincts", "sop", "eph", "plt",
          "tlm", "com", "wavelet_53", "wavelet_97", "rct", "ict", "coc", "qcc", "signed", "offset", "derived", "poc",
          "subsampled", "bypass", "reset", "termall", "causal", "pterm", "segsym", "rgn", "ppm", "ppt")
_MAX_COMPONENTS = 64

_LIB = None
_LIB_LOCK = threading.Lock()


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("jpeg2000_decode")
            lib.j2k_decode.restype = ctypes.c_int64
            lib.j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                       ctypes.c_int64]
            lib.j2k_counts.restype = ctypes.c_int64
            lib.j2k_counts.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            _LIB = lib
        return _LIB


def counts(reset: bool = True) -> Dict[str, int]:
    """How often each decoder path ran since the last reset."""
    out = np.zeros(len(COUNTS), np.int64)
    _lib().j2k_counts(out.ctypes.data, int(reset))
    return dict(zip(COUNTS, out.tolist()))


def is_jpeg2000(head: bytes) -> bool:
    """Pillow's Jpeg2KImagePlugin._accept."""
    return head[:4] == J2K_SIGNATURE or head[:12] == JP2_SIGNATURE


# ---------------------------------------------------------------------------
# Pillow's side: the mode and size
# ---------------------------------------------------------------------------

def _codestream_mode(path: str, cs: bytes) -> Tuple[Tuple[int, int], str]:
    """Jpeg2KImagePlugin._parse_codestream: (size, mode) from SIZ."""
    if len(cs) < 4 + 38 + 1:
        raise ValueError(f"{path}: JPEG 2000: truncated SIZ")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", cs, 4)
    if csiz == 1:
        mode = "I;16" if (cs[4 + 38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise ValueError(f"{path}: JPEG 2000: unable to determine J2K image mode ({csiz} components)")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _boxes(path: str, data: bytes, start: int, end: int):
    """(type, payload start, payload end) of the boxes in data[start:end];
    a box of length 0 runs to ``end``."""
    pos = start
    while pos + 8 <= end:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > end:
                raise ValueError(f"{path}: JPEG 2000: truncated box header")
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif lbox == 0:
            lbox = end - pos
        if lbox < hlen or pos + lbox > end:
            raise ValueError(f"{path}: JPEG 2000: invalid box length for {tbox!r}")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


class Jp2Header:
    """What Pillow (``_parse_jp2_header``) and openjpeg (its colour space)
    read of a JP2's boxes, and where its codestream lies."""

    def __init__(self, path: str, data: bytes):
        self.size: Optional[Tuple[int, int]] = None
        self.mode: Optional[str] = None
        self.enumcs = 0  # openjpeg's: the first colr box's enumerated colour space, else 0
        self.codestream: Optional[bytes] = None
        boxes = list(_boxes(path, data, 0, len(data)))
        if len(boxes) < 2 or boxes[0][0] != b"jP  " or boxes[1][0] != b"ftyp":
            raise ValueError(f"{path}: JPEG 2000: the JP2 signature and ftyp boxes must come first")
        header = False
        for tbox, p0, p1 in boxes[2:]:
            if tbox == b"jp2h":
                self._read_jp2h(path, data, p0, p1)
                header = True
            elif tbox == b"jp2c":
                if not header:
                    raise ValueError(f"{path}: JPEG 2000: the jp2c box comes before jp2h")
                self.codestream = data[p0:p1]
                break
        if not header or self.size is None or self.mode is None:
            raise ValueError(f"{path}: JPEG 2000: malformed JP2 header")
        if self.codestream is None:
            raise ValueError(f"{path}: JPEG 2000: no codestream (jp2c) box")

    def _read_jp2h(self, path, data, p0, p1):
        nc = None
        colr = False
        for i, (tbox, b0, b1) in enumerate(_boxes(path, data, p0, p1)):
            body = data[b0:b1]
            if i == 0 and tbox != b"ihdr":
                raise ValueError(f"{path}: JPEG 2000: the first box in jp2h is not ihdr")
            if tbox == b"ihdr":
                if len(body) < 14:
                    raise ValueError(f"{path}: JPEG 2000: ihdr too short")
                height, width, nc, bpc = struct.unpack_from(">IIHB", body)
                if not (width and height and nc):
                    raise ValueError(f"{path}: JPEG 2000: bad ihdr (zero size or components)")
                self.size = (width, height)
                self.mode = ("I;16" if bpc & 0x7F > 8 else "L") if nc == 1 else {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
            elif tbox == b"colr":
                if len(body) < 3:
                    raise ValueError(f"{path}: JPEG 2000: colr too short")
                if body[0] == 1 and len(body) >= 7:  # an enumerated space, not an ICC profile
                    enumcs = struct.unpack_from(">I", body, 3)[0]
                    if nc == 4 and enumcs == 12:
                        self.mode = "CMYK"
                    if not colr:
                        self.enumcs = enumcs
                colr = True
            elif tbox == b"pclr" and self.mode in ("L", "LA"):
                if len(body) < 3:
                    raise ValueError(f"{path}: JPEG 2000: pclr too short")
                ne, npc = struct.unpack_from(">HB", body)
                depths = body[3:3 + npc]
                if len(depths) < npc:
                    raise ValueError(f"{path}: JPEG 2000: pclr too short")
                if max(depths, default=0) <= 8:
                    if len(body) < 3 + npc + ne * npc:
                        raise ValueError(f"{path}: JPEG 2000: pclr too short for its entries")
                    self.mode = "P" if self.mode == "L" else "PA"


# openjpeg's colour spaces (opj_jp2_read_header; any other, an ICC profile
# or no colr box is unknown) and Jpeg2KDecode.c's unpackers: (mode, colour
# space, components) -> unpacker.
_SPACES = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
_UNPACKERS = {
    ("L", "gray", 1): "gray_l", ("P", "srgb", 1): "gray_l", ("PA", "srgb", 2): "graya_la",
    ("I;16", "gray", 1): "gray_i", ("LA", "gray", 2): "graya_la",
    ("RGB", "gray", 1): "gray_rgb", ("RGB", "gray", 2): "gray_rgb", ("RGB", "srgb", 3): "srgb_rgb",
    ("RGB", "sycc", 3): "sycc_rgb", ("RGB", "srgb", 4): "srgb_rgb", ("RGB", "sycc", 4): "sycc_rgb",
    ("RGBA", "gray", 1): "gray_rgb", ("RGBA", "gray", 2): "graya_la", ("RGBA", "srgb", 3): "srgb_rgb",
    ("RGBA", "sycc", 3): "sycc_rgb", ("RGBA", "srgb", 4): "srgba_rgba", ("RGBA", "sycc", 4): "sycca_rgba",
    ("CMYK", "cmyk", 4): "srgba_rgba",
}


# Pillow's ImagingConvertYCbCr2RGB (ConvertYCbCr.c), which its decoder runs
# on sYCC samples: R = Y + Rc[Cr], G = Y + ((Gb[Cb] + Gc[Cr]) >> 6), B = Y +
# Bb[Cb], each clipped to 0-255. Pillow keeps literal fixed-point tables no
# formula reproduces; these integer tables (Rc and Bb already shifted)
# were solved for from its conversion's outputs and give its result for
# every (Y, Cb, Cr): tests/test_torch_jpeg2000.py holds them against
# Image.convert over all 2^24 inputs. Rows: Rc, Gb, Gc, Bb.
_YCC_TABLES = np.frombuffer(base64.b64decode(
    "TP9N/0//UP9S/1P/VP9W/1f/Wf9a/1v/Xf9e/2D/Yf9i/2T/Zf9n/2j/av9r/2z/bv9v/3H/cv9z/3X/dv94/3n/ev98/33/f/+A"
    "/4H/g/+E/4b/h/+I/4r/i/+N/47/j/+R/5L/lP+V/5b/mP+Z/5v/nP+d/5//oP+i/6P/pP+m/6f/qf+q/6v/rf+u/7D/sf+y/7T/"
    "tf+3/7j/uf+7/7z/vv+//8D/wv/D/8X/xv/H/8n/yv/M/83/zv/Q/9H/0//U/9X/1//Y/9r/2//c/97/3//h/+L/4//l/+b/6P/p"
    "/+r/7P/t/+//8P/y//P/9P/2//f/+f/6//v//f/+/wAAAQACAAQABQAHAAgACQALAAwADgAPABAAEgATABUAFgAXABkAGgAcAB0A"
    "HgAgACEAIwAkACUAJwAoACoAKwAsAC4ALwAxADIAMwA1ADYAOAA5ADoAPAA9AD8AQABBAEMARABGAEcASABKAEsATQBOAE8AUQBS"
    "AFQAVQBWAFgAWQBbAFwAXQBfAGAAYgBjAGQAZgBnAGkAagBrAG0AbgBwAHEAcgB0AHUAdwB4AHkAewB8AH4AfwCAAIIAgwCFAIYA"
    "iACJAIoAjACNAI8AkACRAJMAlACWAJcAmACaAJsAnQCeAJ8AoQCiAKQApQCmAKgAqQCrAKwArQCvALAAsgADC+wK1wrBCqoKlQp+"
    "CmkKUwo8CicKEAr7CeQJzgm5CaIJjQl2CWAJSwk0CR8JCAnzCN0IxgixCJkIhAhtCFcIQggrCBYI/wfqB9QHvQeoB5EHfAdmB08H"
    "OgcjBw4H+AbhBswGtQagBooGcwZeBkcGMgYbBgUG8AXZBcQFrQWXBYIFawVWBT8FKQUTBfwE5wTQBLsEpASOBHkEYgRNBDYEIAQL"
    "BPQD3wPIA7MDnQOGA3EDWgNFAy8DGAMDA+wC1wLBAqoClQJ+AmkCUwI8AicCEAL7AeQBzgG4AaEBjAF1AWABSgEzAR4BBwHyANsA"
    "xQCwAJkAhABtAFcAQgArABYA///q/9T/vv+o/5L/fP9m/1D/Ov8k/w7/+P7i/sz+tv6g/or+dP5e/kj+Mf4b/gX+7/3Z/cP9rf2X"
    "/YH9a/1V/T/9Kf0T/f385/zR/Lv8pfyP/Hn8Y/xN/Df8IfwL/PX73/vJ+7P7nfuH+3H7W/tF+y/7GfsD++361/rA+qr6lPp++mj6"
    "Uvo8+ib6EPr6+eT5zvm4+aL5jPl2+WD5Svk0+R75CPny+Nz4xviw+Jr4hPhu+Fj4Qvgs+Bb4APjq99T3vveo95L3fPdm90/3Ofcj"
    "9w339/bh9sv2tfaf9on2c/Zd9kf2MfYb9gX27/XZ9cP1rfWX9YH1a/VV9T/1KfUT9dsWrhaAFlIWJBb3FckVmxVuFUAVEhXkFLcU"
    "iRRbFC4UABTSE6UTdxNJExsT7hLAEpISZRI3EgkS2xGuEYARUhElEfcQyRCcEG4QQBASEOUPtw+JD1wPLg8AD9MOpQ53DkkOHA7u"
    "DcANkw1lDTcNCQ3cDK4MgAxTDCUM9wvKC5wLbgtACxML5Qq3CooKXAouCgAK0wmlCXcJSgkcCe4IwQiTCGUINwgKCNwHrgeBB1MH"
    "JQf3BsoGnAZuBkEGEwblBbgFigVcBS4FAQXTBKUEeARKBBwE7wPBA5MDZQM4AwoD3AKvAoECUwIlAvgBygGcAW8BQQETAeYAuACK"
    "AFwALwABANT/p/95/0v/Hf/w/sL+lP5n/jn+C/7e/bD9gv1U/Sf9+fzL/J78cPxC/BT85/u5+4v7Xvsw+wL71fqn+nn6S/oe+vD5"
    "wvmV+Wf5OfkM+d74sPiC+FX4J/j598z3nvdw90L3Fffn9rn2jPZe9jD2A/bV9af1efVM9R718PTD9JX0Z/Q59Az03vOw84PzVfMn"
    "8/ryzPKe8nDyQ/IV8ufxuvGM8V7xMPED8dXwp/B68EzwHvDx78Pvle9n7zrvDO/e7rHug+5V7iju+u3M7Z7tce1D7RXt6Oy67Izs"
    "Xuwx7APs1euo63rrTOsf6/Hqw+qV6mjqOuoM6t/psemD6VXpHf8e/yD/Iv8k/yb/J/8p/yv/Lf8u/zD/Mv80/zb/N/85/zv/Pf8+"
    "/0D/Qv9E/0X/R/9J/0v/Tf9O/1D/Uv9U/1X/V/9Z/1v/XP9e/2D/Yv9k/2X/Z/9p/2v/bP9u/3D/cv90/3X/d/95/3v/fP9+/4D/"
    "gv+D/4X/h/+J/4v/jP+O/5D/kv+T/5X/l/+Z/5v/nP+e/6D/ov+j/6X/p/+p/6r/rP+u/7D/sv+z/7X/t/+5/7r/vP++/8D/wv/D"
    "/8X/x//J/8r/zP/O/9D/0f/T/9X/1//Z/9r/3P/e/+D/4f/j/+X/5//o/+r/7P/u//D/8f/z//X/9//4//r//P/+/wAAAQADAAUA"
    "BwAIAAoADAAOAA8AEQATABUAFwAYABoAHAAeAB8AIQAjACUAJgAoACoALAAuAC8AMQAzADUANgA4ADoAPAA+AD8AQQBDAEUARgBI"
    "AEoATABNAE8AUQBTAFUAVgBYAFoAXABdAF8AYQBjAGUAZgBoAGoAbABtAG8AcQBzAHQAdgB4AHoAfAB9AH8AgQCDAIQAhgCIAIoA"
    "iwCNAI8AkQCTAJQAlgCYAJoAmwCdAJ8AoQCjAKQApgCoAKoAqwCtAK8AsQCyALQAtgC4ALoAuwC9AL8AwQDCAMQAxgDIAMoAywDN"
    "AM8A0QDSANQA1gDYANkA2wDdAN8A4QA="), "<i2").reshape(4, 256).astype(np.int64)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """ImagingConvertYCbCr2RGB on uint8 planes -> [R, G, B] uint8."""
    rc, gb, gc, bb = _YCC_TABLES
    y = y.astype(np.int64)
    return [np.clip(v, 0, 255).astype(np.uint8) for v in (y + rc[cr], y + ((gb[cb] + gc[cr]) >> 6), y + bb[cb])]


def _shifted(word: np.ndarray, prec: int, sgnd: bool, bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, 8 or 16 - prec) as Pillow stores it: the
    word read from openjpeg's tile buffer (1, 2 or 4 bytes), unsigned
    32-bit arithmetic, truncated to ``bits``."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word.astype(np.int64) + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return (x & ((1 << bits) - 1)).astype(np.uint8 if bits == 8 else np.uint16)


def _csiz(prec: int) -> int:
    """The bytes of a sample in openjpeg's tile buffer (and Pillow's)."""
    return {1: 1, 2: 2, 3: 4, 4: 4}[(prec + 7) >> 3]


def _words(buf: np.ndarray, base: int, csiz: int, index: np.ndarray) -> np.ndarray:
    """The little-endian ``csiz``-byte words at ``base + csiz * index``."""
    at = base + csiz * index
    word = buf[at].astype(np.uint32)
    for b in range(1, csiz):
        word |= buf[at + b].astype(np.uint32) << np.uint32(8 * b)
    return word


# The unpackers that take subsampled components (j2k_unpackers' subsampling
# flag).
_COLOUR = ("srgb_rgb", "sycc_rgb", "srgba_rgba", "sycca_rgba")


def _unpack_tile(unpacker: str, mode: str, buf: np.ndarray, w: int, h: int, info) -> np.ndarray:
    """The pixels one unpacker writes for a w x h tile from Pillow's tile
    buffer, as the mode's array: [h, w, C]."""
    prec, sgnd, dx, dy = info
    y, x = np.mgrid[0:h, 0:w]
    csiz = [_csiz(p) for p in prec]

    def band(c, bits=8):  # each component's own rows of w / dx samples
        base = sum(csiz[m] * (w // dx[m]) * (h // dy[m]) for m in range(c))
        index = (y // dy[c]) * (w // dx[c]) + x // dx[c]
        return _shifted(_words(buf, base, csiz[c], index), prec[c], sgnd[c], bits)

    if unpacker == "gray_l":
        return band(0)[..., None]
    if unpacker == "gray_i":
        return band(0, 16)[..., None]
    if unpacker == "graya_la":
        grey, alpha = band(0), band(1)
        return np.stack([grey, alpha] if mode in ("LA", "PA") else [grey, grey, grey, alpha], -1)
    if unpacker == "gray_rgb":
        grey = band(0)
        return np.stack([grey] * 3 + ([np.full_like(grey, 255)] if mode == "RGBA" else []), -1)
    if unpacker == "srgb_rgb":
        rgb = [band(c) for c in range(3)]
        return np.stack(rgb + ([np.full_like(rgb[0], 255)] if mode == "RGBA" else []), -1)
    if unpacker == "srgba_rgba":
        return np.stack([band(c) for c in range(4)], -1)
    # sycc_rgb, sycca_rgba: unpacked as sRGB, then Pillow's conversion.
    rgb = _ycbcr_to_rgb(*(band(c) for c in range(3)))
    if mode == "RGB":
        return np.stack(rgb, -1)
    return np.stack(rgb + [band(3) if unpacker == "sycca_rgba" else np.full_like(rgb[0], 255)], -1)


def decode_codestream(path: str, cs: bytes):
    """openjpeg's decoding of a codestream as Pillow receives it: the image
    area's (W, H, XOsiz, YOsiz), each component's (precisions, signedness,
    XRsiz, YRsiz), and the tiles in the order openjpeg decodes them, each
    (x0, y0, x1, y1, its tile buffer as uint8)."""
    lib = _lib()
    dims = np.zeros(7 + 4 * _MAX_COMPONENTS, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.j2k_decode(cs, len(cs), None, 0, None, dims.ctypes.data, dims.size, err, len(err)) != 0:
        raise ValueError(f"{path}: JPEG 2000: {err.value.decode()}")
    w, h, nc, x0, y0, ntiles, nbytes = (int(v) for v in dims[:7])
    _check_size(path, w, h)
    if nc > 4:
        raise ValueError(f"{path}: JPEG 2000: {nc} components (Pillow's decoder takes 1 to 4)")
    out = np.empty(max(nbytes, 1), np.uint8)
    table = np.zeros((ntiles, 6), np.int64)
    n = lib.j2k_decode(cs, len(cs), out.ctypes.data, out.size, table.ctypes.data, dims.ctypes.data, dims.size, err,
                       len(err))
    if n < 0:
        raise ValueError(f"{path}: JPEG 2000: {err.value.decode()}")
    comps = dims[7:7 + 4 * nc].reshape(nc, 4).T
    info = ([int(v) for v in comps[0]], [bool(v) for v in comps[1]], [int(v) for v in comps[2]],
            [int(v) for v in comps[3]])
    tiles = [(*(int(v) for v in row[:4]), out[row[4]:row[4] + row[5]]) for row in table[:n]]
    return (w, h, x0, y0), info, tiles


def read_jpeg2000(path: str) -> Tuple[np.ndarray, str]:
    """A JP2 file or a raw codestream as Pillow's array of it, [H,W,C], and
    its mode; see the module's docstring."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == J2K_SIGNATURE:
        size, mode = _codestream_mode(path, data)
        cs, space = data, None
    elif data[:12] == JP2_SIGNATURE:
        head = Jp2Header(path, data)
        size, mode, cs = head.size, head.mode, head.codestream
        space = _SPACES.get(head.enumcs, "unknown")
        if cs[:4] != J2K_SIGNATURE:
            raise ValueError(f"{path}: JPEG 2000: the jp2c box holds no codestream")
    else:
        raise ValueError(f"{path}: not a JPEG 2000 file")
    _check_size(path, *size)
    (cw, ch, x0, y0), info, tiles = decode_codestream(path, cs)
    nc = len(info[0])
    if space in (None, "unknown"):
        # No enumerated space: Pillow goes by the component count and, for
        # three or four, by the first subsampled component: the second or
        # third makes it sYCC (4:2:2, 4:2:0), the first, the fourth or none
        # sRGB.
        sub = next((c for c in range(nc) if info[2][c] != 1 or info[3][c] != 1), -1)
        space = "gray" if nc <= 2 else "sycc" if sub in (1, 2) else "srgb"
    unpacker = _UNPACKERS.get((mode, space, nc))
    if unpacker is None:
        raise ValueError(f"{path}: JPEG 2000: Pillow's decoder has no unpacker for mode {mode} from {nc} "
                         f"components in colour space {space}")
    if unpacker not in _COLOUR and any(v != 1 for v in info[2] + info[3]):
        raise ValueError(f"{path}: JPEG 2000: Pillow's decoder has no unpacker for subsampled components in mode "
                         f"{mode} ({unpacker} takes none)")
    w, h = size
    if (cw, ch) != (w, h):
        raise ValueError(f"{path}: JPEG 2000: the codestream's image ({cw}x{ch}) is not the header's ({w}x{h}); "
                         "Pillow's decoder fails on it")
    # j2k_decode_entry: one buffer, grown (and zeroed) to each tile's bytes
    # at full resolution where it is short; openjpeg writes its samples at
    # its start.
    channels = {"L": 1, "P": 1, "I;16": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    img = np.zeros((h, w, channels), np.uint16 if mode == "I;16" else np.uint8)
    buf = np.zeros(0, np.uint8)
    for tx0, ty0, tx1, ty1, samples in tiles:
        tw, th = tx1 - tx0, ty1 - ty0
        need = max(sum(_csiz(p) for p in info[0]) * tw * th, samples.size)
        if buf.size < need:
            buf = np.zeros(need, np.uint8)
        buf[:samples.size] = samples
        img[ty0 - y0:ty1 - y0, tx0 - x0:tx1 - x0] = _unpack_tile(unpacker, mode, buf, tw, th, info)
    return img, mode
