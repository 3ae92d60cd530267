"""WebP files read to what Pillow 12.1's ``Image.open`` gives through libwebp
1.6.0: ``(np.asarray(Image.open(path)), mode)``, bit for bit, with neither
Pillow nor libwebp.

Pillow reads every WebP file, a still one too, through libwebp's
``WebPAnimDecoder`` (RGBA, not premultiplied, fancy upsampling, no
dithering) at frame 0, and names its mode from ``WebPGetFeatures``:
"RGBA" where the file has alpha (the VP8X alpha flag, the VP8L header's
alpha bit, or an ALPH chunk), else "RGB" (the decoder's X byte dropped).
This module mirrors that path:

- the RIFF container as libwebp's demuxer (src/demux/demux.c) parses it: a
  simple ``VP8 `` or ``VP8L`` file; ``VP8X`` with ``ALPH`` + ``VP8 `` or a
  ``VP8L``; ``ANIM``/``ANMF``, of which frame 0 is read. ``ICCP``, ``EXIF``
  and ``XMP `` are skipped (Pillow applies none of them), as is any chunk
  libwebp does not know;
- frame 0 placed into its rectangle of a zeroed canvas, as
  ``src/demux/anim_decode.c`` does for a key frame (frame 0 is not
  blended);
- the bitstreams decoded by ``csrc/webp_decode.cpp`` (VP8 key frames with
  libwebp's loop filters, fancy upsampler and YUV conversion; VP8L with
  its four transforms; ALPH raw or VP8L-coded with its unfilters), a host
  library built with g++ into ``build/libwebp_decode.so`` at first use; a
  failed build raises, there is no Python fallback.

What libwebp or Pillow refuses raises ValueError naming it: a truncated
file or chunk, a VP8 interframe, a bad partition size, a frame without an
image chunk, VP8L's version bits not 0, a frame outside its canvas, and so
on.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

# Pillow's WebPImagePlugin._accept: RIFF, WEBP and one of these at 12-16.
WEBP_FORMS = (b"VP8 ", b"VP8L", b"VP8X")
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ANIMATION, _XMP, _EXIF, _ALPHA, _ICCP = 0x02, 0x04, 0x08, 0x10, 0x20
_VALID_FLAGS = _ANIMATION | _XMP | _EXIF | _ALPHA | _ICCP

_LIB = None


def is_webp(head: bytes) -> bool:
    """Whether the first 16 bytes of a file are a WebP signature to Pillow."""
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP" and head[12:16] in WEBP_FORMS


def _lib():
    """``build/libwebp_decode.so`` (csrc/webp_decode.cpp), built with g++ at
    first use; a failed build raises."""
    global _LIB
    from mlinerf_tpu_torch.utils.image_io import _LIB_LOCK

    with _LIB_LOCK:
        if _LIB is None:
            from mlinerf_tpu_torch.ops import cuda_build

            lib = cuda_build.load("webp_decode")
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.webp_decode_vp8.restype = i64
            lib.webp_decode_vp8.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p, i64, i64, i64, ptr, i64,
                                            ctypes.c_char_p, i64]
            lib.webp_decode_vp8l.restype = i64
            lib.webp_decode_vp8l.argtypes = [ctypes.c_char_p, i64, i64, i64, ptr, i64, ctypes.c_char_p, i64]
            _LIB = lib
        return _LIB


def vp8_header(data: bytes, chunk_size: int) -> Tuple[Optional[Tuple[int, int]], str]:
    """``VP8GetInfo`` of a VP8 chunk's payload: ((width, height), "") of
    its key frame's first 10 bytes, or (None, why libwebp refuses them)."""
    if len(data) < 10:
        return None, "a VP8 chunk too short for its frame header"
    if data[3:6] != b"\x9d\x01\x2a":
        return None, "a VP8 frame without its start code"
    bits = data[0] | data[1] << 8 | data[2] << 16
    w, h = struct.unpack("<HH", data[6:10])
    if bits & 1:
        return None, "a VP8 interframe (WebP holds key frames only)"
    if (bits >> 1) & 7 > 3:
        return None, f"VP8 profile {(bits >> 1) & 7}"
    if not (bits >> 4) & 1:
        return None, "a VP8 frame not to be shown"
    if bits >> 5 >= chunk_size:
        return None, f"a VP8 first partition of {bits >> 5} bytes in a chunk of {chunk_size}"
    if not w & 0x3FFF or not h & 0x3FFF:
        return None, "a VP8 frame of zero width or height"
    return (w & 0x3FFF, h & 0x3FFF), ""


def vp8l_header(data: bytes) -> Tuple[Optional[Tuple[int, int, bool]], str]:
    """``VP8LGetInfo`` of a VP8L chunk's payload: ((width, height, alpha
    bit), ""), or (None, why libwebp refuses it)."""
    if len(data) < 5:
        return None, "a VP8L chunk too short for its header"
    if data[0] != 0x2F:
        return None, "a VP8L chunk without its signature byte"
    if data[4] >> 5:
        return None, f"VP8L version bits {data[4] >> 5}, not 0"
    bits = int.from_bytes(data[1:5], "little")
    return ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)), ""


class _Mem:
    """libwebp's MemBuffer over the file: reads to the RIFF chunk's end."""

    def __init__(self, path: str, data: bytes):
        self.path = path
        if len(data) < 20:
            raise ValueError(f"{path}: WebP: truncated file ({len(data)} bytes)")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise ValueError(f"{path}: WebP: RIFF size {riff_size}")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise ValueError(f"{path}: WebP: truncated file ({len(data)} of the RIFF chunk's {self.riff_end} bytes)")
        self.data = data[:self.riff_end]
        self.end = len(self.data)
        self.start = 12

    def left(self) -> int:
        return self.end - self.start

    def invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.start)[0]
        self.start += 4
        return v

    def fail(self, why: str):
        raise ValueError(f"{self.path}: WebP: {why}")


def _store_frame(mem: _Mem, min_size: int, frame: dict):
    """``StoreFrame``: the ALPH and image chunks that follow, into frame:
    ``image`` and ``alpha`` as (chunk offset, size with header and
    padding), the bitstream's ``width`` and ``height``, ``lossless``."""
    if mem.left() < 8 or mem.left() < min_size:
        mem.fail("truncated frame")
    alphas = images = 0
    while True:
        chunk_start = mem.start
        fourcc = mem.data[mem.start:mem.start + 4]
        mem.start += 4
        payload = mem.u32()
        if payload > _MAX_CHUNK_PAYLOAD:
            mem.fail(f"chunk {fourcc!r} of {payload} bytes")
        padded = payload + (payload & 1)
        if mem.invalid(padded):
            mem.fail(f"chunk {fourcc!r} of {payload} bytes runs past the RIFF chunk")
        if padded > mem.left():
            mem.fail(f"truncated chunk {fourcc!r}")
        chunk = (chunk_start, 8 + padded)
        if fourcc == b"ALPH" and alphas == 0:
            alphas += 1
            frame["alpha"] = chunk
            mem.start += padded
        elif fourcc in (b"VP8 ", b"VP8L") and images == 0:
            if fourcc == b"VP8L" and alphas:
                mem.fail("an ALPH chunk before a VP8L image, which carries its own alpha")
            body = mem.data[chunk_start + 8:chunk_start + 8 + padded]
            info, why = vp8_header(body, payload) if fourcc == b"VP8 " else vp8l_header(body)
            if info is None:
                mem.fail(why)
            images += 1
            frame.update(image=chunk, width=info[0], height=info[1], lossless=fourcc == b"VP8L")
            mem.start += padded
        else:  # another chunk: the frame ends before it
            mem.start -= 8
            return
        if mem.start == mem.riff_end:
            return
        if mem.left() < 8:
            mem.fail("truncated chunk header")


def _demux(path: str, data: bytes):
    """libwebp's demuxer over a whole file: (canvas width, height, VP8X
    flags or None, frames)."""
    mem = _Mem(path, data)
    first = mem.data[12:16]
    frames: List[dict] = []
    if first in (b"VP8 ", b"VP8L"):
        frame = {"x": 0, "y": 0, "alpha": None}
        _store_frame(mem, 8, frame)
        frames.append(frame)
        return frame["width"], frame["height"], None, frames
    if first != b"VP8X":
        mem.fail(f"first chunk {first!r}")
    mem.start += 4
    size = mem.u32()
    if size > _MAX_CHUNK_PAYLOAD or size < 10:
        mem.fail(f"VP8X chunk of {size} bytes")
    size += size & 1
    if mem.invalid(size) or mem.left() < size:
        mem.fail("truncated VP8X chunk")
    flags = mem.data[mem.start]
    cw = 1 + int.from_bytes(mem.data[mem.start + 4:mem.start + 7], "little")
    ch = 1 + int.from_bytes(mem.data[mem.start + 7:mem.start + 10], "little")
    if cw * ch >= _MAX_IMAGE_AREA:
        mem.fail(f"canvas of {cw}x{ch}")
    mem.start += size
    if mem.invalid(8) or mem.left() < 8:
        mem.fail("no chunk after VP8X")
    animation = bool(flags & _ANIMATION)
    anim_chunks = 0
    while True:
        chunk_start = mem.start
        fourcc = mem.data[mem.start:mem.start + 4]
        mem.start += 4
        payload = mem.u32()
        if payload > _MAX_CHUNK_PAYLOAD:
            mem.fail(f"chunk {fourcc!r} of {payload} bytes")
        padded = payload + (payload & 1)
        if mem.invalid(padded):
            mem.fail(f"chunk {fourcc!r} of {payload} bytes runs past the RIFF chunk")
        if fourcc == b"VP8X":
            mem.fail("a second VP8X chunk")
        elif fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_chunks or animation:
                mem.fail(f"{fourcc.decode()} outside an ANMF frame of an animation")
            if frames:
                mem.fail("a second image")
            mem.start = chunk_start
            frame = {"x": 0, "y": 0, "alpha": None}
            _store_frame(mem, 8, frame)
            if not flags & _ALPHA and frame["alpha"] is not None:  # alpha without the flag is dropped
                frame["alpha"] = None
            frames.append(frame)
        elif fourcc == b"ANIM":
            if padded < 6:
                mem.fail(f"ANIM chunk of {payload} bytes")
            if mem.left() < padded:
                mem.fail("truncated ANIM chunk")
            anim_chunks += 1  # its background colour and loop count do not reach the pixels
            mem.start += padded
        elif fourcc == b"ANMF":
            if anim_chunks == 0:
                mem.fail("ANMF before ANIM")
            if mem.invalid(16) or padded < 16:
                mem.fail(f"ANMF chunk of {payload} bytes")
            if mem.left() < 16:
                mem.fail("truncated ANMF chunk")
            d = mem.data[mem.start:mem.start + 16]
            frame = {"x": 2 * int.from_bytes(d[0:3], "little"), "y": 2 * int.from_bytes(d[3:6], "little"),
                     "width": 1 + int.from_bytes(d[6:9], "little"), "height": 1 + int.from_bytes(d[9:12], "little"),
                     "alpha": None}
            if frame["width"] * frame["height"] >= _MAX_IMAGE_AREA:
                mem.fail(f"ANMF frame of {frame['width']}x{frame['height']}")
            mem.start += 16
            start = mem.start
            _store_frame(mem, padded - 16, frame)
            if mem.start - start > padded - 16:
                mem.fail("an ANMF frame's chunks run past it")
            if animation and ("image" in frame or frame["alpha"] is not None):
                frames.append(frame)
        else:  # ICCP, EXIF, XMP and unknown chunks
            if padded > mem.left():
                mem.fail(f"truncated chunk {fourcc!r}")
            mem.start += padded
        if mem.start == mem.riff_end:
            break
        if mem.left() < 8:
            mem.fail("truncated chunk header")
    # IsValidExtendedFormat
    if flags & ~_VALID_FLAGS:
        mem.fail(f"VP8X flags {flags:#04x} beyond the ones defined")
    if not frames:
        mem.fail("no image chunk")
    for f in frames:
        if "image" not in f:
            mem.fail("a frame with ALPH but no image chunk")
        if f["alpha"] is not None and f["alpha"][0] > f["image"][0]:
            mem.fail("ALPH after its image chunk")
        if not animation:
            if (f["x"], f["y"], f["width"], f["height"]) != (0, 0, cw, ch):
                mem.fail(f"a {f['width']}x{f['height']} image in a {cw}x{ch} canvas")
        elif f["x"] + f["width"] > cw or f["y"] + f["height"] > ch:
            mem.fail(f"frame at ({f['x']}, {f['y']}) of {f['width']}x{f['height']} outside the {cw}x{ch} canvas")
    return cw, ch, flags, frames


def _has_alpha(data: bytes, flags: Optional[int], canvas: Tuple[int, int]) -> Optional[bool]:
    """``WebPGetFeatures``' has_alpha for the whole file, or None where it
    fails (Pillow then keeps "RGBA")."""
    if flags is not None and flags & _ANIMATION:
        return bool(flags & _ALPHA)
    riff_size = struct.unpack_from("<I", data, 4)[0]
    pos = 12
    has_alpha = bool(flags & _ALPHA) if flags is not None else False
    alpha_seen = False
    if flags is not None:
        if struct.unpack_from("<I", data, 16)[0] != 10:
            return None
        pos = 30
        total = 4 + 8 + 10
        while True:  # ParseOptionalChunks
            if len(data) - pos < 8:
                return None
            size = struct.unpack_from("<I", data, pos + 4)[0]
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff_size:
                return None
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(data) - pos < disk:
                return None
            alpha_seen = alpha_seen or data[pos:pos + 4] == b"ALPH"
            pos += disk
    size = struct.unpack_from("<I", data, pos + 4)[0]
    if size > riff_size - 12:
        return None
    body = data[pos + 8:]
    info, _ = vp8_header(body, size) if data[pos:pos + 4] == b"VP8 " else vp8l_header(body)
    if info is None or (flags is not None and info[:2] != canvas):
        return None
    if len(info) == 3:  # VP8L: its header's bit, whatever VP8X says
        has_alpha = info[2]
    return has_alpha or alpha_seen


def _decode_frame(path: str, data: bytes, frame: dict, out: np.ndarray):
    """WebPDecode of a frame's fragment (its ALPH chunk to the end of its
    image chunk) into ``out`` [h, w, 4], a view of the canvas."""
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    offset, size = frame["image"]
    body = data[offset + 8:offset + size]
    payload = struct.unpack_from("<I", data, offset + 4)[0]
    if payload > len(body):
        raise ValueError(f"{path}: WebP: truncated image chunk")
    stride = out.strides[0]
    ptr = out.ctypes.data
    if frame["lossless"]:
        rc = lib.webp_decode_vp8l(body, len(body), frame["width"], frame["height"], ptr, stride, err, len(err))
    else:
        alpha = b""
        if frame["alpha"] is not None:
            a_off, _ = frame["alpha"]
            a_size = struct.unpack_from("<I", data, a_off + 4)[0]
            alpha = data[a_off + 8:a_off + 8 + a_size]
        rc = lib.webp_decode_vp8(body, len(body), alpha if frame["alpha"] is not None else None, len(alpha),
                                 frame["width"], frame["height"], ptr, stride, err, len(err))
    if rc != 0:
        raise ValueError(f"{path}: WebP: {err.value.decode()}")


def read_webp(path: str) -> Tuple[np.ndarray, str]:
    """A WebP file as Pillow's array of it, uint8 [H,W,3] "RGB" or [H,W,4]
    "RGBA" (straight alpha), frame 0 of an animation on its canvas."""
    from mlinerf_tpu_torch.utils.image_containers import _check_size

    with open(path, "rb") as f:
        data = f.read()
    cw, ch, flags, frames = _demux(path, data)
    _check_size(path, cw, ch)
    has_alpha = _has_alpha(data, flags, (cw, ch))
    mode = "RGB" if has_alpha is False else "RGBA"
    canvas = np.zeros((ch, cw, 4), np.uint8)
    f = frames[0]
    _decode_frame(path, data, f, canvas[f["y"]:f["y"] + f["height"], f["x"]:f["x"] + f["width"]])
    return (np.ascontiguousarray(canvas[..., :3]) if mode == "RGB" else canvas), mode
