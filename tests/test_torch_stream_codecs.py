"""utils/stream_codecs.py and csrc/stream_decode.cpp: Deflate and XZ strips
read as libtiff 4.7's ZIPDecode and LZMADecode read them through zlib and
liblzma. The oracle is this host's zlib and liblzma themselves, called by
ctypes in libtiff's loops (the same libraries Python's ``zlib`` and
``lzma`` use here): for seeded streams of each kind, each with seeded bit
flips, cuts and strip sizes, the hand decoders must write the same bytes
and fail or read the strip where the libraries do. Undamaged streams must
read as Python's modules read them, on both of stream_codecs' paths.
"""

import ctypes
import ctypes.util
import lzma
import zlib

import numpy as np
import pytest

from mlinerf_tpu_torch.utils import stream_codecs


class _ZStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint), ("total_in", ctypes.c_ulong),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p), ("zalloc", ctypes.c_void_p),
                ("zfree", ctypes.c_void_p), ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


class _LzmaStream(ctypes.Structure):
    # lzma_stream: the fields used, then room for the reserved ones (zero,
    # as LZMA_STREAM_INIT leaves them).
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t), ("total_in", ctypes.c_uint64),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p), ("reserved", ctypes.c_byte * 128)]


def _host(name, soname):
    for candidate in (soname, ctypes.util.find_library(name)):
        try:
            return ctypes.CDLL(candidate)
        except (OSError, TypeError):
            continue
    raise AssertionError(f"this host has no {soname}, the oracle of these tests")


def zip_decode(chunk, size):
    """libtiff's ZIPDecode through the host's zlib: (out, read)."""
    z = _host("z", "libz.so.1")
    z.zlibVersion.restype = ctypes.c_char_p
    out = np.zeros(size, np.uint8)
    stream = _ZStream()
    assert z.inflateInit_(ctypes.byref(stream), z.zlibVersion(), ctypes.sizeof(_ZStream)) == 0
    src = ctypes.create_string_buffer(bytes(chunk), len(chunk))
    stream.next_in, stream.next_out = ctypes.addressof(src), out.ctypes.data
    left_in, left_out, read = len(chunk), size, True
    while True:
        stream.avail_in, stream.avail_out = left_in, left_out
        state = z.inflate(ctypes.byref(stream), 1)  # Z_PARTIAL_FLUSH
        left_in, left_out = stream.avail_in, stream.avail_out
        if state == 1:  # Z_STREAM_END
            break
        if state != 0:
            read = False
            break
        if left_out == 0:
            break
    z.inflateEnd(ctypes.byref(stream))
    return out, read and left_out == 0


def lzma_decode(chunk, size):
    """libtiff's LZMADecode through the host's liblzma: (out, read)."""
    lib = _host("lzma", "liblzma.so.5")
    out = np.zeros(size, np.uint8)
    stream = _LzmaStream()
    assert lib.lzma_stream_decoder(ctypes.byref(stream), ctypes.c_uint64(2 ** 64 - 1), ctypes.c_uint32(0)) == 0
    src = ctypes.create_string_buffer(bytes(chunk), len(chunk))
    stream.next_in, stream.avail_in = ctypes.addressof(src), len(chunk)
    stream.next_out, stream.avail_out = out.ctypes.data, size
    while lib.lzma_code(ctypes.byref(stream), 0) == 0 and stream.avail_out:
        pass
    lib.lzma_end(ctypes.byref(stream))
    return out, stream.avail_out == 0


def _raw(rng, n, incompressible=False):
    walk = (np.cumsum(rng.integers(-3, 4, n)) % 256).astype(np.uint8)
    walk[rng.integers(0, n, n // 20)] = rng.integers(0, 256, n // 20)
    if incompressible:
        walk[n // 2:] = rng.integers(0, 256, n - n // 2)
    return walk.tobytes()


_DEFLATE = {  # (level, strategy, size)
    "fixed": (6, zlib.Z_FIXED, 9000),
    "dynamic": (9, zlib.Z_DEFAULT_STRATEGY, 20000),
    "stored": (0, zlib.Z_DEFAULT_STRATEGY, 70000),
    "huffman_only": (1, zlib.Z_HUFFMAN_ONLY, 6000),
    "rle": (4, zlib.Z_RLE, 12000),
}
_XZ = {  # (filters, check, size, incompressible)
    "lzma2": ([{"id": lzma.FILTER_LZMA2, "preset": 6}], lzma.CHECK_NONE, 20000, False),
    "delta_lzma2": ([{"id": lzma.FILTER_DELTA, "dist": 3}, {"id": lzma.FILTER_LZMA2, "preset": 6}],
                    lzma.CHECK_CRC64, 20000, False),
    "lc1_lp3_pb0": ([{"id": lzma.FILTER_LZMA2, "preset": 2, "lc": 1, "lp": 3, "pb": 0}], lzma.CHECK_CRC32, 15000,
                    False),
    "uncompressed_chunks": ([{"id": lzma.FILTER_LZMA2, "preset": 1}], lzma.CHECK_CRC32, 30000, True),
    "several_chunks": ([{"id": lzma.FILTER_LZMA2, "preset": 0, "dict_size": 4096}], lzma.CHECK_CRC64, 300000, False),
}


def _variants(stream, rng, flips):
    """The stream, ``flips`` one-bit flips of it and 10 cuts, each with
    three strip sizes: the data's, 17 bytes less and 7 more."""
    out = [stream]
    for bit in rng.integers(0, len(stream) * 8, flips):
        d = bytearray(stream)
        d[bit // 8] ^= 1 << (bit % 8)
        out.append(bytes(d))
    out += [stream[:at] for at in rng.integers(0, len(stream), 10)]
    return out


def _check(decode, host, stream, size, rng, flips):
    bad = []
    for v in _variants(stream, rng, flips):
        for n in (size, size - 17, size + 7):
            want, read = host(v, n)
            got = np.zeros(n, np.uint8)
            written, error = decode(v, got)
            if (error is None) != read or not np.array_equal(got, want) or (read and written != n):
                bad.append((len(v), n, error, read))
    assert not bad, f"{len(bad)} disagreements with the host's library, the first: {bad[:3]}"


@pytest.mark.parametrize("kind", sorted(_DEFLATE))
def test_inflate_matches_zlib_in_libtiffs_loop(kind):
    level, strategy, size = _DEFLATE[kind]
    rng = np.random.default_rng(list(kind.encode()))
    raw = _raw(rng, size)
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    _check(stream_codecs.inflate_strip, zip_decode, c.compress(raw) + c.flush(), size, rng, 120)


@pytest.mark.parametrize("kind", sorted(_XZ))
def test_xz_matches_liblzma_in_libtiffs_loop(kind):
    filters, check, size, incompressible = _XZ[kind]
    rng = np.random.default_rng(list(kind.encode()))
    raw = _raw(rng, size, incompressible)
    stream = lzma.compress(raw, format=lzma.FORMAT_XZ, check=check, filters=filters)
    _check(stream_codecs.xz_strip, lzma_decode, stream, size, rng, 60 if size > 100000 else 120)


def _lzma2_chunk_ends(stream):
    """The offset just past each LZMA2 chunk of a one-block .xz stream."""
    pos = 12 + (stream[12] + 1) * 4
    ends = []
    while stream[pos] != 0:
        control = stream[pos]
        if control >= 0x80:
            pos += (6 if control >= 0xC0 else 5) + (stream[pos + 3] << 8 | stream[pos + 4]) + 1
        else:
            pos += 3 + (stream[pos + 1] << 8 | stream[pos + 2]) + 1
        ends.append(pos)
    return ends


def test_xz_chunks_must_end_with_the_range_coder_at_zero():
    """Flips in the last four bytes of an LZMA2 chunk leave its symbols and
    its size as they were but not the range coder's final code: liblzma
    fails the chunk there, and the output stops before the next one."""
    filters, check, size, _ = _XZ["several_chunks"]
    raw = _raw(np.random.default_rng(5), size)
    stream = lzma.compress(raw, format=lzma.FORMAT_XZ, check=check, filters=filters)
    ends = _lzma2_chunk_ends(stream)
    assert len(ends) > 2
    bad = []
    for end in ends[:-1]:
        for at in range(end - 4, end):
            for bit in range(8):
                d = bytearray(stream)
                d[at] ^= 1 << bit
                want, read = lzma_decode(bytes(d), size + 7)
                got = np.zeros(size + 7, np.uint8)
                written, error = stream_codecs.xz_strip(bytes(d), got)
                if read or error is None or not np.array_equal(got, want):
                    bad.append((at, bit, written, error, read))
    assert not bad, bad[:3]


@pytest.mark.parametrize("codec", ["deflate", "xz"])
def test_whole_streams_read_alike_on_both_paths(codec):
    """An undamaged stream: Python's module (the fast path) and the hand
    decoder give the same bytes, as do both of stream_codecs' entry points."""
    rng = np.random.default_rng(3)
    for size in (1, 100, 5000, 70000):
        raw = _raw(rng, size)
        if codec == "deflate":
            stream, hand, entry = zlib.compress(raw, 6), stream_codecs.inflate_strip, stream_codecs.inflate_into
        else:
            stream, hand, entry = lzma.compress(raw, format=lzma.FORMAT_XZ), stream_codecs.xz_strip, \
                stream_codecs.unxz_into
        for decode in (hand, entry):
            out = np.zeros(size, np.uint8)
            assert decode(stream, out) == (size, None)
            assert out.tobytes() == raw


def test_a_filter_chain_not_ported_raises():
    stream = lzma.compress(b"x" * 1000, format=lzma.FORMAT_XZ,
                           filters=[{"id": lzma.FILTER_X86}, {"id": lzma.FILTER_LZMA2}])
    with pytest.raises(ValueError, match="not ported"):
        stream_codecs.xz_strip(stream[:-30], np.zeros(1000, np.uint8))
