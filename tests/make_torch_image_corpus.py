"""Writes tests/torch_image_corpus/: small JPEG, PNG, TIFF, BMP, WebP and JPEG 2000 files that
cover what Pillow reads and the port's image reader mirrors, and
``manifest.json`` with
Pillow's reading of each file: its mode, shape and dtype, the sha256 of
``np.asarray(Image.open(f))`` and of ``np.asarray(Image.open(f).resize(s))``
at each stated size, and for a JPEG its frame type and sampling factors.

    python tests/make_torch_image_corpus.py

The files are made from a fixed seed: Pillow writes most of them, the port's
fixture encoders (mlinerf_tpu_torch/data/fixtures.py) the 4:1:1, 4:4:0 and
YCCK JPEGs and the lossless, arithmetic-coded and block-smoothed ones that
Pillow cannot write, and ``png_bytes`` below the PNG layouts Pillow does not
write (2- and 4-bit grey, 16-bit colour, 16-bit grey+alpha,
Adam7 interlace). Beside them, under ``timed/`` and the manifest's
``timed`` key, the frames of fern's images_4 size that chip_smoke.py times
in the codings whose samples only Pillow's reading defines here (see
``timed_files``). The TIFF and BMP files (``container_files``, the
manifest's ``containers`` key) are Pillow's where Pillow writes the coding
and the fixtures' ``encode_tiff``/``encode_bmp`` where it does not (16-bit
RGBA, planar configuration 2, tiles, predictor 3, 12-bit, orientation,
fill order 2, RLE8/RLE4, top-down rows, OS/2 headers, bitfields). The
WebP files (``webp_files``, the manifest's ``webp`` key) are libwebp's
through Pillow (lossy at several qualities and methods, with alpha at
several alpha qualities, lossless with few and many colours, an animation)
and the fixtures' ``encode_webp`` for what Pillow cannot ask libwebp for
(the simple loop filter, 2-8 token partitions, sharpness, segments, raw
alpha and each alpha filter, frame 0 smaller than its canvas); libwebp's
lossy and lossy-with-alpha frames of fern's images_4 size join ``timed``.
The TIFF codings of libtiff's other codecs (``tiff_coding_files``, the
manifest's ``tiff_codings`` key) are Pillow's where Pillow writes them
(CCITT RLE, RLEW, Group 3 1D and 2D with either fill order, Group 4, JPEG
RGB, YCbCr and grey, LZMA, ZSTD in small strips and in one strip over
128 KiB, YCbCr under LZW) and the fixtures' ``encode_tiff`` where it cannot
(data/tiff_encode.py: JPEG in tiles, 4:2:0 and without the subsampling
tag, YCbCr subsampled on libtiff's RGBA path across orientations and with
its own coefficients, ThunderScan, ZSTD frames that reach the decoder's
other paths, Group 4 in tiles, old-style JPEG in both of its forms);
Pillow's Group 4, Group 3 2D and JPEG-in-TIFF frames of fern's images_4
size join ``timed``. The JPEG 2000 files (``jpeg2000_files``, the
manifest's ``jpeg2000`` key) are Pillow's writer's with each option the
port decodes, the fixtures' ``encode_jpeg2000`` for the packet syntax
Pillow cannot ask for, and edited JP2 headers (CMYK, palette, sYCC); Pillow's 9/7 frame of
fern's images_4 size at ``quality_layers=[20]`` joins ``timed``.
Damaged files (``damaged_files``, the manifest's ``damaged`` key) are
flips and cuts of tests/test_torch_damaged_frames.py's cases, each with
Pillow's reading or, where Pillow refuses it, the kind of its error; the
manifest's ``damaged_frames`` records the file sha256 and Pillow's reading
of the 512x512 damaged frames chip_smoke.py writes into its NRHints
stand-in (``fixtures.damaged_frames``, made from a seed, not committed).
tests/test_torch_image_decode.py checks that Pillow still reproduces the
manifest; chip_smoke.py holds the port's reading to it.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "torch_image_corpus")
MANIFEST = os.path.join(CORPUS, "manifest.json")
_COLOUR_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _pack(samples, depth):
    """[R, C, S] sample values -> [R, row bytes] uint8, MSB first."""
    rows = samples.reshape(len(samples), -1)
    if depth == 16:
        return rows.astype(">u2").view(np.uint8).reshape(len(rows), -1)
    if depth == 8:
        return rows.astype(np.uint8)
    bits = ((rows[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(len(rows), -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filtered(rows, bpp, filters):
    """Rows [R, stride] uint8, row y filtered by filters[y] (0-4), each with
    its filter byte in front."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[:, bpp:] = up[:, :-bpp]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])
    out = np.empty((len(rows), rows.shape[1] + 1), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = (x - preds[filters, np.arange(len(rows))]) & 0xFF
    return out.tobytes()


def png_bytes(samples, depth, ctype, interlace=False, rng=None, palette=None, trns=None):
    """A PNG of ``samples`` [H,W,S] (raw sample values at ``depth``) as
    colour type ``ctype``, Adam7-interlaced if asked, each row's filter type
    drawn from ``rng`` (default: all five in turn), with PLTE and tRNS
    bodies if given."""
    h, w, s = samples.shape
    assert s == _COLOUR_SAMPLES[ctype]
    bpp = max(1, s * depth // 8)
    data = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        filters = rng.integers(0, 5, len(sub)) if rng is not None else np.arange(len(sub)) % 5
        data += _filtered(_pack(sub, depth), bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns if isinstance(trns, bytes) else np.asarray(trns, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b"")


def camera_like(h, w, c, seed):
    """Smooth shading with edges and sensor noise, uint8 [H,W,C]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 100 * np.sin(x / (5 + 2 * k) + y / (7 + 3 * k) + k) for k in range(c)], -1)
    base += 40 * ((x // 9 + y // 7) % 2)[..., None]
    return np.clip(base + rng.normal(0, 6, (h, w, c)), 0, 255).astype(np.uint8)


def _pil_jpeg(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def corpus_files():
    """{name: bytes} of every file of the corpus."""
    from mlinerf_tpu_torch.data import fixtures

    rgb = camera_like(40, 48, 3, seed=1)
    files = {
        "jpeg_444.jpg": _pil_jpeg(rgb, "RGB", quality=90, subsampling="4:4:4"),
        "jpeg_422.jpg": _pil_jpeg(rgb, "RGB", quality=90, subsampling="4:2:2"),
        "jpeg_420.jpg": _pil_jpeg(rgb, "RGB", quality=90, subsampling="4:2:0"),
        "jpeg_411.jpg": fixtures.encode_jpeg(rgb, quality=90, subsampling="4:1:1"),  # Pillow's "4:1:1" is 4:2:0
        "jpeg_440.jpg": fixtures.encode_jpeg(rgb, quality=90, subsampling="4:4:0"),
        "jpeg_progressive.jpg": _pil_jpeg(rgb, "RGB", quality=85, subsampling="4:2:0", progressive=True),
        "jpeg_progressive_restart.jpg": _pil_jpeg(rgb, "RGB", quality=85, progressive=True, restart_marker_blocks=3),
        "jpeg_restart.jpg": _pil_jpeg(rgb, "RGB", quality=90, subsampling="4:2:2", restart_marker_blocks=2),
        "jpeg_grey.jpg": _pil_jpeg(camera_like(33, 45, 1, seed=2), "L", quality=90),
        "jpeg_adobe_rgb.jpg": _pil_jpeg(rgb, "RGB", quality=90, subsampling="4:4:4", keep_rgb=True),
        "jpeg_cmyk.jpg": _pil_jpeg(camera_like(24, 32, 4, seed=3), "CMYK", quality=90),
        "jpeg_ycck.jpg": fixtures.encode_jpeg(camera_like(24, 32, 4, seed=4), quality=90, subsampling="4:2:0",
                                              ycck=True),
        "jpeg_qtables16.jpg": _pil_jpeg(rgb, "RGB", qtables=[[300 + 7 * k for k in range(64)],
                                                             [400 + 5 * k for k in range(64)]]),
        "jpeg_37x23.jpg": _pil_jpeg(camera_like(23, 37, 3, seed=5), "RGB", quality=95, subsampling="4:2:0"),
        "jpeg_2x17.jpg": _pil_jpeg(camera_like(17, 2, 3, seed=6), "RGB", quality=95, subsampling="4:2:0"),
    }
    files.update(coding_files())
    rng = np.random.default_rng(7)
    grey = camera_like(29, 37, 1, seed=8).astype(np.int64)
    colour = camera_like(29, 37, 4, seed=9).astype(np.int64)
    for depth in (2, 4, 8):
        n = 1 << depth
        index = rng.integers(0, n, (29, 37, 1))
        palette = rng.integers(0, 256, 3 * n)
        alpha = rng.integers(0, 256, n // 2)  # tRNS may cover only the first entries
        files[f"png_p{depth}_trns.png"] = png_bytes(index, depth, 3, rng=rng, palette=palette, trns=alpha)
    for depth in (1, 2, 4):
        files[f"png_grey{depth}.png"] = png_bytes(grey >> (8 - depth), depth, 0, rng=rng)
    grey16 = grey * 257 + rng.integers(0, 257, grey.shape)
    files["png_grey16.png"] = png_bytes(grey16, 16, 0, rng=rng)
    colour16 = colour * 257 + rng.integers(0, 257, colour.shape)
    files["png_rgb16.png"] = png_bytes(colour16[..., :3], 16, 2, rng=rng)
    files["png_rgba16.png"] = png_bytes(colour16, 16, 6, rng=rng)
    files["png_la8.png"] = png_bytes(colour[..., [0, 3]], 8, 4, rng=rng)
    files["png_la16.png"] = png_bytes(colour16[..., [1, 3]], 16, 4, rng=rng)
    files["png_rgb8_trns.png"] = png_bytes(colour[..., :3], 8, 2, rng=rng, trns=struct.pack(">HHH", 10, 20, 30))
    files["png_adam7_rgb.png"] = png_bytes(colour[..., :3], 8, 2, interlace=True, rng=rng)
    files["png_adam7_grey4.png"] = png_bytes(grey >> 4, 4, 0, interlace=True, rng=rng)
    return files


def coding_files():
    """{name: bytes} of the JPEG codings the fixtures' other encoders write:
    lossless (SOF3) at each predictor with restarts, point transforms,
    subsampling, separate scans and a restart inside a two-row iMCU row;
    arithmetic-coded sequential (SOF9, default and DAC conditioning) and
    progressive (SOF10); progressive files whose scans leave low AC
    coefficients incomplete, which libjpeg smooths (Huffman- and
    arithmetic-coded, DC only, DC and the first AC band, bands left
    unrefined, two blocks wide)."""
    from mlinerf_tpu_torch.data import fixtures

    rgb, grey = camera_like(40, 48, 3, seed=11), camera_like(40, 48, 1, seed=12)
    lossless, dct = fixtures.encode_jpeg_lossless, fixtures.encode_jpeg_dct
    dc_only = [((0, 1, 2), 0, 0, 0, 0)]
    return {
        "jpeg_lossless_p1.jpg": lossless(grey, predictor=1),
        "jpeg_lossless_p2_restart.jpg": lossless(rgb, predictor=2, restart_interval=48),
        "jpeg_lossless_p3_pt2.jpg": lossless(grey, predictor=3, point_transform=2),
        "jpeg_lossless_p4_rgb_ids.jpg": lossless(rgb, predictor=4, app="none", ids=[82, 71, 66]),
        "jpeg_lossless_p5_cmyk.jpg": lossless(camera_like(24, 32, 4, seed=13), predictor=5, point_transform=1),
        "jpeg_lossless_p6_420.jpg": lossless(rgb, predictor=6, sampling=[(2, 2), (1, 1), (1, 1)], restart_interval=48),
        "jpeg_lossless_p7_scans.jpg": lossless(rgb, predictor=7, interleaved=False, restart_interval=96),
        "jpeg_lossless_v2_restart.jpg": lossless(grey, predictor=2, sampling=[(1, 2)], restart_interval=48),
        "jpeg_arith.jpg": dct(rgb, 90, "4:2:0", coding="arithmetic"),
        "jpeg_arith_dac.jpg": dct(rgb, 85, "4:2:2", coding="arithmetic", restart_interval=3, conditioning=((2, 6), 12)),
        "jpeg_arith_progressive.jpg": dct(rgb, 90, "4:2:0", coding="arithmetic", scans=fixtures.progressive_scans(3)),
        "jpeg_arith_progressive_ycck.jpg": dct(camera_like(24, 32, 4, seed=14), 80, "4:2:0", coding="arithmetic",
                                               scans=fixtures.progressive_scans(4), restart_interval=2,
                                               conditioning=((1, 3), 2), ycck=True),
        "jpeg_smooth_dc_only.jpg": dct(rgb, 90, "4:2:0", scans=dc_only),
        "jpeg_smooth_dc_band1.jpg": dct(rgb, 90, "4:4:4", scans=dc_only + [((0,), 1, 5, 0, 0)]),
        "jpeg_smooth_unrefined.jpg": dct(rgb, 90, "4:2:0", scans=fixtures.progressive_scans(3)[:6]),
        "jpeg_smooth_arith.jpg": dct(grey, 75, coding="arithmetic", scans=[((0,), 0, 0, 0, 1), ((0,), 1, 9, 0, 1),
                                                                           ((0,), 10, 63, 0, 0)]),
        "jpeg_smooth_narrow.jpg": dct(camera_like(37, 13, 1, seed=15), 90, scans=[((0,), 0, 0, 0, 0)]),
    }


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def container_files():
    """{name: bytes} of the TIFF and BMP files: each mode Pillow reads from
    a TIFF (1, L, LA, P, PA, I;16, I;16B, I, F, RGB, RGBA, CMYK, LAB) in
    each compression the port decodes (none, LZW, Adobe Deflate, Deflate,
    PackBits) with and without predictor 2, BigTIFF, and the layouts only
    the fixtures write; BMP at every depth and coding Pillow reads."""
    from mlinerf_tpu_torch.data import fixtures

    rng = np.random.default_rng(21)
    rgb, rgba = camera_like(24, 30, 3, seed=22), camera_like(24, 30, 4, seed=23)
    grey = camera_like(24, 30, 1, seed=24)[..., 0]
    wide = camera_like(24, 30, 4, seed=25).astype(np.uint16) * 257 + rng.integers(0, 257, (24, 30, 4)).astype(np.uint16)
    palette = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    p_img = Image.fromarray(grey // 8, "L").convert("P")
    p_img.putpalette(palette)
    pa_img = Image.merge("PA", [p_img, Image.fromarray(rgba[..., 3], "L")])
    pa_img.putpalette(palette)
    tif = fixtures.encode_tiff
    files = {
        "tiff_1_packbits.tif": _pil_bytes(Image.fromarray(grey > 127), "TIFF", compression="packbits"),
        "tiff_l_raw.tif": _pil_bytes(Image.fromarray(grey, "L"), "TIFF"),
        "tiff_la_deflate.tif": _pil_bytes(Image.fromarray(rgba[..., [0, 3]], "LA"), "TIFF", compression="tiff_deflate"),
        "tiff_p_lzw.tif": _pil_bytes(p_img, "TIFF", compression="tiff_lzw"),
        "tiff_pa_raw.tif": _pil_bytes(pa_img, "TIFF"),
        "tiff_i16_lzw_pred2.tif": _pil_bytes(Image.fromarray(wide[..., 0]), "TIFF", compression="tiff_lzw",
                                             tiffinfo={317: 2}),
        "tiff_i16b_raw.tif": _pil_bytes(Image.frombytes("I;16B", (30, 24), wide[..., 1].astype(">u2").tobytes()),
                                        "TIFF"),
        "tiff_i32_deflate.tif": _pil_bytes(Image.fromarray(wide[..., 2].astype(np.int32) * 9973 - 2 ** 28), "TIFF",
                                           compression="tiff_adobe_deflate"),
        "tiff_f32_raw.tif": _pil_bytes(Image.fromarray(grey.astype(np.float32) / 7 - 11.5), "TIFF"),
        "tiff_rgb_lzw_pred2.tif": _pil_bytes(Image.fromarray(rgb), "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "tiff_rgba_adobe_deflate.tif": _pil_bytes(Image.fromarray(rgba, "RGBA"), "TIFF",
                                                  compression="tiff_adobe_deflate"),
        "tiff_cmyk_packbits.tif": _pil_bytes(Image.fromarray(rgba, "CMYK"), "TIFF", compression="packbits"),
        "tiff_lab_raw.tif": _pil_bytes(Image.frombytes("LAB", (30, 24), rgb.tobytes()), "TIFF"),
        "tiff_bigtiff_raw.tif": _pil_bytes(Image.fromarray(rgb), "TIFF", big_tiff=True),  # libtiff's writer: classic
        "tiff_bigtiff_tiles_lzw.tif": tif(rgba[..., :3], "lzw", tile=(16, 16), bigtiff=True),
        "tiff_rgba16_mm_lzw_pred2.tif": tif(wide, "lzw", ">", 2, extra_samples=(2,)),
        "tiff_rgb16_tiles_deflate.tif": tif(wide[..., :3], "adobe_deflate", tile=(16, 16), predictor=2),
        "tiff_rgba_assoc_packbits.tif": tif(rgba, "packbits", extra_samples=(1,), rows_per_strip=5),
        "tiff_planar_rgb_lzw.tif": tif(rgb, "lzw", planar=2, rows_per_strip=7),
        "tiff_planar_rgba_tiles_raw.tif": tif(rgba, tile=(16, 16), planar=2, extra_samples=(2,)),
        "tiff_float_mm_deflate_pred3.tif": tif(grey.astype(np.float32) / 3 - 20, "deflate", ">", 3),
        "tiff_tiles_packbits.tif": tif(rgb, "packbits", tile=(16, 16)),
        "tiff_grey4_minwhite_lzw.tif": tif(grey[..., None] >> 4, "lzw", bits=4, photometric=0, rows_per_strip=9),
        "tiff_grey12_raw.tif": tif(grey[..., None].astype(np.uint16) * 16 + 5, bits=12),
        "tiff_int16_mm_lzw.tif": tif((grey.astype(np.int16) - 128)[..., None] * 97, "lzw", ">"),
        "tiff_orient6_lzw.tif": tif(rgb, "lzw", orientation=6),
        "tiff_orient7_raw.tif": tif(grey, orientation=7),
        "tiff_fill2_1bit_raw.tif": tif((grey > 100)[..., None].astype(np.uint8), bits=1, fill_order=2),
        "bmp_1.bmp": _pil_bytes(Image.fromarray(grey > 127), "BMP"),
        "bmp_l.bmp": _pil_bytes(Image.fromarray(grey, "L"), "BMP"),
        "bmp_p.bmp": _pil_bytes(p_img, "BMP"),
        "bmp_rgb.bmp": _pil_bytes(Image.fromarray(rgb), "BMP"),
        "bmp_rgba_bgrx.bmp": _pil_bytes(Image.fromarray(rgba, "RGBA"), "BMP"),
        "bmp_rle8.bmp": fixtures.encode_bmp(grey // 16 * 3, 8, "rle8", palette=rng.integers(0, 256, (256, 3))),
        "bmp_rle4.bmp": fixtures.encode_bmp(grey // 16, 4, "rle4", palette=rng.integers(0, 256, (16, 3))),
        "bmp_p4_topdown.bmp": fixtures.encode_bmp(grey // 16, 4, palette=rng.integers(0, 256, (16, 3)), top_down=True),
        "bmp_os2_p8.bmp": fixtures.encode_bmp(grey, 8, palette=rng.integers(0, 256, (256, 3)), header=12),
        "bmp_565.bmp": fixtures.encode_bmp(rgb, 16, "bitfields", masks=(0xF800, 0x7E0, 0x1F)),
        "bmp_555_v5.bmp": fixtures.encode_bmp(rgb, 16, "bitfields", header=124, masks=(0x7C00, 0x3E0, 0x1F, 0)),
        "bmp_bgra_v5.bmp": fixtures.encode_bmp(rgba, 32, "bitfields", header=124,
                                               masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "bmp_xbgr_topdown.bmp": fixtures.encode_bmp(rgb, 32, "bitfields", header=56, top_down=True,
                                                    masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    }
    return files


def webp_files():
    """{name: bytes} of the WebP files: Pillow's (libwebp's encoder) where
    Pillow writes the coding, the fixtures' ``encode_webp`` where it does
    not. Odd sizes above one macroblock, and 1x1."""
    from mlinerf_tpu_torch.data import fixtures

    rng = np.random.default_rng(31)
    rgb, rgba = camera_like(23, 37, 3, seed=32), camera_like(29, 21, 4, seed=33)
    grey = camera_like(23, 37, 1, seed=34)[..., 0]
    pal = {n: rng.integers(0, 256, (n, 4), dtype=np.uint8)[(grey.astype(np.int64) * n) // 256] for n in (2, 4, 16)}
    many = camera_like(18, 33, 4, seed=35)
    frames = [Image.fromarray(camera_like(20, 26, 4, seed=s), "RGBA") for s in (36, 37)]
    anim = io.BytesIO()
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:], duration=80, quality=70)
    webp = fixtures.encode_webp
    return {
        "webp_lossy_q75.webp": _pil_bytes(Image.fromarray(rgb), "WEBP", quality=75),
        "webp_lossy_q100_m6.webp": _pil_bytes(Image.fromarray(rgb), "WEBP", quality=100, method=6),
        "webp_lossy_q5_m0.webp": _pil_bytes(Image.fromarray(rgb), "WEBP", quality=5, method=0),
        "webp_lossy_1x1.webp": _pil_bytes(Image.fromarray(rgb[:1, :1]), "WEBP", quality=80),
        "webp_alpha_q90.webp": _pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP", quality=90),
        "webp_alpha_aq40.webp": _pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP", quality=60, alpha_quality=40),
        "webp_lossless_rgb.webp": _pil_bytes(Image.fromarray(rgb), "WEBP", lossless=True),
        "webp_lossless_rgba.webp": _pil_bytes(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True, quality=90),
        "webp_lossless_pal2.webp": _pil_bytes(Image.fromarray(pal[2], "RGBA"), "WEBP", lossless=True),
        "webp_lossless_pal4.webp": _pil_bytes(Image.fromarray(pal[4], "RGBA"), "WEBP", lossless=True),
        "webp_lossless_pal16.webp": _pil_bytes(Image.fromarray(pal[16], "RGBA"), "WEBP", lossless=True),
        "webp_lossless_many.webp": _pil_bytes(Image.fromarray(many, "RGBA"), "WEBP", lossless=True, method=6),
        "webp_lossless_1x1.webp": _pil_bytes(Image.fromarray(rgba[:1, :1], "RGBA"), "WEBP", lossless=True),
        "webp_anim.webp": anim.getvalue(),
        "webp_fx_simple_8parts.webp": webp(rgb, quality=60, filter="simple", partitions=8, seed=1),
        "webp_fx_sharp5_segments.webp": webp(rgb, quality=40, sharpness=5, segments=4, lf_delta=(4, -6),
                                             prob_updates=12, seed=2),
        "webp_fx_bpred_random.webp": webp(rgb, quality=80, intra="bpred", bpred_modes="random", partitions=2, seed=3),
        "webp_fx_raw_alpha_gradient.webp": webp(rgba, quality=70, alpha="raw", alpha_filter="gradient", seed=4),
        "webp_fx_alpha_vertical.webp": webp(rgba, quality=70, alpha_filter="vertical", partitions=4, seed=5),
        "webp_fx_alpha_horizontal_pre.webp": webp(rgba, quality=70, alpha_filter="horizontal",
                                                  alpha_pre_processing=1, seed=6),
        "webp_fx_lossless_all.webp": webp(many, lossless=True, transforms=("subtract_green", "predictor",
                                                                           "cross_color"),
                                          cache_bits=6, meta_bits=2, transform_bits=3, predictor_modes="random",
                                          seed=7),
        "webp_fx_lossless_pal_pred.webp": webp(pal[16], lossless=True, transforms=("palette", "predictor"),
                                               shuffle_palette=True, seed=8),
        "webp_fx_anim_offset.webp": webp(rgba, canvas=(40, 36), offset=(6, 4), quality=70, seed=9),
        "webp_fx_anim_lossless_rgb.webp": webp(rgb, lossless=True, canvas=(48, 30), offset=(10, 6), seed=10),
        "webp_fx_metadata.webp": webp(rgb, metadata=True, unknown_chunk=True, quality=50, seed=11),
    }


def tiff_coding_files():
    """{name: bytes} of the TIFF codings of libtiff's other codecs (see the
    module's docstring); each small, camera-like frames of odd sizes."""
    from PIL import TiffImagePlugin

    from mlinerf_tpu_torch.data import fixtures, tiff_encode

    rgb, grey = camera_like(27, 35, 3, seed=41), camera_like(27, 35, 1, seed=42)[..., 0]
    bw, bw_img = grey > 127, Image.fromarray(camera_like(27, 35, 1, seed=42)[..., 0] > 127)
    ramp = np.add.outer(np.arange(300) // 3, np.arange(160) // 5)[..., None]
    smooth = (ramp * np.array([1, 2, 3]) % 256).astype(np.uint8)
    tif = fixtures.encode_tiff

    def pil(im, **kw):
        return _pil_bytes(im, "TIFF", **kw)

    old = TiffImagePlugin.STRIP_SIZE
    TiffImagePlugin.STRIP_SIZE = 1 << 20  # one strip of 300 x 160 x 3 = 144,000 bytes
    zstd_one_strip = pil(Image.fromarray(smooth), compression="zstd")
    TiffImagePlugin.STRIP_SIZE = old
    return {
        "tiff_pil_ccitt_rle.tif": pil(bw_img, compression="tiff_ccitt"),
        "tiff_pil_ccitt_rlew.tif": pil(Image.fromarray(camera_like(40, 64, 1, seed=45)[..., 0] > 127),
                                       compression="tiff_raw_16"),
        "tiff_pil_g3_1d.tif": pil(bw_img, compression="group3"),
        "tiff_pil_g3_2d.tif": pil(bw_img, compression="group3", tiffinfo={292: 1}),
        "tiff_pil_g3_1d_fill2.tif": pil(bw_img, compression="group3", tiffinfo={266: 2}),
        "tiff_pil_g3_2d_fill2.tif": pil(bw_img, compression="group3", tiffinfo={266: 2, 292: 5}),
        "tiff_pil_g4.tif": pil(bw_img, compression="group4", tiffinfo={278: 10}),
        "tiff_pil_jpeg_rgb.tif": pil(Image.fromarray(rgb), compression="jpeg", tiffinfo={278: 8}),
        "tiff_pil_jpeg_ycbcr.tif": pil(Image.fromarray(rgb).convert("YCbCr"), compression="jpeg", quality=60),
        "tiff_pil_jpeg_grey.tif": pil(Image.fromarray(grey), compression="jpeg", tiffinfo={278: 16}),
        "tiff_pil_lzma_rgb.tif": pil(Image.fromarray(rgb), compression="lzma"),
        "tiff_pil_lzma_pred2.tif": pil(Image.fromarray(rgb), compression="lzma", tiffinfo={317: 2, 278: 9}),
        "tiff_pil_zstd_strips.tif": pil(Image.fromarray(rgb), compression="zstd", tiffinfo={278: 5}),
        "tiff_pil_zstd_rgba_pred2.tif": pil(Image.fromarray(camera_like(27, 35, 4, seed=43), "RGBA"),
                                            compression="zstd", tiffinfo={317: 2}),
        "tiff_pil_zstd_one_strip.tif": zstd_one_strip,
        "tiff_pil_ycbcr_lzw.tif": pil(Image.fromarray(rgb).convert("YCbCr"), compression="tiff_lzw"),
        # A 2x2 tag over full-size samples: libtiff reads each strip short,
        # zero-fills it and converts what it has.
        "tiff_pil_ycbcr_lzw_tag22.tif": pil(Image.fromarray(rgb).convert("YCbCr"), compression="tiff_lzw",
                                            tiffinfo={530: (2, 2), 278: 7}),
        "tiff_fx_jpeg_ycbcr420_tiles.tif": tif(rgb, "jpeg", photometric=6, tile=(16, 16), quality=80),
        "tiff_fx_jpeg_ycbcr420_notag.tif": tif(rgb, "jpeg", photometric=6, rows_per_strip=16,
                                               fields={530: None}),
        "tiff_fx_jpeg_ycbcr422_inline.tif": tif(rgb, "jpeg", photometric=6, ycbcr_subsampling=(2, 1), tables=False),
        "tiff_fx_jpeg_rgb_tiles_mm.tif": tif(rgb, "jpeg", ">", tile=(32, 16)),
        "tiff_fx_jpeg_grey_tiles.tif": tif(grey, "jpeg", tile=(16, 32), quality=70),
        "tiff_fx_ycbcr22_lzw.tif": tif(rgb, "lzw", photometric=6, ycbcr_subsampling=(2, 2), rows_per_strip=6),
        "tiff_fx_ycbcr21_deflate_o2.tif": tif(rgb, "adobe_deflate", photometric=6, ycbcr_subsampling=(2, 1),
                                              orientation=2),
        "tiff_fx_ycbcr12_zstd_o5.tif": tif(rgb, "zstd", photometric=6, ycbcr_subsampling=(1, 2), orientation=5),
        "tiff_fx_ycbcr41_lzma_o6.tif": tif(rgb, "lzma", photometric=6, ycbcr_subsampling=(4, 1), orientation=6),
        "tiff_fx_ycbcr42_packbits_o7.tif": tif(rgb, "packbits", photometric=6, ycbcr_subsampling=(4, 2),
                                               orientation=7, rows_per_strip=8),
        "tiff_fx_ycbcr44_lzw_o8.tif": tif(rgb, "lzw", photometric=6, ycbcr_subsampling=(4, 4), orientation=8),
        "tiff_fx_ycbcr11_tiles_o3.tif": tif(rgb, "lzw", photometric=6, ycbcr_subsampling=(1, 1), tile=(16, 16),
                                            orientation=3),
        "tiff_fx_ycbcr22_tiles_o4.tif": tif(rgb, "deflate", photometric=6, ycbcr_subsampling=(2, 2),
                                            tile=(32, 16), orientation=4),
        "tiff_fx_ycbcr22_coefficients.tif": tif(rgb, "lzw", photometric=6, ycbcr_subsampling=(2, 2), fields={
            529: (5, [2990, 10000, 5870, 10000, 1140, 10000]), 532: (5, [31, 2, 235, 1, 257, 2, 240, 1, 128, 1, 255, 1])}),
        "tiff_fx_ycbcr11_planar_lzw.tif": tif(rgb, "lzw", photometric=6, ycbcr_subsampling=(1, 1), planar=2,
                                              rows_per_strip=10),
        "tiff_fx_ycbcr11_planar_tiles_jpeg.tif": tif(rgb, "jpeg", photometric=6, ycbcr_subsampling=(1, 1), planar=2,
                                                     tile=(16, 16)),
        # Uncompressed YCbCr with a fourth byte a pixel after it: Pillow's
        # raw reader takes the samples as RGBX, unconverted.
        "tiff_fx_ycbcr_raw_rgbx.tif": tiff_encode.tiff_file([camera_like(27, 35, 4, seed=46).tobytes()], {
            256: (4, [35]), 257: (4, [27]), 258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [6]), 277: (3, [3]),
            278: (4, [27])}),
        "tiff_fx_thunderscan.tif": tif(grey >> 4, "thunderscan", rows_per_strip=9),
        "tiff_fx_thunderscan_minwhite.tif": tif(grey[..., None] >> 4, "thunderscan", photometric=0, seed=5),
        "tiff_fx_zstd_checksum.tif": tif(rgb, "zstd", content_size=True, checksum=True, rows_per_strip=16),
        "tiff_fx_zstd_huffman1.tif": tif(rgb // 2, "zstd", literals="huffman1", rows_per_strip=4),
        "tiff_fx_zstd_treeless.tif": tif(rgb // 16, "zstd", literals="treeless", block_size=512, rows_per_strip=27),
        "tiff_fx_zstd_rle.tif": tif(np.full((9, 35, 3), 7, np.uint8), "zstd", literals="rle", rle_blocks=False),
        "tiff_fx_zstd_rle_blocks.tif": tif(np.full((9, 35, 3), 200, np.uint8), "zstd"),
        "tiff_fx_zstd_sequences_rle.tif": tif(np.tile(np.arange(6, dtype=np.uint8), (12, 5, 1))[..., :3], "zstd",
                                              sequences="rle", offsets=(6,)),
        "tiff_fx_zstd_skippable_after.tif": tif(rgb, "zstd", skippable="after", raw_every=2, rows_per_strip=16),
        "tiff_fx_g4_tiles.tif": tif(bw[..., None], "group4", tile=(32, 16)),
        "tiff_fx_g3_2d_k2_fill.tif": tif(bw[..., None], "group3", two_d=True, k=2, fill_bits=True),
        "tiff_fx_g4_minwhite.tif": tif(bw[..., None], "group4", photometric=0),
        "tiff_fx_ccitt_rle_fill2.tif": tif(bw[..., None], "ccitt_rle", fill_order=2),
        "tiff_fx_lzma_rgba16_mm.tif": tif(camera_like(27, 35, 4, seed=44).astype(np.uint16) * 257, "lzma", ">", 2,
                                          extra_samples=(2,)),
        # Old-style JPEG (compression 6), which Pillow cannot write: both
        # of tif_ojpeg.c's forms, strips of whole MCU rows as restart
        # intervals, each subsampling TIFF allows.
        "tiff_fx_ojpeg_tables_22.tif": tiff_encode.ojpeg_encode(rgb, "tables", (2, 2), rows_per_strip=16),
        "tiff_fx_ojpeg_tables_21.tif": tiff_encode.ojpeg_encode(rgb, "tables", (2, 1), rows_per_strip=8, quality=90),
        "tiff_fx_ojpeg_tables_41_o6.tif": tiff_encode.ojpeg_encode(rgb, "tables", (4, 1), fields={274: (3, [6])}),
        "tiff_fx_ojpeg_interchange_11.tif": tiff_encode.ojpeg_encode(rgb, "interchange", (1, 1), rows_per_strip=8),
        "tiff_fx_ojpeg_interchange_22_mm.tif": tiff_encode.ojpeg_encode(rgb, "interchange", (2, 2), byteorder=">",
                                                                         quality=50),
        # The frame's 2x1 wins over the tag's 2x2 (OJPEGSubsamplingCorrect);
        # an RGB photometric reads as YCbCr (tif_dirread.c's OJPEG hack).
        "tiff_fx_ojpeg_interchange_sof_wins.tif": tiff_encode.ojpeg_encode(rgb, "interchange", (2, 1), fields={
            530: (3, [2, 2]), 262: (3, [2])}),
        "tiff_fx_ojpeg_grey.tif": tiff_encode.ojpeg_encode(grey, "tables", rows_per_strip=8),
    }


def jpeg2000_files():
    """{name: bytes} of JPEG 2000 frames of 48 x 64: Pillow's writer with
    each option this port decodes (both wavelets, the RCT and ICT, every
    progression order, quality layers, tiles and tile offsets, precincts,
    code-block sizes, resolutions, PLT, signed samples, its cinema modes,
    cinema4k-24's progression order changes among them, at 32 x 48), the
    fixture encoder's (SOP, EPH, tile-parts, TLM, COC, QCC, Pillow's default
    layout, and what other encoders write: POC in the main header, several
    and overlapping changes, each code-block style bit and all six, an RGN
    max-shift, PPM and PPT, subsampled sYCC chroma), and JP2 headers
    Pillow's writer does not make (CMYK, a palette, sYCC)."""
    from mlinerf_tpu_torch.data import fixtures

    rgb, grey = camera_like(48, 64, 3, seed=51), camera_like(48, 64, 1, seed=52)[..., 0]
    rgba = camera_like(48, 64, 4, seed=53)
    i16 = (camera_like(48, 64, 1, seed=54)[..., 0].astype(np.uint16) * 251 + 13).astype(np.uint16)

    def pil(img, **kw):
        return _pil_bytes(Image.fromarray(img), "JPEG2000", **kw)

    def colr(data, enumcs, extra=b""):
        """A JP2's first colr box given ``enumcs``, ``extra`` boxes after it."""
        at = data.index(b"colr") + 7
        data = data[:at] + struct.pack(">I", enumcs) + data[at + 4:]
        end = data.index(b"colr") - 4 + 15
        jp2h = data.index(b"jp2h") - 4
        data = data[:end] + extra + data[end:]
        return data[:jp2h] + struct.pack(">I", struct.unpack_from(">I", data, jp2h)[0] + len(extra)) + data[jp2h + 4:]

    cinema_rgb, cinema_grey = camera_like(32, 48, 3, seed=55), camera_like(32, 48, 1, seed=56)[..., 0]
    fx = fixtures.encode_jpeg2000
    styles = {f"j2k_fx_style_{bit:02x}.j2k": fx(rgb, "j2k", mct=True, style=bit) for bit in (1, 2, 4, 8, 16, 32)}
    pclr = struct.pack(">I4sHB", 11 + 3 + 3 * 256, b"pclr", 256, 3) + bytes([7, 7, 7]) + bytes(
        (v * k) % 256 for v in range(256) for k in (1, 3, 7))
    return {
        "j2k_pil_rgb.jp2": pil(rgb),
        "j2k_pil_grey.jp2": pil(grey),
        "j2k_pil_la.jp2": pil(rgba[..., :2]),
        "j2k_pil_rgba.jp2": pil(rgba),
        "j2k_pil_i16.jp2": pil(i16),
        "j2k_pil_rgb_mct.j2k": pil(rgb, mct=1, no_jp2=True),
        "j2k_pil_rgb_97.jp2": pil(rgb, irreversible=True, quality_layers=[12]),
        "j2k_pil_rgb_97_ict_layers.jp2": pil(rgb, irreversible=True, mct=1, quality_layers=[40, 20, 8]),
        "j2k_pil_rgb_53_layers.j2k": pil(rgb, mct=1, quality_layers=[30, 10], no_jp2=True),
        "j2k_pil_grey_97_db.jp2": pil(grey, irreversible=True, quality_mode="dB", quality_layers=[28, 36]),
        "j2k_pil_rlcp.jp2": pil(rgb, progression="RLCP", quality_layers=[20, 5]),
        "j2k_pil_rpcl_tiles_plt.jp2": pil(rgb, progression="RPCL", precinct_size=(32, 32), tile_size=(32, 24),
                                          plt=True),
        "j2k_pil_pcrl_precincts.jp2": pil(rgb, progression="PCRL", precinct_size=(16, 16), num_resolutions=3, mct=1),
        "j2k_pil_cprl.j2k": pil(rgba, progression="CPRL", precinct_size=(32, 32), no_jp2=True),
        "j2k_pil_97_tiles.j2k": pil(rgb, irreversible=True, mct=1, tile_size=(24, 16), quality_layers=[15],
                                    no_jp2=True),
        "j2k_pil_codeblocks.jp2": pil(rgb, codeblock_size=(16, 8), num_resolutions=3),
        "j2k_pil_one_resolution.jp2": pil(grey, num_resolutions=1),
        "j2k_pil_signed.jp2": pil(grey, signed=True),
        # Pillow's writer with image and tile offsets: what it reads back is
        # not its source, and the port reads what Pillow reads.
        "j2k_pil_offsets.jp2": pil(rgb, offset=(3, 5), tile_offset=(1, 2), tile_size=(16, 16)),
        "j2k_fx_default_mct.jp2": fixtures.encode_jpeg2000(rgb, "jp2", mct=True),
        "j2k_fx_grey.j2k": fixtures.encode_jpeg2000(grey, "j2k"),
        "j2k_fx_sop_eph_parts_tlm.j2k": fixtures.encode_jpeg2000(rgb, "j2k", sop=True, eph=True, tile_parts=3,
                                                                 tlm=True),
        "j2k_fx_rgba_coc_qcc.jp2": fixtures.encode_jpeg2000(rgba, "jp2", mct=True, coc=True, qcc=True),
        "j2k_hdr_cmyk.jp2": colr(pil(rgba), 12),
        "j2k_hdr_palette.jp2": colr(pil(grey), 16, pclr),
        "j2k_hdr_sycc.jp2": colr(pil(rgb), 18),
        "j2k_hdr_sycc_rgba.jp2": colr(pil(rgba, irreversible=True, quality_layers=[20]), 18),
        "j2k_pil_cinema2k_24.j2k": pil(cinema_rgb, cinema_mode="cinema2k-24", no_jp2=True),
        "j2k_pil_cinema2k_48.jp2": pil(cinema_rgb, cinema_mode="cinema2k-48"),
        "j2k_pil_cinema4k_24_rgb.j2k": pil(cinema_rgb, cinema_mode="cinema4k-24", no_jp2=True),
        "j2k_pil_cinema4k_24_grey.j2k": pil(cinema_grey, cinema_mode="cinema4k-24", no_jp2=True),
        **styles,
        "j2k_fx_style_3f_layers.jp2": fx(rgba, "jp2", style=0x3F, layers=3),
        "j2k_fx_poc_main.j2k": fx(rgb, "j2k", layers=2, poc=[[(0, 0, 1, 3, 2, 0), (1, 1, 2, 4, 3, 1)],
                                                             [(0, 0, 2, 6, 3, 2)]], poc_in="main"),
        "j2k_fx_poc_overlap.jp2": fx(rgba, "jp2", layers=3, poc=[[(0, 0, 2, 6, 4, 3), (2, 1, 3, 5, 3, 0),
                                                                  (0, 0, 3, 6, 4, 4)]]),
        "j2k_fx_rgn.jp2": fx(rgb, "jp2", mct=True, roi=[0, 2]),
        "j2k_fx_ppm.j2k": fx(rgb, "j2k", packed="ppm", tile_parts=3, eph=True, packed_size=40),
        "j2k_fx_ppt.jp2": fx(rgba, "jp2", packed="ppt", tile_parts=2, sop=True, layers=2, packed_size=50),
        "j2k_fx_subsampled_ycc.jp2": fx(rgb, "jp2", ycc=True, subsampling=[(1, 1), (2, 2), (2, 2)], style=0x3F,
                                        roi=[0], layers=2, packed="ppt"),
        "j2k_fx_subsampled_rgb.j2k": fx(rgb, "j2k", subsampling=[(1, 1), (2, 1), (1, 2)], progression=2),
    }


# fern's images_4 frame size, (W, H).
TIMED_SIZE = (1008, 756)


def timed_mask(size):
    """A soft-edged elliptical matte of (W, H), uint8: an object's alpha."""
    w, h = size
    y, x = np.mgrid[0:h, 0:w]
    r = np.hypot((x - w / 2) / (0.4 * w), (y - h / 2) / (0.42 * h))
    return (255 * np.clip((1.1 - r) / 0.2, 0, 1)).round().astype(np.uint8)


def timed_files():
    """{coding: (name, bytes)} of the frames of TIMED_SIZE that
    chip_smoke.py times in the codings whose samples no other reader there
    defines: arithmetic-coded sequential and progressive, and a progressive
    script that leaves bands unrefined, which libjpeg smooths; libwebp's
    lossy WebP, without and with an alpha matte (timed_mask). One seeded
    camera-like frame, quality 75 (Pillow's and cjpeg's default, and
    Pillow's for WebP), 4:2:0: each arithmetic-coded file stays under
    Pillow's 64 KiB read block, past which Pillow refuses it."""
    from mlinerf_tpu_torch.data import fixtures

    frame = fixtures.camera_frame(7, TIMED_SIZE)
    scans = fixtures.progressive_scans(3)
    kinds = {"arithmetic": dict(coding="arithmetic"), "arithmetic_progressive": dict(coding="arithmetic", scans=scans),
             "smoothed": dict(scans=scans[:6])}
    size = f"{TIMED_SIZE[0]}x{TIMED_SIZE[1]}"
    files = {coding: (f"timed/jpeg_{coding}_{size}.jpg", fixtures.encode_jpeg_dct(frame, 75, "4:2:0", **kw))
             for coding, kw in kinds.items()}
    matte = np.concatenate([frame, timed_mask(TIMED_SIZE)[..., None]], -1)
    files["webp_lossy"] = (f"timed/webp_lossy_{size}.webp", _pil_bytes(Image.fromarray(frame), "WEBP", quality=75))
    files["webp_lossy_alpha"] = (f"timed/webp_lossy_alpha_{size}.webp",
                                 _pil_bytes(Image.fromarray(matte, "RGBA"), "WEBP", quality=75))
    ink = Image.fromarray(frame[..., 1] > 120)
    files["tiff_group4"] = (f"timed/tiff_group4_{size}.tif", _pil_bytes(ink, "TIFF", compression="group4"))
    files["tiff_group3_2d"] = (f"timed/tiff_group3_2d_{size}.tif",
                               _pil_bytes(ink, "TIFF", compression="group3", tiffinfo={292: 1}))
    files["tiff_jpeg_ycbcr_pillow"] = (f"timed/tiff_jpeg_ycbcr_pillow_{size}.tif",
                                       _pil_bytes(Image.fromarray(frame).convert("YCbCr"), "TIFF", compression="jpeg",
                                                  quality=75))
    files["jpeg2000_97"] = (f"timed/jpeg2000_97_{size}.jp2",
                            _pil_bytes(Image.fromarray(frame), "JPEG2000", irreversible=True, quality_layers=[20]))
    return files


def jpeg_scans(data):
    """(marker codes in order, [(component ids, Ss, Se, Ah, Al) per SOS])
    of a JPEG, the entropy-coded data skipped."""
    markers, scans = [], []
    pos = 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        markers.append(marker)
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            ns = data[pos + 4]
            ss, se, a = data[pos + 5 + 2 * ns:pos + 8 + 2 * ns]
            scans.append((tuple(data[pos + 5:pos + 5 + 2 * ns:2]), ss, se, a >> 4, a & 15))
            pos += 2 + length
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
            continue
        pos += 2 + length
    return markers, scans


def resize_sizes(w, h):
    """A downscale and an upscale, (W, H) each."""
    return [(max(1, (2 * w) // 3 - 1), max(1, h // 2 + 1)), (w + 7, 2 * h - 1)]


def sha256(arr):
    """Of the array's values (a bool as one byte 0 or 1: Pillow's "1" arrays
    hold 0 and 255 behind their bool dtype)."""
    arr = np.asarray(arr)
    if arr.dtype == bool:
        arr = np.where(arr, 1, 0).astype(np.uint8)
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def jpeg_frame(data):
    """(SOF marker name, [[h, v] per component]) of a JPEG."""
    pos = 2
    while pos < len(data):
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            nc = data[pos + 9]
            comps = data[pos + 10:pos + 10 + 3 * nc]
            return f"SOF{marker - 0xC0}", [[comps[3 * i + 1] >> 4, comps[3 * i + 1] & 15] for i in range(nc)]
        pos += 2 + length
    raise ValueError("no SOF")


# Damaged files (``damaged_files``, the manifest's ``damaged`` key): one
# flip or cut each of tests/test_torch_damaged_frames.py's seeded damage,
# (case, damage label) -> file name.
DAMAGED_PICKS = {
    ("jpeg_baseline", "cut at 698"): "damaged_jpeg_cut.jpg",
    ("jpeg_baseline", "cut at 698, end marker"): "damaged_jpeg_cut_eoi.jpg",
    ("jpeg_baseline_restart", "cut at 651, end marker"): "damaged_jpeg_restart_cut_eoi_resync.jpg",
    ("jpeg_baseline_restart", "flip bit 1 of byte 447"): "damaged_jpeg_restart_hit_markers.jpg",
    ("jpeg_progressive", "cut at 519, end marker"): "damaged_jpeg_progressive_cut_eoi.jpg",
    ("jpeg_progressive", "flip bit 2 of byte 1057"): "damaged_jpeg_progressive_dhp_marker.jpg",
    ("jpeg_stray_rst", None): "damaged_jpeg_stray_rst.jpg",
    ("jpeg_stray_rst_progressive", None): "damaged_jpeg_stray_rst_progressive.jpg",
    ("jpeg_arith", "flip bit 0 of byte 616"): "damaged_jpeg_arith_bad_code.jpg",
    ("jpeg_lossless", "flip bit 1 of byte 3899"): "damaged_jpeg_lossless_resync.jpg",
    ("jpeg_lossless", "flip bit 4 of byte 6156"): "damaged_jpeg_lossless_bad_code.jpg",
    ("png_rgb", "flip bit 7 of byte 6624"): "damaged_png_deflate_tail.png",
    ("png_rgb", "flip bit 0 of byte 30"): "damaged_png_ihdr_crc.png",
    ("tiff_g4", "flip bit 4 of byte 31"): "damaged_tiff_g4.tif",
    ("tiff_g4", "flip bit 7 of byte 194"): "damaged_tiff_g4_no_byte_counts.tif",
    ("tiff_g4", "flip bit 5 of byte 213"): "damaged_tiff_g4_planar_count.tif",
    ("tiff_lzma", "flip bit 5 of byte 8943"): "damaged_tiff_lzma_error_when_full.tif",
    ("tiff_lzma_ycbcr", "flip bit 2 of byte 1953"): "damaged_tiff_lzma_ycbcr.tif",
    ("tiff_deflate_ycbcr", "flip bit 7 of byte 921"): "damaged_tiff_deflate_ycbcr.tif",
    ("tiff_jpeg", "flip bit 7 of byte 670"): "damaged_tiff_jpeg.tif",
    ("tiff_ojpeg", "flip bit 2 of byte 706"): "damaged_tiff_ojpeg.tif",
    ("tiff_lzw", "flip bit 5 of byte 11938"): "damaged_tiff_lzw_planar_count.tif",
    ("webp_lossy", "flip bit 5 of byte 92"): "damaged_webp_skipped_chroma.webp",
    ("webp_lossy", "flip bit 3 of byte 672"): "damaged_webp_refused.webp",
    ("jp2_53", "cut"): "damaged_jp2_cut.jp2",
}


def damaged_files():
    """{name: bytes} of DAMAGED_PICKS: a label of None takes the case's file
    as it is (a damage the case writes itself); "cut" and "cut, end marker"
    the case's first cut."""
    from test_torch_damaged_frames import CASES, damaged

    out = {}
    for (case, label), name in DAMAGED_PICKS.items():
        if label is None:
            out[name] = CASES[case]
            continue
        if label.startswith("flip") and label not in dict(damaged(case, CASES[case])):
            bit, byte = (int(w) for w in label.split()[2::3])
            data = bytearray(CASES[case])
            data[byte] ^= 1 << bit
            out[name] = bytes(data)
            continue
        options = dict(damaged(case, CASES[case]))
        if label in ("cut", "cut, end marker"):
            label = next(k for k in options if k.startswith("cut") and k.endswith("end marker") == (label != "cut"))
        out[name] = options[label]
    return out


def pillow_outcome_entry(path):
    """Pillow's entry for a damaged file: its reading, or the kind of error
    it refuses the file with."""
    try:
        return pillow_entry(path)
    except Exception as e:  # noqa: BLE001  (Pillow's refusals are of many kinds)
        return dict(refused=type(e).__name__)


def damaged_frame_entries():
    """The manifest's ``damaged_frames``: fixtures.damaged_frames(512) as
    chip_smoke.py writes them into its NRHints stand-in (not committed):
    each file's sha256 and Pillow's reading of it."""
    from mlinerf_tpu_torch.data import fixtures

    entries = {}
    for name, (ext, data) in fixtures.damaged_frames(DAMAGED_FRAME_SIZE, DAMAGED_FRAME_SEED).items():
        with Image.open(io.BytesIO(data)) as im:
            arr = np.asarray(im)
            entries[name] = dict(ext=ext, file_sha256=hashlib.sha256(data).hexdigest(), mode=im.mode,
                                 shape=list(arr.shape), dtype=str(arr.dtype), sha256=sha256(arr))
    return entries


DAMAGED_FRAME_SIZE, DAMAGED_FRAME_SEED = 512, 11


def pillow_entry(path):
    """What Pillow reads of a file: the manifest's entry."""
    with Image.open(path) as im:
        arr = np.asarray(im)
        entry = dict(mode=im.mode, shape=list(arr.shape), dtype=str(arr.dtype), sha256=sha256(arr), resized={})
        for size in resize_sizes(*im.size):
            entry["resized"][f"{size[0]}x{size[1]}"] = sha256(np.asarray(im.resize(size)))
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        entry["frame"], entry["sampling"] = jpeg_frame(data)
    return entry


def main():
    sys.path.insert(0, ROOT)
    os.makedirs(CORPUS, exist_ok=True)
    os.makedirs(os.path.join(CORPUS, "timed"), exist_ok=True)

    def write(name, data):
        path = os.path.join(CORPUS, name)
        with open(path, "wb") as f:
            f.write(data)
        return pillow_entry(path)

    manifest = {name: write(name, data) for name, data in sorted(corpus_files().items())}
    containers = {name: write(name, data) for name, data in sorted(container_files().items())}
    webp = {name: write(name, data) for name, data in sorted(webp_files().items())}
    tiff_codings = {name: write(name, data) for name, data in sorted(tiff_coding_files().items())}
    jpeg2000 = {name: write(name, data) for name, data in sorted(jpeg2000_files().items())}
    timed = {coding: dict(file=name, **write(name, data)) for coding, (name, data) in timed_files().items()}
    damaged = {}
    for name, data in sorted(damaged_files().items()):
        with open(os.path.join(CORPUS, name), "wb") as f:
            f.write(data)
        damaged[name] = pillow_outcome_entry(os.path.join(CORPUS, name))
    import PIL
    with open(MANIFEST, "w") as f:
        json.dump(dict(pillow=PIL.__version__, files=manifest, containers=containers, webp=webp,
                       tiff_codings=tiff_codings, jpeg2000=jpeg2000, timed=timed, damaged=damaged,
                       damaged_frames=damaged_frame_entries()), f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(CORPUS, n))
                for n in [*manifest, *containers, *webp, *tiff_codings, *jpeg2000, *damaged])
    print(f"{len(manifest)} JPEG and PNG files, {len(containers)} TIFF and BMP files, {len(webp)} WebP files, "
          f"{len(tiff_codings)} TIFF files of libtiff's other codecs, {len(jpeg2000)} JPEG 2000 files and "
          f"{len(damaged)} damaged files, {total} bytes, and {len(timed)} timed frames, in {CORPUS}")


if __name__ == "__main__":
    main()
