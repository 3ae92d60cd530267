"""The wider fuzz of damaged TIFF frames: each file flipped at 1,400 seeded
bits and cut at 140 seeded points, read by Pillow and by the port's
``read_image``; prints each file's disagreements (as
tests/test_torch_damaged_frames.py counts them) and the first few.

    python tests/fuzz_torch_damaged_wide.py SEED [file ...]

The files: old-style JPEG in the interchange form (1x1 in 8-row strips,
2x2 in 16-row strips) and the tables form (2x2, 16-row strips), Group 4 in
13-row strips, ZSTD with predictor 2. Seeds 1 and 2 show none; the
test's WIDE cases are these files under its own seeds.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_damaged_frames import _agree, _bw, _rgb, pillow_outcome, port_outcome  # noqa: E402
from mlinerf_tpu_torch.data import fixtures, tiff_encode  # noqa: E402

FILES = {
    "ojpeg_interchange": lambda: tiff_encode.ojpeg_encode(_rgb(4), "interchange", (1, 1), rows_per_strip=8),
    "ojpeg_interchange_22": lambda: tiff_encode.ojpeg_encode(_rgb(4), "interchange", (2, 2), rows_per_strip=16),
    "ojpeg_tables": lambda: tiff_encode.ojpeg_encode(_rgb(4), "tables", (2, 2), rows_per_strip=16),
    "g4_13": lambda: fixtures.encode_tiff(np.asarray(_bw())[..., None].astype(np.uint8), "group4", rows_per_strip=13),
    "zstd_pred2": lambda: fixtures.encode_tiff(_rgb(4), "zstd", predictor=2),
}


def variants(name, data, seed, flips=1400, cuts=140):
    rng = np.random.default_rng([seed] + list(name.encode()))
    for bit in rng.integers(0, len(data) * 8, flips):
        d = bytearray(data)
        d[bit // 8] ^= 1 << (bit % 8)
        yield f"flip bit {bit % 8} of byte {bit // 8}", bytes(d)
    for at in sorted(rng.integers(len(data) // 8, len(data) - 1, cuts)):
        yield f"cut at {at}", data[:at]


def main():
    seed, names = int(sys.argv[1]), sys.argv[2:] or list(FILES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged.tif")
        for name in names:
            t, bad, n = time.time(), [], 0
            for label, d in variants(name, FILES[name](), seed):
                with open(path, "wb") as f:
                    f.write(d)
                n += 1
                want, got = pillow_outcome(d), port_outcome(path)
                if not _agree(want, got, path):
                    bad.append((label, want if isinstance(want, str) else want[1].shape,
                                got[:120] if isinstance(got, str) else got[1].shape))
            print(f"{name}: {len(bad)} of {n} disagree ({time.time() - t:.1f} s)")
            for row in bad[:4]:
                print("   ", *row, sep=" | ")


if __name__ == "__main__":
    main()
