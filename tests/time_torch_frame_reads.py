"""Times the port's frame reader, ``utils/image_io.read_image``, on
undamaged frames of each coding, for one or more checkouts of the repo on
one host, so that two versions of the reader are compared on the same
machine in the same run.

    python tests/time_torch_frame_reads.py [--repeats 5] ROOT [ROOT ...]

The frames are written once, by this checkout's writers, to a temporary
directory: a 1440x1080 RGB PNG (a raw ReNe frame's size), a 4032x3024
baseline JPEG (fern's), and a 1008x756 frame (fern's ``images_4``) as a
baseline and a lossless JPEG, in each coding of ``fixtures.FRAME_FORMATS``
and as each committed frame of the corpus manifest's ``timed`` key. Then
each ROOT in turn, in a fresh process with ROOT first on ``sys.path``,
reads every frame once (building its native libraries), then REPEATS times,
and prints one JSON line: the root and the median seconds per frame of
each coding. No card is needed; the numbers are the host's.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORPUS = os.path.join(HERE, "torch_image_corpus")

_TIMER = r"""
import json, statistics, sys, time
root, listing, repeats = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
from mlinerf_tpu_torch.utils import image_io
with open(listing) as f:
    frames = json.load(f)
for path in frames.values():
    image_io.read_image(path)
out = {}
for coding, path in sorted(frames.items()):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        image_io.read_image(path)
        times.append(time.perf_counter() - t0)
    out[coding] = statistics.median(times)
print(json.dumps({"root": root, "repeats": repeats, "decode_s": out}))
"""


def write_frames(directory):
    """{coding: path} of the frames, written into ``directory``."""
    sys.path.insert(0, ROOT)
    from mlinerf_tpu_torch.data import fixtures
    from mlinerf_tpu_torch.utils import image_io

    paths = {}

    def put(coding, ext, data):
        paths[coding] = os.path.join(directory, coding + ext)
        with open(paths[coding], "wb") as f:
            f.write(data)

    paths["png_1440x1080"] = os.path.join(directory, "png_1440x1080.png")
    image_io.save_png(paths["png_1440x1080"], fixtures.camera_frame(3, (1440, 1080)))
    paths["jpeg_4032x3024"] = os.path.join(directory, "jpeg_4032x3024.jpg")
    fixtures.save_jpeg(paths["jpeg_4032x3024"], fixtures.camera_frame(5, (4032, 3024)))
    frame = fixtures.camera_frame(7, (1008, 756))
    put("jpeg_baseline", ".jpg", fixtures.encode_jpeg(frame, 75, "4:2:0"))
    put("jpeg_lossless", ".jpg", fixtures.encode_jpeg_lossless(frame, predictor=1, restart_interval=8 * 1008))
    for coding, (ext, write) in sorted(fixtures.FRAME_FORMATS.items()):
        put(coding, ext, write(frame))
    with open(os.path.join(CORPUS, "manifest.json")) as f:
        for coding, entry in json.load(f)["timed"].items():
            paths[f"timed_{coding}"] = os.path.join(CORPUS, entry["file"])
    return paths


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+", help="checkouts of the repo, timed in this order")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    tmp = tempfile.mkdtemp(prefix="frame_reads_")
    try:
        listing = os.path.join(tmp, "frames.json")
        with open(listing, "w") as f:
            json.dump(write_frames(tmp), f)
        for root in args.roots:
            subprocess.run([sys.executable, "-c", _TIMER, os.path.abspath(root), listing, str(args.repeats)],
                           check=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
