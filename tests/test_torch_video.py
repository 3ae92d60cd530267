"""The relighting video in the port against the JAX package: the pose slerp
(``pose_interpolate``) and ``test_video``'s frames on a ReNe fixture, the
animated PNG that holds them, and ``--inference_mode video_train_0_1``
through the port's inference CLI on the CPU.

``test_video`` gets the same stand-in renderer in both packages (maps drawn
from a seed per frame), so its frames hold the pipeline alone: the slerped
poses, the closest ground truth, the tiles, the labels and the collage.
With OpenCV installed (these tests import it), the JAX package's labels
are Hershey text; the port draws a bitmap font into the same strip. The
frames are compared bitwise outside each label's text box."""

import contextlib
import functools
import io

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import TINY, TINY_FILES, dataset_args, pil_save

from mlinerf_tpu.config import Config as JaxConfig
from mlinerf_tpu.config import resolve as jax_resolve
from mlinerf_tpu.pipelines import inference as jax_inference
from mlinerf_tpu.utils import camera as jax_camera
from mlinerf_tpu_torch import test as test_cli
from mlinerf_tpu_torch import train as train_cli
from mlinerf_tpu_torch.config import Config, resolve
from mlinerf_tpu_torch.data import fixtures
from mlinerf_tpu_torch.pipelines import inference
from mlinerf_tpu_torch.utils import camera
from mlinerf_tpu_torch.utils.image_io import read_apng

SIZE = (18, 24)
CONTENT = ("rgb", "gt", "o_r", "o_s")


def _rotation(q):
    """Rotation matrices [...,3,3] of quaternions (w, x, y, z), float64."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                     np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                     np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def _pose_pairs(rng):
    """(pose_a, pose_b, alpha) [N,3,4], [N,3,4], [N,1]: random rotations,
    nearly aligned ones (the lerp branch) and ones whose quaternions point
    into opposite hemispheres (the sign flip)."""
    qa = rng.normal(size=(24, 4))
    qb = rng.normal(size=(24, 4))
    qb[8:16] = qa[8:16] + rng.normal(size=(8, 4)) * 1e-7
    v = rng.normal(size=(8, 3))
    qa[16:] = np.concatenate([np.full((8, 1), 0.05), v], -1)
    qb[16:] = np.concatenate([np.full((8, 1), 0.05), -v + rng.normal(size=(8, 3)) * 0.2], -1)
    t = rng.uniform(-3, 3, size=(2, 24, 3, 1))
    pa = np.concatenate([_rotation(qa), t[0]], -1).astype(np.float32)
    pb = np.concatenate([_rotation(qb), t[1]], -1).astype(np.float32)
    return pa, pb, rng.uniform(0, 1, size=(24, 1)).astype(np.float32)


def test_pose_interpolate_matches_jax():
    """Within 1e-6 on random, nearly aligned and opposite-hemisphere
    rotations; the result is a rotation, and the ends are the inputs'."""
    pa, pb, alpha = _pose_pairs(np.random.default_rng(0))
    want = np.asarray(jax_camera.pose_interpolate(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(alpha)))
    got = camera.pose_interpolate(torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    R = got[..., :3].astype(np.float64)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    q_a = camera.R_to_q(torch.from_numpy(pa[..., :3]))
    q_b = camera.R_to_q(torch.from_numpy(pb[..., :3]))
    assert (torch.sum(q_a[16:] * q_b[16:], -1) < 0).all()
    for a, end in ((0.0, pa), (1.0, pb)):
        ends = camera.pose_interpolate(torch.from_numpy(pa), torch.from_numpy(pb), torch.full((24, 1), a)).numpy()
        np.testing.assert_allclose(ends, end, rtol=0, atol=1e-5)


class StandInTrainer:
    """``inference_outputs`` that draws its maps from a seed per call and
    records the poses it was given."""

    def __init__(self):
        self.calls = []

    def inference_outputs(self, data, image_size):
        self.calls.append({k: np.array(v) for k, v in data.items()})
        rng = np.random.default_rng(len(self.calls))
        return {f"{k}_map": rng.uniform(-0.1, 1.1, (1, *image_size, 3)).astype(np.float32)
                for k in ("rgb", "o_r", "o_s")}


@pytest.fixture(scope="module")
def rene(tmp_path_factory):
    root = tmp_path_factory.mktemp("rene_video")
    annotations = fixtures.write_rene(str(root / "scene"), "dataset_rene/savannah", cameras=2, lights=2,
                                      raw_size=(144, 108), save=pil_save)
    args = TINY_FILES + dataset_args(str(root / "scene"), annotations, SIZE)
    jcfg = JaxConfig("configs/rene_savannah_b.yaml", cli_args=args)
    tcfg = Config("configs/rene_savannah_b.yaml", cli_args=args)
    for cfg in (jcfg, tcfg):
        cfg.data.train.pseudo_label.enabled = False
    return dict(jax=jax_resolve("dataset", jcfg.data.type)(jcfg), port=resolve("dataset", tcfg.data.type)(tcfg))


@pytest.fixture(scope="module")
def videos(rene, tmp_path_factory):
    """``test_video`` of frames 0 -> 3 (another camera and another light)
    in both packages; the JAX package's frames from its ``write_video``,
    the port's from its ``write_apng`` (which then writes the file)."""
    out = tmp_path_factory.mktemp("videos")
    captured = {}
    mp = pytest.MonkeyPatch()

    def capture(name, write=None):
        def fn(path, frames, fps):
            captured[name] = dict(path=path, frames=[np.array(f) for f in frames], fps=fps)
            if write is not None:
                write(path, frames, fps=fps)
        return fn

    mp.setattr(jax_inference, "write_video", capture("jax"))
    mp.setattr(inference, "write_apng", capture("port", inference.write_apng))
    trainers = {"jax": StandInTrainer(), "port": StandInTrainer()}
    try:
        jax_inference.test_video(trainers["jax"], rene["jax"], 0, 3, str(out / "jax"), video_content=CONTENT,
                                 image_size=SIZE)
        path = inference.test_video(trainers["port"], rene["port"], 0, 3, str(out / "port"), video_content=CONTENT,
                                    image_size=SIZE)
    finally:
        mp.undo()
    return dict(captured=captured, trainers=trainers, path=path)


def test_video_poses_match_jax(videos):
    """60 renders, each at the JAX package's slerped camera and light
    (within 1e-6), with frame 0's intrinsics."""
    jcalls, tcalls = (videos["trainers"][k].calls for k in ("jax", "port"))
    assert len(jcalls) == len(tcalls) == 60
    for j, t in zip(jcalls, tcalls):
        for key in ("pose", "pose_light", "intr"):
            np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-6, err_msg=key)


def _label_boxes(tile_shape, rows, cols, labels, padding=5):
    """[H,W] bool: the text box of every tile's label in a collage, the
    larger of OpenCV's (scale 0.5) and the bitmap font's, 2 pixels round."""
    th, tw = tile_shape
    mask = np.zeros((th * rows, tw * cols + padding * (cols - 1)), bool)
    for i, text in enumerate(labels):
        (w, h), below = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        y0, x0 = (i // cols) * th, (i % cols) * (tw + padding)
        base = y0 + th - 6
        mask[max(base - max(h, 7) - 2, y0):base + max(below, 2) + 3,
             x0 + 8:min(x0 + 10 + max(w, 6 * len(text)) + 3, x0 + tw)] = True
    return mask


def test_video_frames_match_jax(videos):
    """120 frames (60 forward, then mirrored) at 30 fps in both: the same
    collage shape, every pixel equal outside the label boxes, and ink in
    each of the port's labels."""
    jv, tv = videos["captured"]["jax"], videos["captured"]["port"]
    assert len(jv["frames"]) == len(tv["frames"]) == 120 and jv["fps"] == tv["fps"] == 30
    tile = (SIZE[0] + 16, SIZE[1])
    labels = ["rgb", "gt (closest)", "o_r", "o_s"]
    boxes = _label_boxes(tile, 2, 2, labels)
    for i, (j, t) in enumerate(zip(jv["frames"], tv["frames"])):
        assert t.shape == j.shape == (2 * tile[0], 2 * tile[1] + 5, 3) and t.dtype == np.uint8
        assert np.array_equal(t[~boxes], j[~boxes]), f"frame {i} differs outside the labels"
        assert (t[boxes] == 0).any() and (t[~boxes] == 0).sum() < (t == 0).sum()
    for k in range(60):
        np.testing.assert_array_equal(tv["frames"][119 - k], tv["frames"][k])
    assert tv["path"].endswith("video_0_3.apng") and jv["path"].endswith("video_0_3.mp4")


def test_apng_reads_back(videos):
    """The file holds the 120 frames, each equal to its collage, read by
    the port (``read_apng``) and by Pillow, 1/30 s each, looping."""
    frames = videos["captured"]["port"]["frames"]
    got, delays = read_apng(videos["path"])
    assert len(got) == 120 and delays == [1 / 30] * 120
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    with Image.open(videos["path"]) as im:
        assert im.n_frames == 120 and im.info.get("loop") == 0
        for i in range(0, 120, 7):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frames[i])


def test_video_cli(tmp_path, monkeypatch):
    """``python -m mlinerf_tpu_torch.test --inference_mode video_train_0_1
    --device cpu`` writes ``output_video_train/video_0_1.apng``: the rgb
    and the ground-truth tiles of each frame, forward then backward
    (test_video's 60 frames cut to 4 here: 60 renders cost minutes on a
    loaded CPU; the 120-frame file is held in test_apng_reads_back)."""
    logdir = str(tmp_path / "a")
    args = ["--config", "configs/syn_sphere_a.yaml", "--logdir", logdir, "--device", "cpu",
            *[a for a in TINY if "image_size" not in a], "--data.train.image_size=[16,16]",
            "--data.val.image_size=[16,16]"]
    monkeypatch.setattr(inference, "test_video", functools.partial(inference.test_video, num_frames=4))
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(args + ["--max_iter=1", "--logging_iter=1"])
        test_cli.main(args + ["--inference_mode", "video_train_0_1"])
    frames, delays = read_apng(f"{logdir}/output_video_train/video_0_1.apng")
    assert len(frames) == 8 and frames[0].shape == (32, 37, 3) and delays == [1 / 30] * 8
    assert not np.array_equal(frames[0], frames[3])
