"""Colored console helpers and heatmap colorization: a copy of the JAX
package's ``utils/console.py``.

Counterpart of the reference's ``imaginaire/utils/termcolor.py:18-43``
(color wrappers, ``PP``, ``alert``) and
``imaginaire/utils/visualization.py:21-41`` (``get_heatmap`` /
``preprocess_image``: single-channel maps colorized before image logging).
Raw ANSI codes (honoring NO_COLOR and non-tty pipes) and an embedded
viridis control-point table instead of termcolor and matplotlib, so a
heatmap is bitwise the JAX package's.
"""

from __future__ import annotations

import os
import pprint
import sys

import numpy as np

_ANSI = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "magenta": 35,
         "cyan": 36, "grey": 90}


def _use_color() -> bool:
    return sys.stdout.isatty() and not os.environ.get("NO_COLOR")


def _wrap(x, code: int) -> str:
    s = str(x)
    return f"\033[{code}m{s}\033[0m" if _use_color() else s


def red(x): return _wrap(x, _ANSI["red"])
def green(x): return _wrap(x, _ANSI["green"])
def blue(x): return _wrap(x, _ANSI["blue"])
def cyan(x): return _wrap(x, _ANSI["cyan"])
def yellow(x): return _wrap(x, _ANSI["yellow"])
def magenta(x): return _wrap(x, _ANSI["magenta"])
def grey(x): return _wrap(x, _ANSI["grey"])


COLORS = {"red": red, "green": green, "blue": blue, "cyan": cyan,
          "yellow": yellow, "magenta": magenta, "grey": grey}


def PP(x) -> str:
    """Pretty-format (reference ``termcolor.PP``)."""
    string = pprint.pformat(x, indent=2)
    if isinstance(x, dict):
        string = "{\n " + string[1:-1] + "\n}"
    return string


def alert(x, color: str = "red") -> None:
    c = COLORS[color]
    print(c("-" * 32))
    print(c(f"* {x}"))
    print(c("-" * 32))


# ---------------------------------------------------------------------------
# Heatmap (reference imaginaire/utils/visualization.py get_heatmap)
# ---------------------------------------------------------------------------

# Viridis control points (matplotlib's perceptually-uniform default),
# linearly interpolated — close enough for debugging imagery with no
# matplotlib dependency at import time.
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415],
    [0.282623, 0.140926, 0.457517],
    [0.253935, 0.265254, 0.529983],
    [0.206756, 0.371758, 0.553117],
    [0.163625, 0.471133, 0.558148],
    [0.127568, 0.566949, 0.550556],
    [0.134692, 0.658636, 0.517649],
    [0.266941, 0.748751, 0.440573],
    [0.477504, 0.821444, 0.318195],
    [0.741388, 0.873449, 0.149561],
    [0.993248, 0.906157, 0.143936],
], np.float32)


def get_heatmap(gray: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """Colorize scalar maps: [...,H,W] in [0,1] -> [...,H,W,3] float.

    ``cmap``: "viridis" (embedded LUT) or "gray" (channel replication, the
    reference's default for ``preprocess_image``). Other names use
    matplotlib when available, else fall back to viridis.
    """
    g = np.clip(np.asarray(gray, np.float32), 0.0, 1.0)
    if cmap == "gray":
        return np.stack([g, g, g], axis=-1)
    if cmap != "viridis":
        try:
            import matplotlib.pyplot as plt

            return plt.get_cmap(cmap)(g)[..., :3].astype(np.float32)
        except Exception:  # pragma: no cover - optional dependency
            pass
    n = len(_VIRIDIS) - 1
    x = g * n
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, n)
    t = (x - lo)[..., None]
    return (_VIRIDIS[lo] * (1.0 - t) + _VIRIDIS[hi] * t).astype(np.float32)


def preprocess_image(images: np.ndarray, from_range=(0.0, 1.0),
                     cmap: str = "gray") -> np.ndarray:
    """Rescale to [0,1] and colorize single-channel maps (reference
    ``visualization.preprocess_image``). Accepts [...,H,W] or [...,H,W,1]
    or [...,H,W,3]; returns [...,H,W,3]."""
    lo, hi = from_range
    img = (np.asarray(images, np.float32) - lo) / max(hi - lo, 1e-12)
    img = np.clip(img, 0.0, 1.0)
    if img.ndim >= 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim < 3 or img.shape[-1] != 3:
        img = get_heatmap(img, cmap=cmap)
    return img
