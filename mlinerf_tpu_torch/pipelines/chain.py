"""The five steps of the shell scripts ``run_synthetic.sh``,
``run_real.sh`` and ``run_rene.sh`` through the port's CLIs, in one
process: stage-a training, the light renders, the pseudo labels, stage-b
training warm-started from stage a on those labels, ``image_test`` of
stage b, then the script's own tail (the metrics, a video).

The scripts differ in the render mode (``unpairlights_train`` or
``lights_train``), the label setting (``unpair`` or ``pair``), the
``image_test`` arguments and the tail. Each passes the render step
``RENDER_FLAGS``; a caller's override of the same key replaces the
script's value. The caller's other overrides go to every step that reads a
config. Each step's wall seconds, the last validation of both stages and
what the tail's steps return go to ``<logroot>/<conf_b name>/<runner>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# The render step's flags in all three scripts.
RENDER_FLAGS = ("--model.render.rand_rays_val=4096", "--runtime.inference_chunks_per_dispatch=4")


def override_key(arg: str) -> str:
    """The dot path of a ``--a.b=v`` / ``--a.b`` / ``--a.b!`` override."""
    return arg.split("=", 1)[0].rstrip("!").lstrip("-")


def with_overrides(defaults: Sequence[str], overrides: Sequence[str]) -> List[str]:
    """``defaults`` with ``overrides`` after them; an override replaces a
    default of the same key instead of repeating it (the config parser
    refuses a key given twice)."""
    keys = {override_key(a) for a in overrides}
    return [a for a in defaults if override_key(a) not in keys] + list(overrides)


def last_validation(logdir):
    """The last ``val/*`` line of a training run's metrics.jsonl (None if
    it validated nowhere)."""
    val = None
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            record = json.loads(line)
            if any(k.startswith("val/") for k in record):
                val = record
    return val


def parse_args(description: str, conf_a: str, conf_b: str, argv=None):
    """The runners' common arguments; returns (args, config overrides)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--conf_a", default=conf_a)
    parser.add_argument("--conf_b", default=conf_b)
    parser.add_argument("--logroot", default="logs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--seed", type=int, default=0, help="Training seed of both stages.")
    return parser.parse_known_args(argv)


def logdir_of(logroot: str, conf: str) -> str:
    return os.path.join(logroot, os.path.splitext(os.path.basename(conf))[0])


# A step: (name, fn). A tail step's fn returns None or a dict that
# ``run_chain`` merges into its result.
Steps = Sequence[Tuple[str, Callable[[], Optional[Dict]]]]


def five_steps(args, overrides: Sequence[str], render_mode: str, setting: str,
               image_test: Sequence[str] = ()) -> List[Tuple[str, Callable[[], object]]]:
    """The scripts' five steps, in order, as (name, fn): stage a in
    ``<logroot>/<conf_a name>``, stage b in ``<logroot>/<conf_b name>``."""
    from mlinerf_tpu_torch import test, train
    from mlinerf_tpu_torch.pipelines import pseudo_label

    dir_a, dir_b = logdir_of(args.logroot, args.conf_a), logdir_of(args.logroot, args.conf_b)
    renders = os.path.join(dir_a, f"output_{render_mode}")
    device = ["--device", args.device]
    seed = ["--seed", str(args.seed)]
    overrides = list(overrides)
    stage_b = ["--config", args.conf_b, "--logdir", dir_b, *device, *overrides]
    return [
        ("train_a", lambda: train.main(["--config", args.conf_a, "--logdir", dir_a, *device, *seed, *overrides])),
        ("render_a", lambda: test.main(["--config", args.conf_a, "--logdir", dir_a, "--inference_mode", render_mode,
                                        *device, *with_overrides(RENDER_FLAGS, overrides)])),
        ("pseudo_label", lambda: pseudo_label.main(["--workdir", renders, "--setting", setting, *device])),
        ("train_b", lambda: train.main([
            *stage_b, *seed, f"--model.use_pre_trained.pt_filename={os.path.join(dir_a, 'latest_checkpoint.txt')}",
            f"--data.train.pseudo_label.pt_file={renders}_pseudo_label/pseudo_label_all.npz"])),
        ("image_test_b", lambda: test.main([*stage_b, "--inference_mode", "image_test", *image_test])),
    ]


def run_chain(runner: str, args, overrides: Sequence[str], render_mode: str, setting: str,
              image_test: Sequence[str] = (), tail: Steps = ()) -> Dict:
    """The five steps, then ``tail``. Writes ``<runner>.json`` in the
    stage-b logdir and returns what it holds."""
    seconds, kept = {}, {}

    def timed(name, step):
        t0 = time.perf_counter()
        out = step()
        seconds[name] = time.perf_counter() - t0
        print(f"[{runner}] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    for name, step in five_steps(args, overrides, render_mode, setting, image_test):
        timed(name, step)
    for name, step in tail:
        kept.update(timed(name, step) or {})
    dir_a, dir_b = logdir_of(args.logroot, args.conf_a), logdir_of(args.logroot, args.conf_b)
    result = dict(conf_a=args.conf_a, conf_b=args.conf_b, seed=args.seed, overrides=list(overrides),
                  render_mode=render_mode, setting=setting, seconds=seconds,
                  last_validation={"a": last_validation(dir_a), "b": last_validation(dir_b)}, **kept)
    with open(os.path.join(dir_b, f"{runner}.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result
