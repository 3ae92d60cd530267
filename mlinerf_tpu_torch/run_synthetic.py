"""The 5-step pipeline of ``run_synthetic.sh`` through the port's CLIs, in
one process, then the metrics: ``python -m mlinerf_tpu_torch.run_synthetic
[--conf_a configs/syn_sphere_a.yaml] [--conf_b configs/syn_sphere_b.yaml]
[--logroot logs] [--device cuda|cpu] [--a.b=value ...]``.

Steps: stage-a training, the ``unpairlights_train`` renders, the ``unpair``
pseudo labels, stage-b training warm-started from stage a on those labels,
``image_test`` of stage b, and the metrics CLI on it (rgb, ref and sha,
without LPIPS where its weights are absent). Dot-path overrides go to
every step that reads a config. Writes each step's wall seconds, the last
validation PSNRs of both stages and the scores to
``<logroot>/<conf_b name>/run_synthetic.json`` and returns them.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _last_validation(logdir):
    """The last ``val/*`` line of a training run's metrics.jsonl (None if
    it validated nowhere)."""
    val = None
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            record = json.loads(line)
            if any(k.startswith("val/") for k in record):
                val = record
    return val


def main(argv=None):
    parser = argparse.ArgumentParser(description="Synthetic 5-step pipeline and metrics (PyTorch port)")
    parser.add_argument("--conf_a", default="configs/syn_sphere_a.yaml")
    parser.add_argument("--conf_b", default="configs/syn_sphere_b.yaml")
    parser.add_argument("--logroot", default="logs")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args, overrides = parser.parse_known_args(argv)
    from mlinerf_tpu_torch import test, train
    from mlinerf_tpu_torch.pipelines import metrics, pseudo_label

    def logdir(conf):
        return os.path.join(args.logroot, os.path.splitext(os.path.basename(conf))[0])

    dir_a, dir_b = logdir(args.conf_a), logdir(args.conf_b)
    renders = os.path.join(dir_a, "output_unpairlights_train")
    device = ["--device", args.device]
    steps = [
        ("train_a", lambda: train.main(["--config", args.conf_a, "--logdir", dir_a, *device, *overrides])),
        ("render_a", lambda: test.main(["--config", args.conf_a, "--logdir", dir_a, "--inference_mode",
                                        "unpairlights_train", *device, *overrides])),
        ("pseudo_label", lambda: pseudo_label.main(["--workdir", renders, "--setting", "unpair", *device])),
        ("train_b", lambda: train.main([
            "--config", args.conf_b, "--logdir", dir_b, *device, *overrides,
            f"--model.use_pre_trained.pt_filename={os.path.join(dir_a, 'latest_checkpoint.txt')}",
            f"--data.train.pseudo_label.pt_file={renders}_pseudo_label/pseudo_label_all.npz"])),
        ("image_test_b", lambda: test.main(["--config", args.conf_b, "--logdir", dir_b, "--inference_mode",
                                            "image_test", *device, *overrides])),
        ("metrics_b", lambda: metrics.main(["--config", args.conf_b, "--output_dir",
                                            os.path.join(dir_b, "output_image"), "--components", "rgb,ref,sha",
                                            "--allow_missing_lpips", *device, *overrides])),
    ]
    seconds, scores = {}, None
    for name, step in steps:
        t0 = time.perf_counter()
        out = step()
        seconds[name] = time.perf_counter() - t0
        print(f"[run_synthetic] {name}: {seconds[name]:.1f} s", flush=True)
        if name == "metrics_b":
            scores = out
    result = dict(conf_a=args.conf_a, conf_b=args.conf_b, overrides=overrides, seconds=seconds,
                  last_validation={"a": _last_validation(dir_a), "b": _last_validation(dir_b)}, scores=scores)
    with open(os.path.join(dir_b, "run_synthetic.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
