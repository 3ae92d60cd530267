"""The 5-step pipeline of ``run_synthetic.sh`` through the port's CLIs, in
one process, then the metrics: ``python -m mlinerf_tpu_torch.run_synthetic
[--conf_a configs/syn_sphere_a.yaml] [--conf_b configs/syn_sphere_b.yaml]
[--logroot logs] [--device cuda|cpu] [--seed N] [--a.b=value ...]``.

Steps: stage-a training, the ``unpairlights_train`` renders (with the
script's ``--model.render.rand_rays_val=4096
--runtime.inference_chunks_per_dispatch=4``), the ``unpair`` pseudo
labels, stage-b training warm-started from stage a on those labels,
``image_test`` of stage b, and the metrics CLI on it (rgb, ref and sha,
without LPIPS where its weights are absent). ``--seed`` goes to both
training steps (the ray picks, the jitter, the initial weights); dot-path
overrides go to every step that reads a config, and one of a render flag's
keys replaces the script's value. Writes each step's wall seconds, the
last validation PSNRs of both stages and the scores to
``<logroot>/<conf_b name>/run_synthetic.json`` and returns them. The MLI
synthetic set: ``--conf_a configs/syn_hotdog_a.yaml --conf_b
configs/syn_hotdog_b.yaml``.
"""

from __future__ import annotations

import os

from mlinerf_tpu_torch.pipelines import chain


def metrics_step(args, overrides):
    """The tail step: the metrics CLI on stage b's ``image_test`` files,
    returning {"scores": ...}."""
    from mlinerf_tpu_torch.pipelines import metrics

    images = os.path.join(chain.logdir_of(args.logroot, args.conf_b), "output_image")
    return "metrics_b", lambda: dict(scores=metrics.main([
        "--config", args.conf_b, "--output_dir", images, "--components", "rgb,ref,sha", "--allow_missing_lpips",
        "--device", args.device, *overrides]))


def main(argv=None):
    args, overrides = chain.parse_args("Synthetic 5-step pipeline and metrics (PyTorch port)",
                                       "configs/syn_sphere_a.yaml", "configs/syn_sphere_b.yaml", argv)
    return chain.run_chain("run_synthetic", args, overrides, "unpairlights_train", "unpair",
                           tail=[metrics_step(args, overrides)])


if __name__ == "__main__":
    main()
