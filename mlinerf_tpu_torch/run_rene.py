"""The pipeline of ``run_rene.sh`` (a ReNe grid of cameras x lights)
through the port's CLIs, in one process: ``python -m
mlinerf_tpu_torch.run_rene [--conf_a configs/rene_savannah_a.yaml]
[--conf_b configs/rene_savannah_b.yaml] [--logroot logs] [--device
cuda|cpu] [--seed N] [--a.b=value ...]``.

Steps: stage-a training, the ``lights_train`` renders (each camera under
the lights it was captured with, with the script's
``--model.render.rand_rays_val=4096
--runtime.inference_chunks_per_dispatch=4``), the ``pair`` pseudo labels,
stage-b training warm-started from stage a on those labels, ``image_test``
of stage b on ``test_custom_transforms.json``, and the script's
relighting video ``video_train_0_67`` (frames 0 to 67 of the training
split). Overrides and ``--seed`` as in ``run_synthetic``; each
step's wall seconds and the last validation of both stages go to
``<logroot>/<conf_b name>/run_rene.json``.
"""

from __future__ import annotations

from mlinerf_tpu_torch.pipelines import chain


VIDEO = "video_train_0_67"  # run_rene.sh's video step


def main(argv=None):
    args, overrides = chain.parse_args("ReNe pipeline (PyTorch port)", "configs/rene_savannah_a.yaml",
                                       "configs/rene_savannah_b.yaml", argv)
    from mlinerf_tpu_torch import test

    def video():
        test.main(["--config", args.conf_b, "--logdir", chain.logdir_of(args.logroot, args.conf_b),
                   "--device", args.device, "--inference_mode", VIDEO, *overrides])

    return chain.run_chain("run_rene", args, overrides, "lights_train", "pair",
                           image_test=["--anno", "test_custom_transforms.json"], tail=[("video_b", video)])


if __name__ == "__main__":
    main()
