"""The 5-step pipeline of ``run_real.sh`` (NRHints captures, a point light
per frame) through the port's CLIs, in one process: ``python -m
mlinerf_tpu_torch.run_real [--conf_a configs/NRHints_Pikachu_a.yaml]
[--conf_b configs/NRHints_Pikachu_b.yaml] [--logroot logs] [--device
cuda|cpu] [--seed N] [--a.b=value ...]``.

Steps: stage-a training, the ``unpairlights_train`` renders (with the
script's ``--model.render.rand_rays_val=4096
--runtime.inference_chunks_per_dispatch=4``), the ``unpair`` pseudo
labels, stage-b training warm-started from stage a on those labels, and
``image_test`` of stage b. No metrics: the captures carry no ground-truth
intrinsics and the script scores nothing. Overrides and ``--seed`` as in
``run_synthetic``; each step's wall seconds and the last validation of both
stages go to ``<logroot>/<conf_b name>/run_real.json``.
"""

from __future__ import annotations

from mlinerf_tpu_torch.pipelines import chain


def main(argv=None):
    args, overrides = chain.parse_args("NRHints 5-step pipeline (PyTorch port)", "configs/NRHints_Pikachu_a.yaml",
                                       "configs/NRHints_Pikachu_b.yaml", argv)
    return chain.run_chain("run_real", args, overrides, "unpairlights_train", "unpair")


if __name__ == "__main__":
    main()
