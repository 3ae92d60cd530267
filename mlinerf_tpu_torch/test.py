"""Inference CLI: ``python -m mlinerf_tpu_torch.test --config <yaml>
[--logdir DIR] [--checkpoint PATH] [--device cuda|cpu] --inference_mode
<mode>_<split> [--a.b=value ...]``.

The same arguments as the JAX package's ``test.py``, plus ``--device``
(CUDA unless the CPU is asked for). Under torch's launcher rank 0 renders
and writes, and the other ranks wait for it at a barrier. Loads ``--checkpoint`` (default: the
``latest_checkpoint.txt`` pointer in the logdir), at its trained iteration,
and writes to ``<logdir>/output_<mode>`` (``_train`` appended for the
training split). Modes, each ``_train`` or ``_test``:

  image          every image's maps as PNGs (``{idx}_{key}.png``);
  lights         each camera under the lights it was captured with;
  unpairlights   each frame under its own and 3 other frames' lights;
  limitedlights  each frame under the lights of the first 4 frames;
  singlelight    each frame under its own light;

the last four write ``results_all.npz``, the input of the pseudo-label
pipeline. ``rene`` renders the frames of the ReNe tags (``c25l10``) as
``{tag}_{key}.png`` and ``{tag}_gt.png``; a tag that the split does not hold
is reported and skipped. ``video_<split>_<i>_<j>`` slerps the camera and
the light from frame i to frame j over 60 frames and writes
``video_<i>_<j>.apng`` (the frames forward then backward, 30 fps): the
render's ``rgb`` beside the closest ground truth, and the intrinsic maps
where the config's network mode has them.
"""

from __future__ import annotations

import argparse
import os

_LIGHT_MODES = {"lights": "pair", "unpairlights": "unpair", "limitedlights": "limitedlights",
                "singlelight": "limitedlights"}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Inference (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--single_gpu", action="store_true", help="One process: runtime.mesh none.")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--show_pbar", action="store_true")
    parser.add_argument("--inference_mode", type=str, default="image_test")
    parser.add_argument("--anno", type=str, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Run one inference mode; returns the trainer that rendered it (None
    on the ranks that waited)."""
    args, cfg_cmd = parse_args(argv)
    mode_parts = args.inference_mode.split("_")
    mode, split = mode_parts[:2]
    if mode not in ("image", "rene", "video", *_LIGHT_MODES):
        raise NotImplementedError(f"--inference_mode {args.inference_mode}: mode '{mode}' is not ported")
    if split not in ("train", "test"):
        raise NotImplementedError(f"--inference_mode {args.inference_mode}: split '{split}'")
    import torch

    from mlinerf_tpu_torch.config import Config
    from mlinerf_tpu_torch.parallel import distributed as pdist

    cfg = Config(args.config, cli_args=cfg_cmd)
    if args.single_gpu:
        cfg.runtime.mesh = "none"
    device, created = pdist.init_distributed(cfg, args.device)
    try:
        if not pdist.is_main_process():
            # The renderer is one process: wait for rank 0 rather than exit.
            pdist.sync_processes("inference_done")
            return None
        trainer = _run(args, cfg, mode, split, mode_parts, device)
        pdist.sync_processes("inference_done")
        return trainer
    finally:
        if created:
            torch.distributed.destroy_process_group()


def _run(args, cfg, mode, split, mode_parts, device):
    from mlinerf_tpu_torch.config import resolve
    from mlinerf_tpu_torch.pipelines import inference as inf

    logdir = args.logdir or os.path.join("logs", os.path.splitext(os.path.basename(args.config))[0])
    checkpoint = args.checkpoint or os.path.join(logdir, "latest_checkpoint.txt")
    # Inference loads no pseudo labels and no warm start.
    if cfg.model.get("use_pre_trained"):
        cfg.model.pop("use_pre_trained")
    if cfg.data.train.get("pseudo_label"):
        cfg.data.train.pseudo_label.enabled = False

    Dataset = resolve("dataset", cfg.data.type)
    if split == "train":
        dataset = Dataset(cfg)
        image_size = cfg.data.train.image_size
    else:
        if args.anno is not None:
            cfg.data.val.annotation = os.path.join(os.path.dirname(cfg.data.val.annotation), args.anno)
            cfg.data.val.subset = 0
        dataset = Dataset(cfg, is_inference=True)
        image_size = cfg.data.val.image_size

    trainer = resolve("trainer", cfg.trainer.type)(cfg, is_inference=True, seed=args.seed, logdir=logdir,
                                                   device=device)
    if not trainer.load_checkpoint(checkpoint, resume=False, load_opt=False):
        raise FileNotFoundError(f"no checkpoint at {checkpoint}")
    output_dir = os.path.join(logdir, f"output_{mode}" + (f"_{split}" if split != "test" else ""))
    os.makedirs(output_dir, exist_ok=True)
    if mode == "image":
        inf.test_save(trainer, dataset, output_dir, image_size=image_size, show_pbar=args.show_pbar)
    elif mode == "rene":
        inf.test_images(trainer, dataset, output_dir, setting_list=["c25l10"], image_size=image_size)
    elif mode == "video":
        network_mode = cfg.model.object.rgb.get("network_mode") if "object" in cfg.model else None
        content = ("rgb", "gt")
        if network_mode:
            content += ("o_r", "o_s", "o_re") if len(network_mode.split("_")) == 3 else ("o_r", "o_s")
        inf.test_video(trainer, dataset, int(mode_parts[2]), int(mode_parts[3]), output_dir,
                       video_content=content, image_size=image_size, show_pbar=args.show_pbar)
    else:
        trainer.test_all_light(dataset, output_dir, dataset_type=_LIGHT_MODES[mode],
                               sample_num=1 if mode == "singlelight" else 4, seed=999)
    print(f"Outputs written to {output_dir}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
