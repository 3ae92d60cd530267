"""Training CLI: ``python -m mlinerf_tpu_torch.train --config <yaml> [--logdir
DIR] [--checkpoint PATH] [--resume] [--seed N] [--device cuda|cpu]
[--a.b=value ...]``.

The same arguments as the JAX package's ``train.py`` (config, logdir,
checkpoint, resume, seed, dot-path overrides), plus ``--device``. Trains
to ``max_iter``, logging to ``<logdir>/metrics.jsonl``, validating every
``validation_iter`` steps and saving checkpoints as ``checkpoint`` in the
config says; the last state is saved as ``latest_checkpoint.pkl``.

Stage a trains the whole model. Stage b (``configs/syn_*_b.yaml``) starts
from ``--model.use_pre_trained.pt_filename=<stage-a logdir>/
latest_checkpoint.txt`` (every parameter whose name and shape match),
trains only the parameters ``optim.partial_training`` names, and reads the
pseudo labels of ``--data.train.pseudo_label.pt_file=<...>/
pseudo_label_all.npz``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training (PyTorch port)")
    parser.add_argument("--config", required=True, help="Path to the training config file.")
    parser.add_argument("--logdir", help="Dir for logs and checkpoints.")
    parser.add_argument("--checkpoint", default=None, help="Checkpoint path.")
    parser.add_argument("--resume", action="store_true", help="Also restore the optimizer and iteration.")
    parser.add_argument("--seed", type=int, default=0, help="Random seed.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser.parse_known_args(argv)


def main(argv=None):
    """Train; returns the trainer."""
    args, cfg_cmd = parse_args(argv)
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(args.config, cli_args=cfg_cmd)
    logdir = args.logdir or os.path.join("logs", os.path.splitext(os.path.basename(args.config))[0])
    cfg.save_config(logdir)
    Dataset = resolve("dataset", cfg.data.type)
    arrays = Dataset(cfg).as_arrays()
    val_dataset = Dataset(cfg, is_inference=True)
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=args.seed, logdir=logdir, device=args.device)
    trainer.load_checkpoint(args.checkpoint, resume=args.resume)
    trainer.train(arrays, val_dataset=val_dataset, show_progress=True)
    trainer.save_checkpoint(latest=True)
    print(f"Done. Logs in {logdir}")
    return trainer


if __name__ == "__main__":
    main()
