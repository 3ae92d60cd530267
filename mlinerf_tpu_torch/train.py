"""Training CLI: ``python -m mlinerf_tpu_torch.train --config <yaml> [--logdir
DIR] [--seed N] [--device cuda|cpu] [--a.b=value ...]``.

The same arguments as the JAX package's ``train.py`` (config, logdir, seed,
dot-path overrides), plus ``--device``. Runs stage-a training to
``max_iter``, logging to ``<logdir>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training (PyTorch port)")
    parser.add_argument("--config", required=True, help="Path to the training config file.")
    parser.add_argument("--logdir", help="Dir for logs.")
    parser.add_argument("--seed", type=int, default=0, help="Random seed.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser.parse_known_args(argv)


def main(argv=None):
    args, cfg_cmd = parse_args(argv)
    from mlinerf_tpu_torch.config import Config, resolve

    cfg = Config(args.config, cli_args=cfg_cmd)
    logdir = args.logdir or os.path.join("logs", os.path.splitext(os.path.basename(args.config))[0])
    cfg.save_config(logdir)
    arrays = resolve("dataset", cfg.data.type)(cfg).as_arrays()
    trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=args.seed, logdir=logdir, device=args.device)
    trainer.train(arrays, show_progress=True)
    print(f"Done. Logs in {logdir}")


if __name__ == "__main__":
    main()
