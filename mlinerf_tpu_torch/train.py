"""Training CLI: ``python -m mlinerf_tpu_torch.train --config <yaml> [--logdir
DIR] [--checkpoint PATH] [--resume] [--seed N] [--device cuda|cpu]
[--single_gpu] [--profile] [--wandb [--wandb_name NAME]] [--a.b=value ...]``.

The same arguments as the JAX package's ``train.py`` (config, logdir,
checkpoint, resume, seed, ``--local_rank``, ``--single_gpu``, ``--profile``,
``--wandb``, dot-path overrides), plus ``--device``. Trains to ``max_iter``,
logging to ``<logdir>/metrics.jsonl``, validating every ``validation_iter``
steps (PSNR and ``<logdir>/images/<step>/``) and saving checkpoints as
``checkpoint`` in the config says; the last state is saved as
``latest_checkpoint.pkl``. ``--profile`` records a torch.profiler trace into
``<logdir>/profile/trace.json`` and prints its breakdown.

On several GPUs, one process each, through torch's launcher::

    python -m torch.distributed.run --nproc_per_node=N -m mlinerf_tpu_torch.train --config ...

Rank r runs on ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``), and
rank 0 alone writes. On NCCL each training step is a CUDA-graph replay with
its collectives inside (``NCCL_GRAPH_MIXING_SUPPORT=1`` is set where unset;
a blocking wait is refused); gloo steps run eagerly. Each rank prints a
``[dist]`` line at the end (its peak memory, scatter launches, graph
replays and captures, the combine's ms per logged window and bytes per
step, last logged loss).
``--single_gpu`` (``runtime.mesh: none``) refuses a launcher's several ranks.

Stage a trains the whole model. Stage b (``configs/syn_*_b.yaml``) starts
from ``--model.use_pre_trained.pt_filename=<stage-a logdir>/
latest_checkpoint.txt`` (every parameter whose name and shape match),
trains only the parameters ``optim.partial_training`` names, and reads the
pseudo labels of ``--data.train.pseudo_label.pt_file=<...>/
pseudo_label_all.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training (PyTorch port)")
    parser.add_argument("--config", required=True, help="Path to the training config file.")
    parser.add_argument("--logdir", help="Dir for logs and checkpoints.")
    parser.add_argument("--checkpoint", default=None, help="Checkpoint path.")
    parser.add_argument("--resume", action="store_true", help="Also restore the optimizer and iteration.")
    parser.add_argument("--seed", type=int, default=0, help="Random seed.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--local_rank", type=int, default=0,
                        help="(the reference launcher's; the rank's device comes from LOCAL_RANK)")
    parser.add_argument("--single_gpu", action="store_true", help="One process: runtime.mesh none.")
    parser.add_argument("--profile", action="store_true", help="Record a torch.profiler trace of the run.")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb_name", default="default", type=str)
    return parser.parse_known_args(argv)


def main(argv=None):
    """Train; returns the trainer."""
    args, cfg_cmd = parse_args(argv)
    import torch

    from mlinerf_tpu_torch.config import Config, resolve
    from mlinerf_tpu_torch.ops import hashgrid_scatter
    from mlinerf_tpu_torch.parallel import distributed as pdist

    cfg = Config(args.config, cli_args=cfg_cmd)
    cfg["wandb"] = args.wandb
    cfg["wandb_name"] = args.wandb_name
    if args.single_gpu:
        cfg.runtime.mesh = "none"
    device, created = pdist.init_distributed(cfg, args.device)
    trainer = None
    try:
        logdir = args.logdir or os.path.join("logs", os.path.splitext(os.path.basename(args.config))[0])
        if pdist.is_main_process():
            cfg.save_config(logdir)
        Dataset = resolve("dataset", cfg.data.type)
        arrays = Dataset(cfg).as_arrays()
        val_dataset = Dataset(cfg, is_inference=True)
        trainer = resolve("trainer", cfg.trainer.type)(cfg, seed=args.seed, logdir=logdir, device=device)
        trainer.load_checkpoint(args.checkpoint, resume=args.resume)
        if args.profile:
            from mlinerf_tpu_torch.utils import profiling

            profile_dir = os.path.join(logdir, "profile")
            with profiling.trace(profile_dir, trainer.device):
                trainer.train(arrays, val_dataset=val_dataset, show_progress=True)
            if pdist.is_main_process():
                profiling.print_breakdown(profile_dir)
        else:
            trainer.train(arrays, val_dataset=val_dataset, show_progress=True)
        trainer.save_checkpoint(latest=True)
        if trainer.dp is not None:
            trainer.dp.combine_ms()
            report = dict(rank=trainer.rank, world=trainer.world, device=str(trainer.device),
                          writes=trainer.checkpointer.enabled, scatter_launches=hashgrid_scatter.launches,
                          graph_replays=trainer.graphs.replays, graph_captures=trainer.graphs.captures,
                          combine_ms=trainer.dp.step_ms, combine_bytes_per_step=trainer.dp.step_bytes,
                          peak_mem_bytes=torch.cuda.max_memory_allocated(trainer.device)
                          if trainer.device.type == "cuda" else None,
                          last_loss=(trainer.last_scalars or {}).get("train/total_loss"))
            # One write of one line: the ranks share the launcher's stdout.
            sys.stdout.write("[dist] " + json.dumps(report) + "\n")
            sys.stdout.flush()
        if pdist.is_main_process():
            print(f"Done. Logs in {logdir}")
        return trainer
    finally:
        if created:
            if trainer is not None:
                # The step's graphs hold NCCL work on this group's
                # communicator: release them, idle, before it goes.
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize(trainer.device)
                trainer.graphs.clear()
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
