"""Data-parallel training on torch.distributed: one process per GPU, the
counterpart of the JAX package's ``parallel/mesh.py``.

The JAX package runs one controller over a device mesh and lets XLA insert
the collectives; the port runs one process per GPU, as the reference's DDP
over NCCL does (``imaginaire/trainers/utils/get_trainer.py:80-88``). The
pieces:

* ``init_distributed`` joins the process group from torch's launcher
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from the mapping form of ``runtime.multihost``: NCCL
  for a CUDA device, gloo for the CPU. A group that is already up is taken
  as it is.
* ``shard_rays`` keeps this rank's contiguous slice of the ray axis (axis 1)
  of a batch: JAX's ``shard_rays_tree`` under the ``"rays"`` and the
  ``"batch"`` mesh, which both shard axis 1.
* ``DataParallel`` combines the ranks' gradients after each backward: the
  replicated leaves by one all-reduce per dtype (sum, then divided by the
  world size: JAX's ``pmean``), and under ``runtime.shard_tables`` the large
  hash tables by a reduce-scatter of their rows, each rank updating its own
  rows, then an all-gather of the live table (JAX's ``shard_hash_tables``).
  ``gather_rays`` gives a loss the whole global batch of a per-ray output.

The same collectives run on NCCL and on gloo, with CUDA or CPU tensors. On
NCCL every collective of a training step is enqueued from the device's
stream, so the step, combine included, is captured in a CUDA graph and
replayed (``captures_collectives``; the JAX package compiles its ``pmean``
into the scanned window's program the same way). gloo runs its collectives
on the host, which no capture can hold: its steps stay eager.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

RAY_AXIS_KEYS = ("ray_idx",)
MIN_SHARD_ROWS = 8192  # JAX's shard_hash_tables min_rows


def mesh_enabled(cfg) -> bool:
    """False for ``runtime.mesh: none`` (``--single_gpu``): no process group."""
    return (cfg.get("runtime") or {}).get("mesh", "rays") not in (None, "none", False)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that writes logs, checkpoints and images."""
    return rank() == 0


def sync_processes(name: str = "barrier") -> None:
    """A barrier across the ranks (nothing on one process). ``name`` says
    in a traceback which barrier a rank waited at."""
    if world_size() > 1:
        dist.barrier()


def nccl_capture_env() -> None:
    """The environment that NCCL collectives captured in a CUDA graph need
    beside eager ones on the same communicator (a key's warm-up step, the
    replica check, validation's barrier, a checkpoint's gathers): graph
    mixing on (``NCCL_GRAPH_MIXING_SUPPORT=1``, set where it is unset; NCCL
    reads it when the communicator is made) and no blocking wait (it polls
    the collective's event from the host, which a capture refuses). Raises
    on a setting that contradicts either."""
    mixing = os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "1")
    blocking = [k for k in ("TORCH_NCCL_BLOCKING_WAIT", "NCCL_BLOCKING_WAIT")
                if os.environ.get(k, "0").strip().lower() not in ("0", "", "false")]
    if mixing != "1" or blocking:
        raise RuntimeError(
            "the training step's NCCL collectives run inside a CUDA graph beside eager ones: that needs "
            f"NCCL_GRAPH_MIXING_SUPPORT=1 (it is {mixing!r}) and no blocking wait (set: {blocking})")


def captures_collectives(device) -> bool:
    """Whether this process's collectives can run inside a CUDA graph: an
    NCCL group on a CUDA device. gloo's run on the host (a CUDA tensor goes
    through a host copy), which a capture cannot hold; on the CPU there is
    no graph."""
    if not (is_initialized() and torch.device(device).type == "cuda" and dist.get_backend() == "nccl"):
        return False
    nccl_capture_env()
    return True


def _rendezvous(cfg) -> Optional[Tuple[str, int, int, int, int]]:
    """(address, port, world size, rank, local rank) from the launcher's
    environment, each value falling back to ``runtime.multihost``'s mapping
    (``coordinator_address`` "host:port", ``num_processes``,
    ``process_id``); None when neither names a world."""
    mh = (cfg.get("runtime") or {}).get("multihost") or {}
    mh = mh if isinstance(mh, dict) else {}
    env = os.environ
    if "WORLD_SIZE" not in env and "num_processes" not in mh:
        return None
    addr, _, port = str(mh.get("coordinator_address") or "localhost:29500").rpartition(":")
    return (env.get("MASTER_ADDR", addr), int(env.get("MASTER_PORT", port)),
            int(env.get("WORLD_SIZE", mh.get("num_processes", 1))), int(env.get("RANK", mh.get("process_id", 0))),
            int(env.get("LOCAL_RANK", 0)))


def init_distributed(cfg, device=None) -> Tuple[torch.device, bool]:
    """Join this process's group; returns (its device, whether this call
    created the group). The device is ``cuda:LOCAL_RANK`` for a CUDA device
    given without an index. Nothing happens under ``runtime.mesh: none`` or
    without a world to join; ``runtime.mesh: none`` under a launcher that
    started more than one rank raises."""
    device = torch.device("cuda" if device is None else device)
    if not mesh_enabled(cfg):
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("runtime.mesh is none (--single_gpu), but the launcher started "
                               f"WORLD_SIZE={os.environ['WORLD_SIZE']} ranks")
        return device, False
    if is_initialized():
        return device, False
    world = _rendezvous(cfg)
    if world is None:
        return device, False
    addr, port, size, this_rank, local_rank = world
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        nccl_capture_env()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://{addr}:{port}",
                            world_size=size, rank=this_rank)
    return device, True


def shard_rays(batch: Dict[str, torch.Tensor], world: int, this_rank: int,
               ray_axis_keys: Iterable[str] = RAY_AXIS_KEYS) -> Tuple[Dict[str, torch.Tensor], bool]:
    """This rank's contiguous slice of axis 1 of ``ray_idx`` and of every
    ``*_sampled`` entry; the per-image entries stay whole. Returns (batch,
    whether it was sliced): a ray count that the world size does not divide
    leaves the batch whole."""
    keys = [k for k in batch if k in ray_axis_keys or k.endswith("_sampled")]
    if world == 1 or not keys or any(batch[k].ndim < 2 or batch[k].shape[1] % world for k in keys):
        return batch, False
    n = batch[keys[0]].shape[1] // world
    return {k: v[:, this_rank * n:(this_rank + 1) * n] if k in keys else v for k, v in batch.items()}, True


class _GatherRays(torch.autograd.Function):
    """All ranks' slices of a per-ray tensor, concatenated along axis 1 in
    rank order. Each rank computes the same loss from the result; the
    combine averages the ranks' gradients, so this rank's slice takes the
    world size's factor and the average is the gradient of that loss."""

    @staticmethod
    def forward(ctx, x):
        world, this_rank = dist.get_world_size(), dist.get_rank()
        full = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(full, x.contiguous())
        ctx.world, ctx.rows = world, slice(this_rank * x.shape[1], (this_rank + 1) * x.shape[1])
        # [world, B, R/world, ...] -> [B, R, ...], rank r's rays at r * R/world.
        return full.view(world, *x.shape).movedim(0, 1).reshape(x.shape[0], world * x.shape[1], *x.shape[2:])

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rows] * ctx.world


def gather_rays(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The global batch of each per-ray tensor ([B, R/world, ...] ->
    [B, R, ...]); differentiable, see ``_GatherRays``."""
    return tuple(_GatherRays.apply(t) for t in tensors)


def _flat(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


class DataParallel:
    """The cross-rank combine of one rank's gradients, in the order of the
    optimizer's parameters.

    ``grad_psum`` True averages every gradient in its own dtype, ``"bf16"``
    averages them in bf16 and hands each back in its dtype (JAX's
    ``:616-621``), False is the global layout (the same average; the
    trainer then gives its coupled losses the global batch). With
    ``shard_tables``, every ``hash_table`` leaf of at least
    ``MIN_SHARD_ROWS`` rows that the world size divides is row-sharded: its
    gradient comes back as this rank's rows only (a reduce-scatter), the
    optimizer keeps moments for those rows, and ``gather_rows`` all-gathers
    the updated rows after the step. The other leaves are replicated.

    Each step's collectives are timed (CUDA events on the card, the host
    clock on the CPU, where gloo is synchronous; under ``shard_tables`` the
    reduce-scatter's and the all-gather's spans summed) and their bytes
    counted: the bytes of the buffers this rank hands to the collectives.
    Inside a CUDA-graph capture the events become the graph's own record
    nodes (``external``), which every replay records again; the figure
    kept is the last step's of each window (:meth:`end_window`,
    :meth:`combine_ms`), read when the host waits for the window anyway."""

    def __init__(self, params: Sequence[torch.Tensor], names: Sequence[str], grad_psum, shard_tables: bool):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.wire_dtype = torch.bfloat16 if grad_psum == "bf16" else None
        self.global_layout = not grad_psum
        self.shards: Dict[int, slice] = {}
        if shard_tables:
            for i, (name, p) in enumerate(zip(names, params)):
                if ".hash_table." in name and p.ndim == 2 and p.shape[0] % self.world == 0 \
                        and p.shape[0] >= MIN_SHARD_ROWS:
                    rows = p.shape[0] // self.world
                    self.shards[i] = slice(self.rank * rows, (self.rank + 1) * rows)
        self.replicated = [i for i in range(len(params)) if i not in self.shards]
        self.step_ms: List[float] = []  # the combine ms of each read window's last step
        self.step_bytes = 0
        self.spans: list = []  # the current step's collectives' spans
        self._window_spans: Optional[list] = None
        self.device = params[0].device
        self._cuda = self.device.type == "cuda"

    # -- timing ---------------------------------------------------------

    def _event(self):
        event = torch.cuda.Event(enable_timing=True, external=torch.cuda.is_current_stream_capturing())
        event.record()
        return event

    def _start(self):
        return self._event() if self._cuda else time.perf_counter()

    def _stop(self, start):
        """Add the span since ``start`` to the current step's."""
        self.spans.append((start, self._event()) if self._cuda else 1e3 * (time.perf_counter() - start))

    def end_window(self, spans: list):
        """Keep ``spans`` (a step's :attr:`spans`: the window's last step,
        eager or a replay of its graph) as the window's combine figure."""
        self._window_spans = spans

    def combine_ms(self) -> List[float]:
        """The combine's milliseconds in the last window's last step (its
        spans summed), appended to :attr:`step_ms`: one figure, or none when
        no window ended since the last call. Waits for the events."""
        spans, self._window_spans = self._window_spans, None
        if spans is None:
            return []
        ms = 0.0
        for span in spans:
            if isinstance(span, float):
                ms += span
            else:
                span[1].synchronize()
                ms += span[0].elapsed_time(span[1])
        self.step_ms.append(ms)
        return [ms]

    # -- the combine ----------------------------------------------------

    def _groups(self, grads, indices):
        groups: Dict[torch.dtype, List[int]] = {}
        for i in indices:
            groups.setdefault(self.wire_dtype or grads[i].dtype, []).append(i)
        return groups.items()

    def combine(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ranks' mean of each gradient: whole for the replicated
        leaves, this rank's rows for the sharded ones."""
        self.spans = []  # a new list: a captured step keeps its own
        start = self._start()
        out, nbytes = list(grads), 0
        for dtype, idx in self._groups(grads, self.replicated):
            flat = _flat([grads[i] for i in idx], dtype)
            dist.all_reduce(flat)
            flat.div_(self.world)
            nbytes += flat.numel() * flat.element_size()
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i]).to(grads[i].dtype)
        for dtype, idx in self._groups(grads, sorted(self.shards)):
            # Rank r's rows of every table, one after another: [world, rows...].
            send = torch.cat([grads[i].reshape(self.world, -1).to(dtype) for i in idx], dim=1)
            mine = torch.empty_like(send[0])
            dist.reduce_scatter_tensor(mine, send.reshape(-1))
            mine.div_(self.world)
            nbytes += send.numel() * send.element_size()
            sizes = [grads[i].numel() // self.world for i in idx]
            for i, part in zip(idx, mine.split(sizes)):
                rows = self.shards[i]
                out[i] = part.view(rows.stop - rows.start, -1).to(grads[i].dtype)
        self._stop(start)
        self.step_bytes = nbytes
        return out

    @torch.no_grad()
    def gather_rows(self, tensors: Dict[int, torch.Tensor], timed: bool = True):
        """All-gather the sharded leaves' rows in place: ``tensors`` maps a
        sharded leaf's index to a full-size tensor whose own rows are up to
        date. ``timed``: the step's gather (its time and bytes count)."""
        start = self._start() if timed else None
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in sorted(tensors):
            by_dtype.setdefault(tensors[i].dtype, []).append(i)
        nbytes = 0
        for dtype, idx in by_dtype.items():
            mine = torch.cat([tensors[i][self.shards[i]].reshape(-1) for i in idx])
            full = torch.empty(self.world * mine.numel(), dtype=dtype, device=mine.device)
            dist.all_gather_into_tensor(full, mine)
            nbytes += mine.numel() * mine.element_size()
            sizes = [tensors[i].numel() // self.world for i in idx]
            for r, chunk in enumerate(full.view(self.world, -1)):
                for i, part in zip(idx, chunk.split(sizes)):
                    tensors[i].view(self.world, -1)[r].copy_(part)
        if timed:
            self._stop(start)
            self.step_bytes += nbytes

    def gather_leaf(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole, on the CPU, from every rank's rows of it
        (``shard``, this rank's, on any device)."""
        mine = shard.to(self.device).contiguous()
        full = torch.empty((self.world * mine.shape[0],) + tuple(mine.shape[1:]), dtype=mine.dtype, device=self.device)
        dist.all_gather_into_tensor(full, mine)
        return full.cpu()

    def agree(self, value):
        """Rank 0's ``value`` (a bool or a float), on every rank."""
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.broadcast(t, 0)
        return type(value)(t.item())

    def sq_norms(self, grads: Sequence[torch.Tensor], table_idx: Sequence[int]) -> torch.Tensor:
        """[replicated, sharded, replicated tables, sharded tables] sums of
        squares of the combined gradients; the sharded parts are this
        rank's rows (``reduce_info`` sums them over the ranks)."""
        def sq(indices):
            return sum((torch.sum(grads[i].float() ** 2) for i in indices), torch.zeros((), device=grads[0].device))

        tables = set(table_idx)
        sharded = sorted(self.shards)
        return torch.stack([sq(self.replicated), sq(sharded), sq([i for i in self.replicated if i in tables]),
                            sq([i for i in sharded if i in tables])])

    def reduce_info(self, values: torch.Tensor, sq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ranks' mean of ``values`` (losses, metrics) and the global
        gradient norms (all, tables) from ``sq_norms``: one all-reduce."""
        # Slices, not index lists: a list becomes a host tensor copied into
        # the step, which a capture refuses.
        packed = torch.cat([values.float(), sq[1::2].float()])
        dist.all_reduce(packed)
        n = values.numel()
        means = packed[:n] / self.world
        norms = torch.sqrt(sq[0::2] + packed[n:])
        return means, norms

    @torch.no_grad()
    def check_replicas(self, tensors: Sequence[torch.Tensor], what: str):
        """Raise on every rank unless every rank holds rank 0's values,
        bit for bit (one broadcast per dtype and one all-reduce)."""
        mismatched = torch.zeros((), device=tensors[0].device)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, group in by_dtype.items():
            mine = _flat(group, dtype)
            theirs = mine.clone()
            dist.broadcast(theirs, 0)
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[dtype.itemsize]
            mismatched += (mine.view(bits) != theirs.view(bits)).sum()
        dist.all_reduce(mismatched)
        if int(mismatched):
            raise RuntimeError(f"{what}: {int(mismatched)} values differ from rank 0's across the ranks")

