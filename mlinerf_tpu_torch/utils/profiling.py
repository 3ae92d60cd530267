"""``train.py --profile``: a torch.profiler trace of the run and its time
breakdown by op and by category, the counterpart of the JAX package's
``utils/profiling.py`` (which reads a ``jax.profiler`` XSpace).

``trace`` records the CPU and, on a card, the CUDA activity into
``<profile_dir>/trace.json`` (Chrome's trace format). ``aggregate`` reads
that file back: the device kernels (``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events) where the trace has them, else the host's operators
by self time (a CPU run). ``print_breakdown`` prints the categories
(gather, scatter, dot, all-reduce, collective, copy, ...), each with its
largest op, and the top ops.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, Tuple

import torch

TRACE_NAME = "trace.json"
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# (substring of the lower-cased event name, category), first match wins.
_CATEGORIES = (
    ("scatter_gather", "gather"),  # ATen's gather kernel, _scatter_gather_elementwise_kernel
    ("scatter", "scatter"),
    ("index_add", "scatter"),
    ("gather", "gather"),
    ("index_select", "gather"),
    ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"),
    ("nccl", "collective"),
    ("c10d", "collective"),
    ("gloo", "collective"),
    ("gemm", "dot"),
    ("gemv", "dot"),
    ("aten::mm", "dot"),
    ("aten::addmm", "dot"),
    ("aten::bmm", "dot"),
    ("memcpy", "copy"),
    ("memset", "copy"),
    ("copy", "copy"),
    ("sort", "sort"),
    ("reduce", "reduce"),
    ("elementwise", "elementwise"),
)


def categorize(name: str) -> str:
    """Coarse category of a kernel or operator name."""
    n = name.lower()
    for key, cat in _CATEGORIES:
        if key in n:
            return cat
    return "other"


@contextlib.contextmanager
def trace(profile_dir: str, device: torch.device):
    """Profile the block; the trace lands in ``<profile_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_NAME))


def _self_times(events):
    """Self time of each host operator: its duration less its children's
    on the same thread."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
                out.append(stack.pop())
            if stack:
                stack[-1][1] -= e["dur"]
            stack.append([e, e["dur"]])
        out.extend(stack)
    return [(e["name"], t) for e, t in out]


def aggregate(trace_path: str) -> Tuple[Dict[str, float], Dict[str, float], float, str]:
    """(seconds by op, seconds by category, total seconds, what was
    counted: "device" or "host"). Categories by ``categorize``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [(e["name"], e["dur"]) for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    timed = device or _self_times([e for e in events if e.get("cat") == "cpu_op"])
    per_op: Dict[str, float] = defaultdict(float)
    per_cat: Dict[str, float] = defaultdict(float)
    for name, us in timed:
        per_op[name] += us / 1e6
        per_cat[categorize(name)] += us / 1e6
    return dict(per_op), dict(per_cat), sum(per_op.values()), "device" if device else "host"


def print_breakdown(profile_dir: str, top: int = 20) -> None:
    """Print the category table and the top ops of the trace in a dir."""
    path = os.path.join(profile_dir, TRACE_NAME)
    if not os.path.exists(path):
        print(f"[profile] no {TRACE_NAME} under {profile_dir}")
        return
    per_op, per_cat, total, what = aggregate(path)
    print(f"\n== {what} time by category (total {total:.3f} s; trace {path}; the category's largest op) ==")
    for cat, t in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        largest = max((op for op in per_op if categorize(op) == cat), key=per_op.get)
        print(f"{cat:>18}: {t:8.3f} s  {100 * t / max(total, 1e-12):5.1f}%  {largest[:90]}")
    print(f"\n== top {top} ops ==")
    for name, t in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{t:8.3f} s  {100 * t / max(total, 1e-12):5.1f}%  {name[:110]}")
