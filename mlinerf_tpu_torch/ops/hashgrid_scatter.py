"""Row gather whose table gradient is a hand-written CUDA scatter-add.

``take_rows(table, idx)`` is ``table.index_select(0, idx)``. Its backward,
the hash-grid table gradient, is ``scatter_add_rows``: on a CUDA tensor it
launches the kernel in ``csrc/scatter_add_rows.cu`` (built with nvcc at
first use) or raises; on a CPU tensor it takes the plain PyTorch version,
``scatter_add_rows_reference``. The plain version serves the CPU tests and
the kernel's check on the card; the training path on a card never runs it.

The module's ``launches`` counts kernel launches, so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mlinerf_tpu_torch.ops import cuda_build


def scatter_add_rows_reference(idx: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    """Plain version: ``out[S,F] = sum_i vals[i]`` into row ``idx[i]``,
    rows outside [0, S) dropped, accumulated in float32."""
    keep = (idx >= 0) & (idx < table_size)
    # Dropped rows go to a spare row S that is cut off afterwards.
    idx = torch.where(keep, idx, torch.full_like(idx, table_size))
    out = torch.zeros(table_size + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx, vals.float())
    return out[:table_size]


launches = 0  # kernel launches by scatter_add_rows, on any CUDA device

_ENTRY_POINTS = {torch.float32: "scatter_add_rows_f32", torch.bfloat16: "scatter_add_rows_bf16"}


def _kernel(dtype: torch.dtype):
    fn = getattr(cuda_build.load("scatter_add_rows"), _ENTRY_POINTS[dtype])
    if fn.argtypes is None:  # without them ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, table_size: int) -> torch.Tensor:
    """Accumulate ``vals[i]`` ([N,F] float32 or bfloat16, F dividing 128)
    into row ``idx[i]`` ([N] int32) of a fresh [table_size, F] float32
    table, summing in float32; rows outside the table are dropped."""
    if idx.dtype != torch.int32 or vals.dtype not in _ENTRY_POINTS:
        raise TypeError(f"scatter_add_rows takes int32 idx and float32 or bfloat16 vals, "
                        f"got {idx.dtype}, {vals.dtype}")
    if vals.dim() != 2 or idx.shape != vals.shape[:1]:
        raise ValueError(f"scatter_add_rows: idx {tuple(idx.shape)} does not index vals {tuple(vals.shape)}")
    n, f = vals.shape
    if f == 0 or 128 % f:
        raise ValueError(f"scatter_add_rows: {f} features per row; the count must divide 128")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add_rows takes contiguous tensors")
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return scatter_add_rows_reference(idx, vals, table_size)
    if vals.device.type != "cuda" or idx.device != vals.device:
        raise ValueError(f"scatter_add_rows: idx on {idx.device}, vals on {vals.device}; "
                         "both must be on the CPU or on one CUDA device")
    # A lane reads min(F, 8) values of a row at once, in loads of at most 16 bytes.
    if vals.data_ptr() % min(min(f, 8) * vals.element_size(), 16):
        raise ValueError("scatter_add_rows: vals is not aligned for the kernel's vector loads")
    out = torch.zeros(table_size, f, dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    with torch.cuda.device(vals.device):
        rc = _kernel(vals.dtype)(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), n, f, table_size,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


class TakeRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose table gradient is accumulated in
    float32 by ``scatter_add_rows``, from the cotangent in its own dtype,
    and cast to the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_size = table.shape[0]
        ctx.table_dtype = table.dtype
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        g = scatter_add_rows(idx, grad.contiguous(), ctx.table_size)
        return g.to(ctx.table_dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return TakeRows.apply(table, idx)
