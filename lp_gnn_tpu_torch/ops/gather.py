"""Row gather ``out[k] = table[idx[k]]``.

Counterpart of the four TPU VMEM-gather probes,
``scripts/probe_vmem_gather.py`` (``vmem_gather_kernel`` :51,
``vmem_gather_loop_kernel`` :72) and ``scripts/probe_vmem_gather2.py``
(``k_take_along`` :54, ``k_vector_index`` :60), which all compute this one
function. The edge-partitioned forward writes every shard's halo buffer
with one gather over a composed index
(``parallel/edge_partition.py halo_gather``); ``chip_smoke.py`` also times
it beside the SpMM as the cost of the row gather the SpMM is made of.

On a CUDA tensor :func:`gather_rows` launches ``csrc/gather.cu`` or raises;
on a CPU tensor it runs :func:`gather_rows_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_out, count_launch, launch_on

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def _lib():
    fn = _build.load("gather").lp_gather_rows
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                out: torch.Tensor | None = None,
                schedule: torch.Tensor | None = None) -> torch.Tensor:
    """table (S, D) fp32 or bf16, idx (K,) int32 in [0, S) -> (K, D).

    ``out``: a contiguous (K, D) tensor of the table's dtype and device to
    write into (16-byte aligned on the card), else a new one.
    ``schedule``: an (n, 2) int32 tensor of ranges of output rows (first
    row, rows) that cover each row once, in the order the kernel should
    take them (``edge_partition.halo_schedule``); else the rows in order.
    It orders the work only, never changes the result, and is not checked
    on the device: its maker answers for it, as for the indices."""
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("gather_rows is forward-only")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("table must be (S, D) and idx (K,)")
    if table.dtype not in _ELEM_BYTES:
        raise TypeError(f"table dtype {table.dtype} not supported: fp32 or bf16")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if table.device != idx.device:
        raise ValueError("table and idx on different devices")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if schedule is not None and not (
            schedule.dim() == 2 and schedule.shape[1] == 2
            and schedule.dtype == torch.int32 and schedule.is_contiguous()
            and schedule.device == idx.device and schedule.shape[0] > 0):
        raise ValueError("schedule must be a contiguous non-empty (n, 2) "
                         "int32 tensor on idx's device")
    k = idx.shape[0]
    if out is not None:
        check_out(out, (k, table.shape[1]), table, "gather_rows")
    if table.device.type == "cpu":
        ref = gather_rows_plain(table, idx)
        return ref if out is None else out.copy_(ref)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {table.device}")
    if out is None:
        out = torch.empty((k, table.shape[1]), dtype=table.dtype,
                          device=table.device)
    if out.numel() == 0:
        return out
    rc = launch_on(table.device, _lib(), idx.data_ptr(), table.data_ptr(),
                   out.data_ptr(), k, table.shape[1],
                   _ELEM_BYTES[table.dtype],
                   None if schedule is None else schedule.data_ptr(),
                   0 if schedule is None else schedule.shape[0])
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    count_launch(gather_rows)
    return out


gather_rows.launches = 0   # kernel launches since the last reset
