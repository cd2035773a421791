"""Sparse bipartite aggregation: the CSR SpMM and its two directions.

Counterpart of ``lp_gnn_tpu/ops/spmm.py`` (``segment_spmm`` :34 and its
VJP :61, ``blocked_spmm`` :77 and its VJP :172, ``spmm_cons_to_vars`` :203,
``spmm_vars_to_cons`` :216, ``bidir_spmm`` :226, ``attach_input_agg``
:231, ``sddmm`` :289). One kernel serves both directions:
``out[d] = sum over e in [ptr[d], ptr[d+1]) of val[e] * x[idx[e]]``, run
over the CSR (vars -> cons) or the CSC (cons -> vars) of
:class:`~lp_gnn_tpu_torch.data.graph.GraphTensors`.

On a CUDA tensor :func:`spmm_csr` launches the hand-written kernel
(``csrc/spmm.cu``) or raises; on a CPU tensor it runs the plain version,
:func:`spmm_csr_plain`. The kernel takes any width D, as ``blocked_spmm``
does (:func:`width_plan`): one launch up to 256 16-byte pieces a row,
column slabs of 256 pieces above, and a width of no whole number of pieces
through a copy padded to whole pieces. :func:`spmm_csr` itself is forward-only;
:class:`SpmmCSR` makes it differentiable in ``x``: its backward is the same
kernel over the other ordering of the same edges (the transpose), so no
atomics are needed and the gradient is deterministic. The two directions
go through :class:`SpmmCSR`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from ._build import check_out, count_launch, launch_with_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_PIECES = 256   # 16-byte pieces a launch sums (csrc/spmm.cu kMaxPieces)


@dataclasses.dataclass(frozen=True)
class WidthPlan:
    """How the kernel sums rows of ``width`` elements of ``itemsize``
    bytes: over rows of ``padded`` elements (the width rounded up to whole
    16-byte pieces; a wider copy of x and a wider output where they
    differ), in column ``slabs`` of (first column, columns), one launch
    each, every slab at most MAX_PIECES pieces and starting on a whole
    number of slabs (a multiple of 4096 bytes into the row)."""
    width: int
    itemsize: int
    padded: int
    slabs: tuple[tuple[int, int], ...]

    @property
    def copies(self) -> bool:
        """Whether x and the output go through padded copies."""
        return self.padded != self.width


def width_plan(width: int, itemsize: int) -> WidthPlan:
    """The kernel's plan for rows of ``width`` elements (>= 1) of
    ``itemsize`` bytes (4: fp32, 2: bf16)."""
    vec = 16 // itemsize
    padded = -(-width // vec) * vec
    step = MAX_PIECES * vec
    return WidthPlan(width, itemsize, padded, tuple(
        (c, min(step, padded - c)) for c in range(0, padded, step)))


def segment_ids(ptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The destination of each edge of a CSR: d repeated ptr[d+1] - ptr[d]
    times."""
    return torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, device=ptr.device),
        (ptr[1:] - ptr[:-1]).long(), output_size=n_edges)


def spmm_csr_plain(ptr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a sorted segment sum by ``index_add_`` with
    fp32 accumulation (fp64 for fp64 x, a dtype the kernel does not take),
    cast to ``x``'s dtype."""
    num_dst = ptr.shape[0] - 1
    acc = torch.promote_types(x.dtype, torch.float32)
    dst = segment_ids(ptr, idx.shape[0])
    msg = x.index_select(0, idx.long()).to(acc) * val[:, None]
    out = torch.zeros(num_dst, x.shape[1], dtype=acc, device=x.device)
    return out.index_add_(0, dst, msg).to(x.dtype)


def _lib():
    fn = _build.load("spmm").lp_spmm_csr
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
            [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int] + [ctypes.c_void_p, ctypes.c_longlong] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(ptr, idx, val, x):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (S, D), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported: fp32 or bf16")
    if ptr.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("ptr and idx must be int32")
    if val.dtype != torch.float32:
        raise TypeError("val must be float32")
    if ptr.dim() != 1 or idx.dim() != 1 or val.shape != idx.shape:
        raise ValueError("ptr (num_dst+1,), idx and val (E,) must be 1-D "
                         "with idx and val of one length")
    if ptr.shape[0] < 1:
        raise ValueError("ptr must hold num_dst+1 >= 1 entries")
    dev = x.device
    if not ptr.device == idx.device == val.device == dev:
        devs = {t.device for t in (ptr, idx, val, x)}
        raise ValueError(f"tensors on different devices: {devs}")
    if not (ptr.is_contiguous() and idx.is_contiguous()
            and val.is_contiguous() and x.is_contiguous()):
        raise ValueError("ptr, idx, val and x must be contiguous")
    return dev


def spmm_csr(ptr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``out[d] = sum_{e in [ptr[d], ptr[d+1])} val[e] * x[idx[e]]``.

    ptr (num_dst+1,) int32, idx (E,) int32 with values in [0, S), val (E,)
    fp32, x (S, D) fp32 or bf16. Returns (num_dst, D) in x's dtype, summed
    in fp32: ``out`` if given (a contiguous (num_dst, D) tensor of x's
    dtype and device, 16-byte aligned on the card), else a new tensor.
    Indices are not checked on the device: ``GraphTensors`` checks them on
    the host when it builds the graph. On the card any D >= 1 runs
    (:func:`width_plan`): up to 1024 (fp32) or 2048 (bf16) in one launch,
    wider in one launch a 256-piece column slab of the same tensors; a D
    that is no multiple of 4 (fp32) or 8 (bf16) goes through a copy of x
    padded to whole 16-byte pieces and a padded output, whose first D
    columns are copied into ``out``; an x that is not 16-byte aligned is
    copied.
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "spmm_csr is forward-only: SpmmCSR.apply gives it a backward, the "
            "same kernel over the transpose ordering (spmm_vars_to_cons, "
            "spmm_cons_to_vars and the edge-partitioned convs go through "
            "it). Run under torch.no_grad().")
    dev = _check(ptr, idx, val, x)
    num_dst, d = ptr.shape[0] - 1, x.shape[1]
    if out is not None:
        check_out(out, (num_dst, d), x, "spmm_csr")
    if dev.type == "cpu":
        ref = spmm_csr_plain(ptr, idx, val, x)
        return ref if out is None else out.copy_(ref)
    if dev.type != "cuda":
        raise ValueError(f"spmm_csr runs on cuda or cpu, not {dev}")
    if out is None:
        out = torch.empty((num_dst, d), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    b = x.element_size()
    plan = width_plan(d, b)
    if plan.copies:
        x = torch.nn.functional.pad(x, (0, plan.padded - d))
    elif x.data_ptr() % 16:
        x = x.clone()
    dst = torch.empty((num_dst, plan.padded), dtype=x.dtype, device=dev) \
        if plan.copies else out
    for col, cols in plan.slabs:
        rc = launch_with_workspace(
            "spmm", dev, _lib(), ptr.data_ptr(), idx.data_ptr(),
            val.data_ptr(), x.data_ptr() + col * b, dst.data_ptr() + col * b,
            num_dst, x.shape[0], idx.shape[0], cols, plan.padded,
            plan.padded, _DTYPE_CODE[x.dtype], buffers=2)
        if rc != 0:
            raise RuntimeError(
                f"spmm_csr kernel launch failed: CUDA error {rc}")
        count_launch(spmm_csr)
    if plan.copies:
        out.copy_(dst[:, :d])
    return out


spmm_csr.launches = 0   # kernel launches since the last reset (one a slab)


class SpmmCSR(torch.autograd.Function):
    """:func:`spmm_csr` with a gradient for ``x``:
    ``SpmmCSR.apply(ptr, idx, val, x, t_ptr, t_idx, t_val)``, where
    ``t_*`` are the same edges ordered by source (the transpose). The
    backward is ``dx = spmm_csr(t_ptr, t_idx, t_val, grad_out)``, one launch
    of the same kernel in x's dtype with fp32 sums; ``val`` and the indices
    get no gradient (``None``, as the JAX VJPs return)."""

    @staticmethod
    def forward(ctx, ptr, idx, val, x, t_ptr, t_idx, t_val):
        ctx.transpose = (t_ptr, t_idx, t_val)
        return spmm_csr(ptr, idx, val, x)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[3]:
            return (None,) * 7
        # spmm_csr takes contiguous rows (and copies a misaligned one)
        dx = spmm_csr(*ctx.transpose, grad_out.contiguous())
        return None, None, None, dx, None, None, None


def spmm_cons_to_vars(g, x_cons: torch.Tensor) -> torch.Tensor:
    """``out[j] = sum_i A_ij * x_cons[i]`` -- (n, D), over the CSC; its
    backward runs over the CSR."""
    return SpmmCSR.apply(g.colptr, g.row, g.val_c, x_cons,
                         g.rowptr, g.col, g.val_r)


def spmm_vars_to_cons(g, x_vars: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j A_ij * x_vars[j]`` -- (m, D), over the CSR; its
    backward runs over the CSC."""
    return SpmmCSR.apply(g.rowptr, g.col, g.val_r, x_vars,
                         g.colptr, g.row, g.val_c)


def bidir_spmm(g, x_cons: torch.Tensor, x_vars: torch.Tensor):
    """Both directions of the two-tower aggregation in one call."""
    return spmm_vars_to_cons(g, x_vars), spmm_cons_to_vars(g, x_cons)


def attach_input_agg(g, dtype: torch.dtype):
    """``g`` with the input conv's two aggregations, ``in_agg_c = A
    v_feas`` (m, q) and ``in_agg_v = A^T c_feas`` (n, p), computed once in
    the model's compute ``dtype`` (ops/spmm.py:231). The raw features are
    constants of the graph and the kernel is deterministic, so the result is
    bit-identical to what conv1 computes, and every later step and
    inference skips those two launches."""
    with torch.no_grad():
        agg_v = spmm_cons_to_vars(g, g.c_feas.to(dtype))
        agg_c = spmm_vars_to_cons(g, g.v_feas.to(dtype))
    return dataclasses.replace(g, in_agg_c=agg_c, in_agg_v=agg_v)


def sddmm(row: torch.Tensor, col: torch.Tensor, x_cons: torch.Tensor,
          x_vars: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: each edge's ``<x_cons[row],
    x_vars[col]>``, (E,) (counterpart of ``lp_gnn_tpu/ops/spmm.py:289
    sddmm``, the gradient of an SpMM's edge values: ``dval = sddmm(row,
    col, grad_out, x_src)``). Plain PyTorch on any device: no model and no
    path of either package calls it, so it has no kernel of its own yet
    (ROADMAP.md §2 item 6: with the first model that learns edge values)."""
    return (x_cons[row.long()] * x_vars[col.long()]).sum(-1)
