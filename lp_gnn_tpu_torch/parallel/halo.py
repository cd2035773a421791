"""The halo all-to-all (K1): each shard's boundary block to its peer.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py:572 _halo_a2a`` and
of the TPU kernel it selects, ``lp_gnn_tpu/parallel/pallas_halo.py:69
pallas_all_to_all`` (``_a2a_kernel`` :39): K per-shard halo buffers of
(K*Bh, F) rows in, K out, with ``out[q][p*Bh:(p+1)*Bh] =
in[p][q*Bh:(q+1)*Bh]``, the tiled ``lax.all_to_all`` over the ``edge`` axis.

On CUDA tensors :func:`halo_all_to_all` launches ``ops/csrc/halo_a2a.cu``
(one launch for all K*K blocks) or raises; on CPU tensors it runs
:func:`halo_all_to_all_plain`. :class:`HaloAllToAll` gives the stacked form
a gradient: the exchange is its own transpose. There is no switch between
transports: on the card this kernel is the only one. It takes the K buffers stacked in one
(K, K*Bh, F) tensor, as the reduce direction of the edge-partitioned
forward holds them, or as a list of K tensors. The gather direction runs
no all-to-all on one card: there the exchange is a fixed permutation of
rows, folded into the gather's index (``edge_partition.halo_gather``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ops import _build
from ..ops._build import launch_on

MAX_SHARDS = 64   # the kernel's pointer table (csrc/halo_a2a.cu)
_DTYPES = (torch.float32, torch.bfloat16)
# the K buffers of one exchange: one stacked (K, K*Bh, F) tensor, or K tensors
Halo = torch.Tensor | Sequence[torch.Tensor]


def halo_all_to_all_plain(bufs: Halo) -> Halo:
    """Plain PyTorch version: K*K block copies, in the form given (a list of
    K buffers, or one stacked (K, K*Bh, F) tensor)."""
    k = len(bufs)
    bh = bufs[0].shape[0] // k
    if isinstance(bufs, torch.Tensor):
        outs = torch.empty_like(bufs)
    else:
        outs = [torch.empty_like(b) for b in bufs]
    for q in range(k):
        for p in range(k):
            outs[q][p * bh:(p + 1) * bh] = bufs[p][q * bh:(q + 1) * bh]
    return outs


def _lib():
    fn = _build.load("halo_a2a").lp_halo_a2a
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_stacked():
    fn = _build.load("halo_a2a").lp_halo_a2a_stacked
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_common(k, shape, dtype, contiguous, grad):
    if len(shape) != 2:
        raise ValueError(f"halo buffers must be 2-D (K*Bh, F), got {tuple(shape)}")
    if shape[0] % k:
        raise ValueError(f"{shape[0]} rows do not split into {k} equal blocks")
    if dtype not in _DTYPES:
        raise TypeError(f"halo buffers must all be fp32 or all bf16, got {dtype}")
    if not contiguous:
        raise ValueError("halo buffers must be contiguous")
    if grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "halo_all_to_all is forward-only: HaloAllToAll.apply gives the "
            "stacked form its backward (the same exchange). Run under "
            "torch.no_grad().")


def _check(bufs: Sequence[torch.Tensor]) -> None:
    if not bufs:
        raise ValueError("halo_all_to_all needs one buffer per shard")
    b0 = bufs[0]
    dev, shape, dtype = b0.device, b0.shape, b0.dtype
    if any(b.device != dev for b in bufs):
        devs = {b.device for b in bufs}
        raise NotImplementedError(
            f"halo buffers on distinct devices {sorted(map(str, devs))}: the "
            "exchange between cards (NVLink peer copies, NCCL) is not ported "
            "yet (ROADMAP.md, queue item 7c: edge shards on several "
            "devices)")
    if any(b.shape != shape for b in bufs):
        raise ValueError("halo buffers of one exchange must share one shape, got "
                         f"{sorted({tuple(b.shape) for b in bufs})}")
    if any(b.dtype != dtype for b in bufs):
        raise TypeError("halo buffers must all be fp32 or all bf16, got "
                        f"{sorted({str(b.dtype) for b in bufs})}")
    _check_common(len(bufs), shape, dtype,
                  all(b.is_contiguous() for b in bufs),
                  any(b.requires_grad for b in bufs))


def _launch(dev, k, block_bytes, src_aligned, fn, *args) -> None:
    if k > MAX_SHARDS:
        raise ValueError(f"halo_all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards, got {k}")
    if block_bytes % 16 or not src_aligned:
        raise ValueError(
            "halo_all_to_all kernel needs 16-byte aligned buffers and blocks "
            f"of a multiple of 16 bytes, got {block_bytes}-byte blocks")
    rc = launch_on(dev, fn, *args)
    if rc != 0:
        raise RuntimeError(f"halo_all_to_all kernel launch failed: CUDA error {rc}")
    halo_all_to_all.launches += 1


def halo_all_to_all(bufs: Halo) -> Halo:
    """``out[q][p*Bh:(p+1)*Bh] = bufs[p][q*Bh:(q+1)*Bh]`` over K halo buffers
    of (K*Bh, F) rows, fp32 or bf16, on one device.

    Two forms, one kernel. Stacked: ``bufs`` is one contiguous (K, K*Bh, F)
    tensor and the result is another; the checks look at that one tensor
    and the kernel builds its pointer table itself. List: ``bufs`` is K
    buffers and the result K views of one new (K, K*Bh, F) tensor. On the
    card K is at most 64, every buffer 16-byte aligned and a block (Bh*F
    elements) a multiple of 16 bytes; the wrapper raises otherwise."""
    stacked = isinstance(bufs, torch.Tensor)
    if stacked:
        if bufs.dim() != 3:
            raise ValueError("a stacked halo exchange takes one (K, K*Bh, F) "
                             f"tensor, got shape {tuple(bufs.shape)}")
        k = bufs.shape[0]
        _check_common(k, bufs.shape[1:], bufs.dtype, bufs.is_contiguous(),
                      bufs.requires_grad)
        b0 = bufs
    else:
        _check(bufs)
        k, b0 = len(bufs), bufs[0]
    dev = b0.device
    if dev.type == "cpu":
        return halo_all_to_all_plain(bufs)
    if dev.type != "cuda":
        raise ValueError(f"halo_all_to_all runs on cuda or cpu, not {dev}")
    rows, f = b0.shape[-2:]
    out = torch.empty((k, rows, f), dtype=b0.dtype, device=dev)
    buf_bytes = rows * f * b0.element_size()
    block_bytes = buf_bytes // k
    if block_bytes:
        if stacked:
            _launch(dev, k, block_bytes, bufs.data_ptr() % 16 == 0,
                    _lib_stacked(), bufs.data_ptr(), out.data_ptr(), k,
                    buf_bytes, block_bytes)
        else:
            src = [b.data_ptr() for b in bufs]
            table = ctypes.c_void_p * k
            base = out.data_ptr()
            _launch(dev, k, block_bytes, not any(a % 16 for a in src), _lib(),
                    table(*src),
                    table(*range(base, base + k * buf_bytes, buf_bytes)), k,
                    block_bytes)
    return out if stacked else list(out.unbind(0))


halo_all_to_all.launches = 0   # kernel launches since the last reset


class HaloAllToAll(torch.autograd.Function):
    """``HaloAllToAll.apply(bufs)``: :func:`halo_all_to_all` of one stacked
    (K, K*Bh, F) tensor with a gradient. The exchange maps block (p -> q)
    to (q -> p), so it is its own transpose: the backward is one more
    stacked launch, on the gradient."""

    @staticmethod
    def forward(ctx, bufs):
        return halo_all_to_all(bufs)

    @staticmethod
    def backward(ctx, grad):
        return halo_all_to_all(grad.contiguous())
