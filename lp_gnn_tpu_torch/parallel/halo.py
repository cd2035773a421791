"""The halo all-to-all (K1): each shard's boundary block to its peer.

Counterpart of ``lp_gnn_tpu/parallel/edge_partition.py:572 _halo_a2a`` and
of the TPU kernel it selects, ``lp_gnn_tpu/parallel/pallas_halo.py:69
pallas_all_to_all`` (``_a2a_kernel`` :39): K per-shard halo buffers of
(K*Bh, F) rows in, K out, with ``out[q][p*Bh:(p+1)*Bh] =
in[p][q*Bh:(q+1)*Bh]``, the tiled ``lax.all_to_all`` over the ``edge`` axis.

Three transports, one kernel source (``ops/csrc/halo_a2a.cu``); the edge
mesh says which runs, there is no switch and no fallback between them:

- All K shards in one process, on one device: :func:`halo_all_to_all`
  moves all K*K blocks in one launch, or raises, on CUDA tensors; on CPU
  tensors it runs :func:`halo_all_to_all_plain`. It takes the K buffers
  stacked in one (K, K*Bh, F) tensor, as the reduce direction of the
  edge-partitioned forward holds them, or as a list of K tensors.
  :class:`HaloAllToAll` gives the stacked form a gradient: the exchange is
  its own transpose. The gather direction runs no all-to-all there: the
  exchange is a fixed permutation of rows, folded into the gather's index
  (``edge_partition.halo_gather``).
- One shard a process, rank k of a process group holding shard k:
  :func:`halo_all_to_all_ranks`. The group's route comes from the ranks'
  placement (``mesh.Placement``, swapped before the group existed) before
  any exchange, the same on every rank (``mesh.rank_form``), never after a
  failure. A group whose ranks span hosts takes COLLECTIVE, the port's
  counterpart of JAX's default ``lax.all_to_all`` over DCN
  (``_halo_a2a`` :572-581; the Pallas kernel's remote DMA does not cross
  hosts): one ``all_to_all_single`` on the card over NCCL, staged through
  host copies over gloo; it makes no window and launches no kernel of
  this repo. A group on one host launches the rank form on CUDA tensors,
  the TPU kernel's remote copy: each rank writes its K blocks straight
  into the ranks' receive windows, cudaMalloc'ed by each rank and mapped
  into the others through CUDA IPC (the same stores reach a window on
  this card or on a peer card over NVLink), two windows a group and
  device, used in turn and grown together to the largest exchange, so
  that a rank may write exchange e while a slower one still reads e - 1.
  Where no card of the world is time-shared it takes the signalled form:
  one kernel an exchange (:func:`halo_rank_signalled`) whose signals are
  counters in the windows' own allocations, over NVLink, and whose
  copy-out of a peer's block runs as soon as that block is whole. Ranks
  that time-share a card take the flags form, where no kernel spins: a
  write and a copy-out kernel, and the TPU kernel's semaphores as flag
  words in a header of each rank, a page of host memory that the ranks
  share, waited on and written by the ranks' streams (CUDA stream memory
  operations). Either way an exchange makes no host collective and no
  synchronise, and a host that must end a wait stores into the header: an
  error aborts the exchange on every rank through it, and a watchdog
  thread bounds how long a rank that died leaves the others waiting. On
  CPU tensors every route runs :func:`halo_all_to_all_ranks_plain`,
  ``all_to_all_single`` over the group (gloo). :class:`HaloAllToAllRanks`
  gives it a gradient, the same exchange. Under a (dp, edge) grid of ranks
  (``mesh.RankGrid``) each row's edge group takes its own route and, on
  one host, exchanges over windows of its own: a rank belongs to one row,
  and its windows are keyed by that group.
- Every shard in one process, shard d on device d (``mesh.EdgeMesh`` with
  one shard a device; the devices may repeat):
  :func:`halo_all_to_all_devices`, the device form: each source's launch,
  on its own device and stream, writes its K blocks straight into the K
  destination buffers through peer pointers, its remote destinations
  staggered in the TPU kernel's order and its grid sized for the streams
  that launch at once on its card, the K launches and the events that
  order them between the shards' streams enqueued by one host call. The
  list form over buffers on distinct devices takes it. Across cards it
  needs peer access between every pair (:func:`enable_peer_access`), and
  raises where the cards have none: there is no route through host
  copies. On CPU tensors it runs :func:`halo_all_to_all_plain`. The
  edge-partitioned path gives it a gradient in its joint nodes
  (``edge_partition``), where the exchange of the cotangent is the same
  call.
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
import datetime
import logging
import mmap
import sys
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Sequence

import torch
import torch.distributed as dist

from ..ops import _build
from ..ops._build import count_launch, launch_on
from .mesh import COLLECTIVE, FLAGS, SIGNALLED, group_route

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
    shape, dtype = b0.shape, b0.dtype
    if any(b.shape != shape for b in bufs):
        raise ValueError("halo buffers of one exchange must share one shape, got "
                         f"{sorted({tuple(b.shape) for b in bufs})}")
    if any(b.dtype != dtype for b in bufs):
        raise TypeError("halo buffers must all be fp32 or all bf16, got "
                        f"{sorted({str(b.dtype) for b in bufs})}")
    _check_common(len(bufs), shape, dtype,
                  all(b.is_contiguous() for b in bufs),
                  any(b.requires_grad for b in bufs))


def _check_launch(k, block_bytes, src_aligned) -> None:
    if k > MAX_SHARDS:
        raise ValueError(f"halo_all_to_all kernel takes at most {MAX_SHARDS} "
                         f"shards, got {k}")
    if block_bytes % 16 or not src_aligned:
        raise ValueError(
            "halo_all_to_all kernel needs 16-byte aligned buffers and blocks "
            f"of a multiple of 16 bytes, got {block_bytes}-byte blocks")


def _launch(dev, k, block_bytes, src_aligned, fn, *args) -> None:
    _check_launch(k, block_bytes, src_aligned)
    rc = launch_on(dev, fn, *args)
    if rc != 0:
        raise RuntimeError(f"halo_all_to_all kernel launch failed: CUDA error {rc}")
    count_launch(halo_all_to_all)


def halo_all_to_all(bufs: Halo) -> Halo:
    """``out[q][p*Bh:(p+1)*Bh] = bufs[p][q*Bh:(q+1)*Bh]`` over K halo buffers
    of (K*Bh, F) rows, fp32 or bf16, on one device.

    Two forms, one kernel. Stacked: ``bufs`` is one contiguous (K, K*Bh, F)
    tensor and the result is another; the checks look at that one tensor
    and the kernel builds its pointer table itself. List: ``bufs`` is K
    buffers and the result K views of one new (K, K*Bh, F) tensor; K
    buffers on distinct devices take the device form,
    :func:`halo_all_to_all_devices`. On the card K is at most 64, every
    buffer 16-byte aligned and a block (Bh*F elements) a multiple of 16
    bytes; the wrapper raises otherwise."""
    stacked = isinstance(bufs, torch.Tensor)
    if not stacked and bufs and len({b.device for b in bufs}) > 1:
        return halo_all_to_all_devices(bufs)
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


# ---------------------------------------------------------- the device form
# the ordered (device, peer) index pairs whose peer access this process
# turned on (or found on) for the device form
PEER_PAIRS: set[tuple[int, int]] = set()


def enable_peer_access(indices) -> list[tuple[int, int]]:
    """Peer access for every ordered pair of the distinct CUDA device
    ``indices`` (``lp_halo_peer_enable``), once a pair and process: kernels
    on one card may then store into the other's memory. Raises naming a
    pair whose cards cannot reach each other (``cudaDeviceCanAccessPeer``):
    the device form has no route through host copies. Returns the pairs
    this call turned on."""
    fn = _build.load("halo_a2a").lp_halo_peer_enable
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    new = []
    for a in indices:
        for b in indices:
            if a == b or (a, b) in PEER_PAIRS:
                continue
            rc = fn(a, b)
            if rc == -1:
                raise RuntimeError(
                    f"halo_all_to_all_devices: cuda:{a} cannot access the "
                    f"memory of cuda:{b} (cudaDeviceCanAccessPeer): the "
                    "device form writes its blocks through peer pointers "
                    "and has no route through the host")
            if rc != 0:
                raise RuntimeError(f"halo_all_to_all_devices: peer access "
                                   f"cuda:{a} -> cuda:{b} failed: CUDA "
                                   f"error {rc}")
            PEER_PAIRS.add((a, b))
            new.append((a, b))
    return new


def device_orders(k: int) -> list[list[int]]:
    """Each source's destinations in the order its launch takes them: the
    TPU kernel's remote copies (``pallas_halo.py:48-52``: at offset s =
    1, ..., K-1, device me sends to (me + s) mod K), then its own block
    (the TPU kernel's local copy, no link), last."""
    return [[(me + s) % k for s in range(1, k)] + [me] for me in range(k)]


def device_shares(indices: Sequence[int],
                  streams: Sequence | None = None) -> list[int]:
    """For each source (its device index, and its stream where given), the
    streams that launch at once on its card: its launch takes one wave of
    CTAs over that many, so that the K launches of one card on K streams
    fill one wave together, and a source with a card (or the K sources
    with one stream, one launch after another) of its own takes a whole
    wave."""
    streams = list(range(len(indices))) if streams is None else list(streams)
    on = {}
    for d, s in zip(indices, streams):
        on.setdefault(d, set()).add(s)
    return [len(on[d]) for d in indices]


class _DevicePlan:
    """The device form's plan for one (devices, streams): the C plan
    (shares, destination orders, the exchange's events; made once, peer
    access turned on first), the stream handles, and a lock, since an
    exchange reuses the plan's events."""

    def __init__(self, indices: list[int], streams: list):
        k = len(indices)
        enable_peer_access(sorted(set(indices)))
        ints = ctypes.c_int * k
        order = [q for row in device_orders(k) for q in row]
        handle = ctypes.c_void_p()
        handles = [s.cuda_stream for s in streams]
        rc = _rank_lib("lp_halo_devices_plan")(
            k, ints(*indices), ints(*device_shares(indices, handles)),
            (ctypes.c_int * (k * k))(*order), ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError("halo_all_to_all_devices: its plan (events "
                               f"on {indices}) failed: CUDA error {rc}")
        self.k, self.handle = k, handle.value
        self.streams = (ctypes.c_void_p * k)(*handles)
        self.lock = threading.Lock()
        self.timed = False


# (device indices, stream handles) -> its _DevicePlan, made at its first
# exchange and kept for the process's life (a few per run)
_DEVICE_PLANS: dict[tuple, _DevicePlan] = {}
_PLAN_LOCK = threading.Lock()
# whether the device form's exchanges record CUDA events around each
# source's launch (device_form_times reads the last exchange's)
DEVICE_TIMING = False


def _device_plan(devs, streams) -> _DevicePlan:
    key = (tuple(d.index for d in devs), tuple(s.cuda_stream for s in streams))
    plan = _DEVICE_PLANS.get(key)
    if plan is None:
        with _PLAN_LOCK:
            plan = _DEVICE_PLANS.get(key)
            if plan is None:
                plan = _DEVICE_PLANS[key] = _DevicePlan(list(key[0]),
                                                        list(streams))
    return plan


def device_form_times(bufs: Sequence[torch.Tensor], streams=None) -> dict:
    """The device times of the last exchange over ``bufs``' devices and
    ``streams`` made while DEVICE_TIMING was on (it waits for it): each
    source's launch (ms, CUDA events on its own stream around it), their
    sum, and the span from the first start to the last end (None where the
    sources lie on distinct cards, whose events share no clock)."""
    devs = [b.device for b in bufs]
    streams = [torch.cuda.current_stream(d) for d in devs] \
        if streams is None else list(streams)
    plan = _device_plan(devs, streams)
    if not plan.timed:
        raise RuntimeError("device_form_times: no timed exchange on these "
                           "devices and streams (set DEVICE_TIMING)")
    ms = (ctypes.c_float * (plan.k + 1))()
    fn = _rank_lib("lp_halo_devices_times")
    with plan.lock:
        rc = fn(plan.handle, ms)
    if rc != 0:
        raise RuntimeError(f"device_form_times: CUDA error {rc}")
    per = [float(v) for v in ms[:plan.k]]
    return {"per_source_ms": per, "sum_ms": sum(per),
            "span_ms": float(ms[plan.k]) if ms[plan.k] >= 0 else None}


def halo_all_to_all_devices(bufs: Sequence[torch.Tensor],
                            streams=None) -> list[torch.Tensor]:
    """K1's device form: K (K*Bh, F) buffers, buffer d on shard d's device
    (the devices may repeat), in; K new buffers, each on its buffer's
    device, out, with ``out[q][p*Bh:(p+1)*Bh] = bufs[p][q*Bh:(q+1)*Bh]``.
    fp32 or bf16.

    On CUDA tensors one launch a source (``lp_halo_devices_exchange``: the
    kernel over source d's K block pairs, its remote destinations in the
    TPU kernel's order, :func:`device_orders`, its grid one wave over the
    streams launching on its card, :func:`device_shares`), on
    ``streams[d]`` (the current stream of each buffer's device if None;
    buffer d must be ready there), counted in
    ``halo_all_to_all_devices.launches``, all K enqueued by one host call.
    Out q is made on ``streams[q]``; every writer's stream first waits for
    an event each other destination's stream records after its buffer was
    made, and each destination's stream then waits for every writer's
    event, so work queued after the call on ``streams[q]`` reads out q
    complete. That wait also keeps out q's
    memory safe: the caching allocator hands it out again only to work on
    ``streams[q]``, queued after the wait, so no output is recorded on the
    writers' streams; each input is recorded on its reader's stream.
    Buffers on distinct cards need peer access between them, turned on
    with the plan (:func:`enable_peer_access`). On CPU tensors it runs
    :func:`halo_all_to_all_plain`."""
    _check(bufs)
    k = len(bufs)
    devs = [b.device for b in bufs]
    if all(d.type == "cpu" for d in devs):
        return halo_all_to_all_plain(list(bufs))
    if any(d.type != "cuda" for d in devs):
        raise ValueError("halo_all_to_all_devices runs on cuda or cpu "
                         f"buffers, not {sorted({str(d) for d in devs})}")
    streams = [torch.cuda.current_stream(d) for d in devs] \
        if streams is None else list(streams)
    if len(streams) != k or any(s.device != d for s, d in zip(streams, devs)):
        raise ValueError("halo_all_to_all_devices takes one stream a buffer, "
                         "on the buffer's device")
    outs = []
    for s, b in zip(streams, bufs):
        with torch.cuda.stream(s):
            outs.append(torch.empty_like(b))
    block_bytes = bufs[0].nbytes // k
    if not block_bytes:
        return outs
    _check_launch(k, block_bytes, not any(
        t.data_ptr() % 16 for t in (*bufs, *outs)))
    plan = _device_plan(devs, streams)
    for s, b in zip(streams, bufs):
        b.record_stream(s)
    ptrs = ctypes.c_void_p * k
    with plan.lock:
        plan.timed = DEVICE_TIMING
        rc = _rank_lib("lp_halo_devices_exchange")(
            plan.handle, ptrs(*(b.data_ptr() for b in bufs)),
            ptrs(*(o.data_ptr() for o in outs)), plan.streams, block_bytes,
            int(DEVICE_TIMING))
    if rc != 0:
        raise RuntimeError(f"halo_all_to_all_devices: the exchange over "
                           f"{[str(d) for d in devs]} failed: CUDA error {rc}")
    count_launch(halo_all_to_all_devices, k)
    return outs


# the device form's launches since the last reset: K an exchange
halo_all_to_all_devices.launches = 0


# ------------------------------------------------------------ the rank form
def _group_shape(group) -> tuple[int, int]:
    """(K, me): the group's size and this process's rank in it."""
    if not dist.is_initialized():
        raise RuntimeError("halo_all_to_all_ranks needs a process group "
                           "(parallel/mesh.py init_distributed)")
    return dist.get_world_size(group), dist.get_rank(group)


def halo_all_to_all_ranks_plain(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Plain version of the rank form, on CPU tensors over gloo:
    ``all_to_all_single`` of this rank's (K*Bh, F) buffer, whose block p
    goes to rank p, into a new buffer whose block p comes from rank p."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf.contiguous(), group=group)
    return out


def _rank_lib(name: str):
    lib = _build.load("halo_a2a")
    fn = getattr(lib, name)
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        i32, i64, u64 = ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        fn.argtypes = {
            "lp_halo_a2a_rank": [vp, pp, i32, i32, i64, vp],
            "lp_halo_pairs": [pp, pp, i32, i32, i64, i32, vp],
            "lp_halo_devices_plan": [i32, ctypes.POINTER(i32),
                                     ctypes.POINTER(i32),
                                     ctypes.POINTER(i32), pp],
            "lp_halo_devices_exchange": [vp, pp, pp, pp, i64, i32],
            "lp_halo_devices_times": [vp, ctypes.POINTER(ctypes.c_float)],
            "lp_halo_copy_out": [vp, vp, i64, vp, i32, vp, vp],
            "lp_halo_rank_signalled": [vp, vp, pp, i64, i32, i32, i32, i64,
                                       vp, vp, u64, u64, i32, vp],
            "lp_halo_flags_wait": [pp, i32, u64, vp],
            "lp_halo_flags_write": [pp, i32, u64, vp],
            "lp_halo_flags_register": [vp, i64, pp],
            "lp_halo_flags_unregister": [vp],
            "lp_halo_ipc_handle_bytes": [],
            "lp_halo_window_alloc": [i64, pp, vp],
            "lp_halo_window_open": [vp, pp],
            "lp_halo_window_close": [vp],
            "lp_halo_window_free": [vp],
            "lp_halo_status_alloc": [pp, pp],
            "lp_halo_status_free": [vp]}[name]
        fn.restype = ctypes.c_int
    return fn


# Each rank's flag header (csrc/halo_a2a.cu): a page of POSIX shared
# memory that every rank of the group maps and registers with its card, so
# that a host store ends a wait; for window w of 2, arrival[w][p] then
# done[w][p], MAX_SHARDS 64-bit words each.
FLAG_BYTES = 8
HEADER_BYTES = 2 * 2 * MAX_SHARDS * FLAG_BYTES
HEADER_MAP_BYTES = -(-HEADER_BYTES // mmap.PAGESIZE) * mmap.PAGESIZE
# an abort word: this bit, the rank in bits 32-61, its CUDA error below
# (DEADLINE_CODE: the rank waited past DEADLINE_S; LEFT_CODE: it released
# its windows on an error outside the exchanges). The card's GEQ wait
# compares cyclically, (int64)(word - value) >= 0, so the word must stay
# below 2^63 to count as above every epoch: then it ends every wait on the
# word it lands in.
ABORT = 1 << 62
DEADLINE_CODE = 0xFFFFFFFF
LEFT_CODE = 0xFFFFFFFE
# how long an exchange may stay unfinished on the card: the host waits for
# exchange e - 2 to complete before it enqueues exchange e, and the
# watchdog ends the waits of a copy-out enqueued longer ago (``_watch``).
# It bounds how far a host runs ahead of its card and how long a rank that
# died or stopped leaves the others waiting, a synchronise of theirs too.
DEADLINE_S = 300.0
WATCH_S = 1.0   # how often the watchdog looks
SPIN_S = 0.002  # how long a host with a card a rank polls without a pause
# The signalled form's counters, after the two windows of each rank's
# allocation, in the header's layout: for window w, arrival[w][p] then
# done[w][p], MAX_SHARDS 64-bit words each (csrc/halo_a2a.cu). They count
# chunks of CHUNK_BYTES (the kernel's kChunk pieces of 16 bytes).
COUNTER_BYTES = HEADER_BYTES
CHUNK_BYTES = 16 * 256 * 4
def rank_chunks(block_bytes: int) -> int:
    """The chunks of one block in the signalled form's counters."""
    return -(-block_bytes // CHUNK_BYTES)


def next_targets(sent: list, w: int, block_bytes: int) -> tuple[int, int]:
    """The signalled form's (arrival, done) targets of the next exchange
    over window ``w`` of ``block_bytes`` blocks, where ``sent[w]`` chunks
    a source went into window w so far: done is that sum (exchange e - 2's
    included), arrival that plus this exchange's chunks; ``sent[w]`` moves
    on to arrival. The targets of a window only grow."""
    done = sent[w]
    sent[w] = done + rank_chunks(block_bytes)
    return sent[w], done


def signal_grid(wave: int, share: int, chunks: int) -> int:
    """The signalled kernel's grid (``lp_halo_rank_signalled``): one wave
    of its resident CTAs over ``share``, at most a block's chunks, at least
    one."""
    return max(1, min(wave // share, chunks))


def signal_plan(k: int, me: int, chunks: int, grid: int) -> list[list]:
    """The signalled kernel's steps for rank ``me`` of ``k``
    (``halo_rank_signalled_kernel``, in Python): CTA b of ``grid`` takes
    chunks b, b + grid, ... of every block. Returns, for each CTA, its
    operations in order: ("store", q, chunks) into destination q's window,
    published into q's arrival counter; ("own", chunks) of the own block;
    ("copy", p, chunks) of source p's slot after its arrival counter reads
    whole, published into p's done counter. At step s = 1, ..., K-1 it
    stores to (me + s) mod K, then copies what step s - 1 brought (after
    step 1 its own block); last, the slot of step K-1's source."""
    plan = []
    for b in range(grid):
        mine = list(range(b, chunks, grid))
        ops = []
        if mine:
            for s in range(1, k):
                ops.append(("store", (me + s) % k, mine))
                ops.append(("own", mine) if s == 1 else
                           ("copy", (me - s + 1) % k, mine))
            ops.append(("own", mine) if k == 1 else
                       ("copy", (me + 1) % k, mine))
        plan.append(ops)
    return plan


def _arrival(base: int, w: int, p: int) -> int:
    return base + (2 * w * MAX_SHARDS + p) * FLAG_BYTES


def _done(base: int, w: int, p: int) -> int:
    return base + ((2 * w + 1) * MAX_SHARDS + p) * FLAG_BYTES


def _words(addrs: list[int]):
    return (ctypes.c_void_p * max(len(addrs), 1))(*addrs)


def _store(addrs: list[int], word: int) -> None:
    """Store ``word`` into each flag at the host addresses ``addrs``."""
    for a in addrs:
        ctypes.c_uint64.from_address(a).value = word


class _Header:
    """A rank's flag header as this process maps it: the shared page
    (made here where ``name`` is None, else opened by its name), its host
    address and, once registered with the card, its device address."""

    def __init__(self, name: str | None = None):
        self.shm = shared_memory.SharedMemory(
            name=name, create=name is None,
            size=HEADER_MAP_BYTES if name is None else 0)
        if name is not None:   # its maker unlinks it, not this process
            resource_tracker.unregister(self.shm._name, "shared_memory")
        self.view = ctypes.c_char.from_buffer(self.shm.buf)
        self.host = ctypes.addressof(self.view)
        self.dev = 0

    def register(self) -> int:
        dev = ctypes.c_void_p()
        rc = _rank_lib("lp_halo_flags_register")(self.host, HEADER_MAP_BYTES,
                                                 ctypes.byref(dev))
        self.dev = dev.value or 0
        return rc

    def close(self) -> None:
        if self.dev:
            _rank_lib("lp_halo_flags_unregister")(self.host)
            self.dev = 0
        del self.view
        self.shm.close()


@dataclasses.dataclass
class _Window:
    """The two receive windows of every rank of a group, ``nbytes`` each,
    as this rank reaches them: ``ptrs[p]`` the base of rank p's allocation
    (window 0, then window 1; ``ptrs[me]`` this rank's own, the others IPC
    mappings), ``tables[w]`` window w's data of every rank as a pointer
    array; ``flags[p]`` rank p's flag header as this rank's card reaches
    it, ``host[p]`` as its host does (``headers`` keeps the mappings,
    ``_Header``s). ``status`` is the host address of the status word
    (pinned, mapped; ``status_dev`` the kernels'), ``epoch`` the count of
    exchanges enqueued over the pair, ``events[w]`` the completion of
    window w's last copy-out, ``enqueued_at`` when the newest was enqueued
    (the host's
    monotonic clock), ``broken`` the error an exchange raised (the pair is
    then dropped and made anew at the next), ``poisoned`` whether the
    watchdog ended its waits. ``form`` is the group's (``mesh.rank_form``);
    ``counter_bytes`` the signalled form's counters after the two windows
    of each allocation (``_make_window`` makes them for either form),
    ``sent[w]`` the chunks each rank has sent into window w so far, the
    base of its counters' targets, and ``bases`` every rank's allocation
    as a pointer array."""
    me: int
    nbytes: int
    ptrs: list[int]
    group: object
    flags: list[int]
    host: list[int]
    status: int = 0
    status_dev: int = 0
    epoch: int = 0
    events: list = dataclasses.field(default_factory=lambda: [None, None])
    enqueued_at: float = 0.0
    broken: str = ""
    poisoned: bool = False
    headers: list = dataclasses.field(default_factory=list)
    form: str = FLAGS
    counter_bytes: int = 0
    sent: list = dataclasses.field(default_factory=lambda: [0, 0])

    @property
    def alloc_bytes(self) -> int:
        """The bytes of this rank's allocation on the card: two windows and
        the counters after them."""
        return 2 * self.nbytes + self.counter_bytes

    def data(self, p: int, w: int) -> int:
        return self.ptrs[p] + w * self.nbytes

    def targets(self, w: int, block_bytes: int) -> tuple[int, int]:
        """The signalled form's counter targets of the next exchange over
        window ``w`` (``next_targets``)."""
        return next_targets(self.sent, w, block_bytes)

    def __post_init__(self):
        k, me = len(self.ptrs), self.me
        peers = [p for p in range(k) if p != me]
        own, own_host = self.flags[me], self.host[me]
        self.bases = (ctypes.c_void_p * k)(*self.ptrs)
        # per window: the data table, the words this rank waits on (its
        # own header) and those it writes (the peers')
        self.tables = [(ctypes.c_void_p * k)(*(self.data(p, w)
                                               for p in range(k)))
                       for w in range(2)]
        self.wait_done = [_words([_done(own, w, p) for p in peers])
                          for w in range(2)]
        self.wait_arrival = [_words([_arrival(own, w, p) for p in peers])
                             for w in range(2)]
        self.signal_arrival = [_words([_arrival(self.flags[p], w, me)
                                       for p in peers]) for w in range(2)]
        self.signal_done = [_words([_done(self.flags[p], w, me)
                                    for p in peers]) for w in range(2)]
        # this rank's abort words in the peers' headers (as the card
        # reaches them, and as the host does), and every word of its own
        # header (as the host does)
        self.abort_words = [a for p in peers for w in range(2) for a in (
            _arrival(self.flags[p], w, me), _done(self.flags[p], w, me))]
        self.abort_host = [a for p in peers for w in range(2) for a in (
            _arrival(self.host[p], w, me), _done(self.host[p], w, me))]
        self.own_host = [a for w in range(2) for p in range(k) for a in (
            _arrival(own_host, w, p), _done(own_host, w, p))]
        self.n_peers = len(peers)


# (group, device index) -> the window pair of the group's ranks on that
# device. Every exchange of up to its bytes uses it (from the start of a
# window); a larger one replaces it by a pair of its own size, made by all
# ranks together (the same exchanges in the same order on every rank), so
# the windows hold the largest exchange so far, not one pair a graph size.
_WINDOWS: dict[tuple, _Window] = {}
# held by the watchdog while it looks at and poisons a pair, and by
# whoever takes a pair out of _WINDOWS to free it
_LOCK = threading.Lock()
_WATCHDOG: list[threading.Thread] = []


def window_bytes() -> int:
    """The bytes of this process's own window allocations (both windows of
    each pair and the signalled form's counters after them; the flag
    headers are a page of host memory each):
    cudaMalloc'ed outside torch's caching allocator, so
    ``torch.cuda.memory_allocated`` leaves them out."""
    return sum(w.alloc_bytes for w in _WINDOWS.values())


def _make_window(nbytes: int, group, dev: torch.device) -> _Window:
    """Allocate this rank's window pair with its counters (zeroed), its
    flag header (zeroed) and status word, swap the IPC handles and the
    headers' names over the group and open the peers' pairs and headers;
    then the own header's name goes (every rank has opened it; the page
    stays while it is mapped). The group's form is its route
    (``mesh.group_route``); a group over hosts has none and raises before
    anything is made. Every rank learns whether every rank succeeded, so a
    failure raises on all of them (none waits at the next barrier)."""
    form = group_route(group)
    if form == COLLECTIVE:
        raise RuntimeError("halo_all_to_all_ranks: a group over several "
                           "hosts exchanges by its collective and makes no "
                           "window")
    k, me = _group_shape(group)
    nh = _rank_lib("lp_halo_ipc_handle_bytes")()
    own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(nh)
    host, mapped = ctypes.c_void_p(), ctypes.c_void_p()
    headers: list = [None] * k
    try:
        headers[me] = header = _Header()
    except OSError:   # every rank must still reach the collectives
        header = None
    with torch.cuda.device(dev):
        rc = _rank_lib("lp_halo_window_alloc")(
            2 * nbytes + COUNTER_BYTES, ctypes.byref(own), handle)
        if rc == 0:
            rc = _rank_lib("lp_halo_status_alloc")(ctypes.byref(host),
                                                   ctypes.byref(mapped))
        if rc == 0:
            rc = header.register() if header else -1
        handles: list = [None] * k
        dist.all_gather_object(
            handles, (rc, handle.raw, header and header.shm.name),
            group=group)
        ptrs, err = [0] * k, ""
        if any(h[0] != 0 for h in handles):
            err = ("cudaMalloc / cudaIpcGetMemHandle / cudaHostAlloc / "
                   "cudaHostRegister failed (-1: "
                   f"no shared page for the flag header): CUDA errors by rank "
                   f"{[h[0] for h in handles]}")
        else:
            ptrs[me] = own.value
            for p in range(k):
                if p == me:
                    continue
                peer = ctypes.c_void_p()
                rc = _rank_lib("lp_halo_window_open")(handles[p][1],
                                                      ctypes.byref(peer))
                if rc != 0:
                    err = (f"cudaIpcOpenMemHandle of rank {p}'s window "
                           f"failed: CUDA error {rc}")
                    break
                ptrs[p] = peer.value
                try:
                    headers[p] = _Header(handles[p][2])
                except OSError as e:
                    err = f"rank {p}'s flag header: {e}"
                    break
                rc = headers[p].register()
                if rc != 0:
                    err = (f"cudaHostRegister of rank {p}'s flag header "
                           f"failed: CUDA error {rc}")
                    break
        errs: list = [None] * k
        dist.all_gather_object(errs, err, group=group)
        if header:
            header.shm.unlink()
        if any(errs):
            for p, a in enumerate(ptrs):
                if a and p != me:
                    _rank_lib("lp_halo_window_close")(a)
            for h in headers:
                if h is not None:
                    h.close()
            if own.value:
                _rank_lib("lp_halo_window_free")(own.value)
            if host.value:
                _rank_lib("lp_halo_status_free")(host.value)
            raise RuntimeError(
                "halo_all_to_all_ranks: the receive windows could not be "
                f"set up ({nbytes} bytes a window): " + "; ".join(
                    f"rank {p}: {e}" for p, e in enumerate(errs) if e))
    return _Window(me, nbytes, ptrs, group, [h.dev for h in headers],
                   [h.host for h in headers], host.value, mapped.value,
                   headers=headers, form=form, counter_bytes=COUNTER_BYTES)


def _status(w: _Window) -> int:
    """The status word: 0, or the first abort word a copy-out saw."""
    return ctypes.c_uint64.from_address(w.status).value if w.status else 0


def _completes(ev, t0: float, spin: float = 0.0) -> bool:
    """Whether ``ev`` (None: nothing recorded) completes before DEADLINE_S
    has passed since ``t0``, polled: without a pause for ``spin`` seconds,
    then every 0.1 ms."""
    while ev is not None and not ev.query():
        waited = time.monotonic() - t0
        if waited > DEADLINE_S:
            return False
        if waited > spin:
            time.sleep(1e-4)
    return True


def _barrier(group, bounded: bool) -> None:
    """A barrier over ``group``. Over gloo it is ``monitored_barrier``
    whether bounded or not, so that ranks that disagree on ``bounded``
    still meet; bounded, it raises past DEADLINE_S (a rank that died or
    stopped never comes), else past the group's own timeout."""
    if dist.get_backend(group) == "gloo":
        dist.monitored_barrier(group=group, timeout=datetime.timedelta(
            seconds=DEADLINE_S) if bounded else None)
    else:
        dist.barrier(group=group)


def _drop_window(key: tuple, failing: bool = False) -> None:
    """Wait for this rank's card (for its last copy-outs until DEADLINE_S,
    past which its own flags are poisoned so that its waits end), unmap the
    peers' windows of ``key``, wait for every rank of its group to have
    done so (while the group lives: then no stream of the group reads or
    writes a window or flag of it), and free this rank's own. ``failing``
    (an error on its way out of the caller) or a late copy-out first
    publishes an abort word into the peers' flags, which ends a peer's wait
    for an exchange this rank will not make; the barrier is then bounded by
    DEADLINE_S, and past it this rank's allocation is kept, unfreed, since
    a peer may still write it. Raises where a copy-out had recorded an
    abort that no exchange raised, or the deadline passed."""
    with _LOCK:
        w = _WINDOWS.pop(key)
    with torch.cuda.device(key[1]):
        t0 = time.monotonic()
        late = not all(_completes(ev, t0) for ev in w.events)
        word = ABORT | w.me << 32 | (DEADLINE_CODE if late else LEFT_CODE)
        if late:
            _store(w.own_host, word)
        torch.cuda.synchronize()
        seen = _status(w)
        if (failing or late) and not w.broken:
            _store(w.abort_host, word)   # no write of its stream follows
        for p, a in enumerate(w.ptrs):
            if p != w.me:
                _rank_lib("lp_halo_window_close")(a)
        for h in w.headers:
            h.close()
        if dist.is_initialized():
            _barrier(w.group, bool(failing or late or seen or w.broken))
        _rank_lib("lp_halo_window_free")(w.ptrs[w.me])
        if w.status:
            _rank_lib("lp_halo_status_free")(w.status)
    if late and not w.broken:
        raise RuntimeError(f"halo_all_to_all_ranks on rank {w.me}: the last "
                           f"exchanges did not complete within "
                           f"{DEADLINE_S} s of the windows' release")
    if seen and not w.broken:
        raise RuntimeError(_abort_text(seen, w.me))


def _window(nbytes: int, group, dev: torch.device) -> _Window:
    """The window pair of ``group`` on ``dev``, grown to ``nbytes`` a
    window where it is smaller, or made anew after an exchange over it
    raised (by every rank at once)."""
    key = (dist.group.WORLD if group is None else group, dev.index)
    w = _WINDOWS.get(key)
    if w is None or w.broken or w.nbytes < nbytes:
        if w is not None:
            _drop_window(key)
        w = _WINDOWS[key] = _make_window(nbytes, group, dev)
        if dev.type == "cuda":
            _watch_start()
    return w


def release_windows(failing: bool = False) -> None:
    """Drop every window pair: called before the group is destroyed, and
    at exit. Where ``failing``, or on an error's way out (inside a
    ``finally`` or ``except`` as it propagates), each pair first publishes
    this rank's leaving to its peers (``_drop_window``)."""
    failing = failing or sys.exc_info()[0] is not None
    for key in list(_WINDOWS):
        _drop_window(key, failing)


def _release_at_exit() -> None:
    """``release_windows`` at exit, failing after an uncaught error (the
    interpreter keeps it as ``sys.last_value``)."""
    release_windows(getattr(sys, "last_value", None) is not None)


atexit.register(_release_at_exit)


def _watch_once() -> None:
    """One look of the watchdog: a pair whose newest copy-out is still
    unfinished DEADLINE_S after it was enqueued has a wait that a peer
    does not end (a peer died, stopped, or raised outside the exchanges
    before it could say so). Its own flags get this rank's DEADLINE_CODE
    word, once, by host stores (no CUDA call, which could wait for this
    thread's caller inside the driver): its stream's waits end, the
    copy-out records the abort, a synchronise of the caller's returns, and
    the next exchange or the release raises."""
    now = time.monotonic()
    with _LOCK:
        for win in list(_WINDOWS.values()):
            ev = win.events[win.epoch % 2]
            if win.poisoned or ev is None or \
                    now - win.enqueued_at <= DEADLINE_S or ev.query():
                continue
            _store(win.own_host, ABORT | win.me << 32 | DEADLINE_CODE)
            win.poisoned = True


def _watch() -> None:
    while True:
        time.sleep(WATCH_S)
        try:
            _watch_once()
        except Exception:   # the watchdog must outlive one failed look
            logging.exception("halo_all_to_all_ranks: the watchdog's look "
                              "failed")


def _watch_start() -> None:
    """Start the watchdog (a daemon thread, one a process) once."""
    if not _WATCHDOG:
        _WATCHDOG.append(threading.Thread(target=_watch, daemon=True,
                                          name="halo-watchdog"))
        _WATCHDOG[0].start()


def _abort_text(word: int, me: int) -> str:
    rank, code = (word >> 32) & 0x3FFFFFFF, word & 0xFFFFFFFF
    what = {DEADLINE_CODE: f" waited past the {DEADLINE_S} s deadline for "
                           "an exchange",
            LEFT_CODE: " left the exchanges on an error outside them"}.get(
        code, f"'s launch failed: CUDA error {code}")
    return (f"halo_all_to_all_ranks on rank {me}: the exchange was aborted: "
            f"rank {rank}{what}")


def _fail(dev: torch.device, win: _Window, word: int, text: str):
    """Publish ``word`` into every peer's flags of both windows, on this
    rank's stream (after its earlier writes, which it must not follow),
    and into this rank's own by host stores (its own waits end), mark the
    pair broken and raise ``text``."""
    win.broken = text
    launch_on(dev, _rank_lib("lp_halo_flags_write"),
              _words(win.abort_words), len(win.abort_words), word)
    _store(win.own_host, word)
    raise RuntimeError(text)


def _check_flags(dev: torch.device, win: _Window, e: int) -> None:
    """Before exchange ``e``: no copy-out recorded an abort, and exchange
    e - 2's copy-out (the last over this window) completed, polled until
    DEADLINE_S."""
    me = win.me
    seen = _status(win)
    if not seen:
        # with a card a rank a host two exchanges ahead of its card waits
        # less than an exchange, and the OS's pause would hold every rank
        # back: it polls without one for SPIN_S; ranks sharing a card keep
        # the pauses
        spin = SPIN_S if win.form == SIGNALLED else 0.0
        if not _completes(win.events[e % 2], time.monotonic(), spin):
            _fail(dev, win, ABORT | me << 32 | DEADLINE_CODE,
                  f"halo_all_to_all_ranks on rank {me}: exchange {e - 2} of "
                  f"the group did not complete within {DEADLINE_S} s")
        seen = _status(win)
    if seen:
        _fail(dev, win, seen, _abort_text(seen, me))


def _enqueue(dev, win: _Window, fn_name: str, *args) -> None:
    """One launch or stream operation of exchange ``win.epoch``; on an
    error, the abort (every rank raises)."""
    _refused(dev, win, launch_on(dev, _rank_lib(fn_name), *args), fn_name)


def _refused(dev, win: _Window, rc: int, fn_name: str) -> None:
    """Where ``rc`` (of ``fn_name`` in exchange ``win.epoch``) is a CUDA
    error: the abort, published to every rank, and raise."""
    if rc != 0:
        word = ABORT | win.me << 32 | (rc & 0xFFFFFFFF)
        _fail(dev, win, word, f"{_abort_text(word, win.me)} ({fn_name}, "
                              f"exchange {win.epoch})")


def _record(dev: torch.device, win: _Window, w: int) -> None:
    """Mark the end of window ``w``'s copy-out on this rank's stream."""
    if win.events[w] is None:
        win.events[w] = torch.cuda.Event()
    win.events[w].record(torch.cuda.current_stream(dev))


def _kernels(win: _Window, buf: torch.Tensor, out: torch.Tensor,
             w: int) -> tuple:
    """The exchange's two launches over window ``w``, each (C entry,
    arguments): the write of ``buf``'s K blocks into every rank's window
    w, and the copy-out of this rank's into ``out``, which first looks for
    an abort word among its arrival words. ``_exchange`` puts the flags
    between them; without the flags they are the exchange's kernels
    alone."""
    k, me = len(win.ptrs), win.me
    return (("lp_halo_a2a_rank", (buf.data_ptr(), win.tables[w], me, k,
                                  buf.nbytes // k)),
            ("lp_halo_copy_out", (win.data(me, w), out.data_ptr(), out.nbytes,
                                  _arrival(win.flags[me], w, 0), k,
                                  win.status_dev)))


def halo_rank_signalled(buf: torch.Tensor, out: torch.Tensor, bases,
                        window: int, w: int, me: int, aborts: int,
                        status: int, targets: tuple[int, int],
                        share: int = 1) -> int:
    """One launch of K1's signalled rank form (``lp_halo_rank_signalled``)
    for rank ``me`` of K = len(``bases``), on the current stream of
    ``buf``'s CUDA device: this rank's (K*Bh, F) ``buf`` in, ``out`` its
    result, over window ``w`` of every rank's allocation (``bases``, a
    pointer array; ``window`` bytes a window, the counters after the two);
    ``aborts`` the device address of this rank's K abort words, ``status``
    of the word an abort seen is recorded in; ``targets`` (arrival, done)
    of its counters (``_Window.targets``); ``share`` the streams launching
    at once on the card. Counted in ``halo_rank_signalled.launches`` where
    it launched. Returns the CUDA error (0: launched)."""
    k = len(bases)
    rc = launch_on(buf.device, _rank_lib("lp_halo_rank_signalled"),
                   buf.data_ptr(), out.data_ptr(), bases, window, w, me, k,
                   buf.nbytes // k, aborts, status, *targets, share)
    if rc == 0:
        count_launch(halo_rank_signalled)
    return rc


# the signalled form's launches since the last reset: one an exchange
halo_rank_signalled.launches = 0


class StreamRanks:
    """K ranks of the signalled form as K streams of one process on one
    card: how one card launches and checks the kernel that the rank route
    runs only with a card a rank. Rank q's allocation (two windows of
    ``nbytes``, the counters after them) comes from torch's allocator,
    zeroed; the ranks share K abort words and a status word on the card
    (no watchdog or peer writes them here). :meth:`exchange` launches rank
    q's kernel on ``streams[q]`` with a K-th of a wave (``share`` K), so
    the K kernels are resident together. On the CPU the exchange is
    :func:`halo_all_to_all_plain`."""

    def __init__(self, dev: torch.device, k: int, nbytes: int,
                 streams: Sequence):
        self.dev, self.k, self.nbytes = dev, k, nbytes
        self.streams, self.sent, self.epoch = list(streams), [0, 0], 0
        if dev.type == "cpu":
            return
        self.allocs = [torch.zeros(2 * nbytes + COUNTER_BYTES,
                                   dtype=torch.uint8, device=dev)
                       for _ in range(k)]
        self.bases = (ctypes.c_void_p * k)(*(a.data_ptr()
                                             for a in self.allocs))
        self.words = torch.zeros(k + 1, dtype=torch.int64, device=dev)
        for s in self.streams:   # freed only after the streams' work
            for a in (*self.allocs, self.words):
                a.record_stream(s)

    def status(self) -> int:
        """The status word: 0, or an abort word a kernel saw."""
        return int(self.words[self.k]) if self.dev.type != "cpu" else 0

    def exchange(self, bufs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """K1 of the K ranks' (K*Bh, F) buffers, buffer q ready on
        ``streams[q]``: out q made and written on ``streams[q]``."""
        _check(bufs)
        if self.dev.type == "cpu":
            return halo_all_to_all_plain(list(bufs))
        k = self.k
        if len(bufs) != k or bufs[0].nbytes > self.nbytes:
            raise ValueError(f"StreamRanks takes {k} buffers of at most "
                             f"{self.nbytes} bytes")
        block_bytes = bufs[0].nbytes // k
        _check_launch(k, block_bytes, not any(b.data_ptr() % 16 for b in bufs))
        self.epoch += 1
        w = self.epoch % 2
        targets = next_targets(self.sent, w, block_bytes)
        aborts = self.words.data_ptr()
        outs = []
        for me, (s, b) in enumerate(zip(self.streams, bufs)):
            with torch.cuda.stream(s):
                out = torch.empty_like(b)
                rc = halo_rank_signalled(b, out, self.bases, self.nbytes, w,
                                         me, aborts, aborts + 8 * k, targets,
                                         share=k)
            if rc != 0:   # the ranks launched before it leave their spins
                self.words[0].fill_(ABORT | me << 32 | (rc & 0xFFFFFFFF))
                raise RuntimeError(f"halo_rank_signalled: rank {me}'s launch "
                                   f"failed: CUDA error {rc}")
            b.record_stream(s)
            outs.append(out)
        return outs


def _exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """The rank form on the card: exchange e = ``epoch + 1`` over window
    e mod 2, ordered by the group's signals alone (``csrc/halo_a2a.cu``: the
    counters of the signalled form, or the flags): no host collective and
    no synchronise once the windows exist."""
    k, _ = _group_shape(group)
    dev = buf.device
    block_bytes = buf.nbytes // k
    # what the ranks share; an address the kernel does not take is refused
    # at its entry, which aborts the exchange on every rank
    _check_launch(k, block_bytes, True)
    win = _window(buf.nbytes, group, dev)
    e = win.epoch + 1
    w = e % 2
    _check_flags(dev, win, e)
    win.epoch = e
    out = torch.empty_like(buf)
    if win.form == SIGNALLED:
        me = win.me
        _refused(dev, win, halo_rank_signalled(
            buf, out, win.bases, win.nbytes, w, me,
            _arrival(win.flags[me], w, 0), win.status_dev,
            win.targets(w, block_bytes)), "lp_halo_rank_signalled")
    else:
        _flags_exchange(dev, win, buf, out, e)
    _record(dev, win, w)
    win.enqueued_at = time.monotonic()
    return out


def _flags_exchange(dev, win: _Window, buf: torch.Tensor, out: torch.Tensor,
                    e: int) -> None:
    """The flags form's exchange ``e`` (``csrc/halo_a2a.cu``): the wait for
    the peers' reads of exchange e - 2, the write, the arrival flags and
    their wait, the copy-out and the done flags, on this rank's stream."""
    w, n = e % 2, win.n_peers
    (write, write_args), (copy, copy_args) = _kernels(win, buf, out, w)
    if e > 2:
        _enqueue(dev, win, "lp_halo_flags_wait", win.wait_done[w], n, e - 2)
    _enqueue(dev, win, write, *write_args)
    count_launch(halo_all_to_all_ranks)
    _enqueue(dev, win, "lp_halo_flags_write", win.signal_arrival[w], n, e)
    _enqueue(dev, win, "lp_halo_flags_wait", win.wait_arrival[w], n, e)
    _enqueue(dev, win, copy, *copy_args)
    count_launch(halo_all_to_all_ranks)
    _enqueue(dev, win, "lp_halo_flags_write", win.signal_done[w], n, e)


def halo_collective(buf: torch.Tensor, group=None) -> torch.Tensor:
    """The COLLECTIVE route of a group over several hosts: this rank's
    (K*Bh, F) CUDA buffer exchanged by ``all_to_all_single`` over the group,
    on the card in the current stream's order over NCCL, through host
    copies over gloo (as ``edge_partition._on_host`` stages the other
    collectives). Counted in ``halo_all_to_all_ranks.collective_exchanges``:
    the backend's work, no launch of a kernel of this repo."""
    if dist.get_backend(group) == "gloo":
        out = halo_all_to_all_ranks_plain(buf.cpu(), group).to(buf.device)
    else:
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=group)
    halo_all_to_all_ranks.collective_exchanges += 1
    return out


def halo_all_to_all_ranks(buf: torch.Tensor, group=None) -> torch.Tensor:
    """K1 over the K ranks of ``group`` (the default group if None): this
    rank's (K*Bh, F) buffer, block p for rank p, in; a new (K*Bh, F)
    buffer, block p from rank p, out. fp32 or bf16.

    The group's route comes from the ranks' placement before any exchange
    (``mesh.group_route``), never after a failure. Over several hosts it is
    :func:`halo_collective`. On one host, on CUDA tensors, the group's form
    orders the exchange against the peers on the card and not by the host:

    - Ranks with a card each (no card time-shared): the signalled form, one
      launch (:func:`halo_rank_signalled`, counted there). Its CTAs store
      this rank's K - 1 remote blocks into the peers' windows e mod 2 over
      NVLink, each after the peer's counter says it has read exchange
      e - 2's, and announce them by release adds into the peers' counters
      in device memory; the own block goes straight into the result, and
      each peer's block is copied out of the own window as soon as its
      counter reads whole, while the others still arrive. No flag crosses
      PCIe: host-memory flags between cards of their own would cost a
      stream's front end polling over it twice an exchange.
    - Ranks that time-share a card: the flags form, two launches
      (``lp_halo_a2a_rank`` and ``lp_halo_copy_out``, both counted here):
      the stream waits until every peer has read window e mod 2 of exchange
      e - 2, the write stores this rank's K blocks into the K windows and
      announces them in the peers' flags, the stream waits for every peer's
      blocks, and the copy-out copies the own window into the result; then
      the peers learn that the window is read. The flags are words in host
      memory that the streams wait on: no kernel spins, since a spinning
      kernel would hold the card while the peer it waits for cannot run.

    Later work on the stream reads the result in order. The host waits for
    nothing unless it runs two exchanges ahead of its card (then for at
    most DEADLINE_S). The group's windows grow to the exchange, by every
    rank at once, where they are smaller. A launch that fails aborts the
    exchange on every rank: this rank raises at once, each other at one of
    its next two exchanges or when the windows are released, naming the
    rank and its CUDA error (a kernel of the signalled form leaves its
    spins on the abort word in its flag header). A rank that releases its
    windows on an error outside the exchanges aborts them so too; where a
    peer died instead, a watchdog thread ends the waits of an exchange
    still unfinished DEADLINE_S after it was enqueued, so that a
    synchronise of the caller's returns and the next exchange raises. On
    CPU tensors every route runs :func:`halo_all_to_all_ranks_plain` (and
    is recorded all the same). Every rank of the group must make the same
    exchanges, of the same shapes, in the same order."""
    k, me = _group_shape(group)
    if buf.dim() != 2:
        raise ValueError("the rank form takes this rank's (K*Bh, F) buffer, "
                         f"got shape {tuple(buf.shape)}")
    _check_common(k, buf.shape, buf.dtype, buf.is_contiguous(),
                  buf.requires_grad)
    route = group_route(group)
    dev = buf.device
    if dev.type == "cpu":
        return halo_all_to_all_ranks_plain(buf, group)
    if dev.type != "cuda":
        raise ValueError(f"halo_all_to_all_ranks runs on cuda or cpu, not {dev}")
    if buf.nbytes == 0:
        return torch.empty_like(buf)
    if route == COLLECTIVE:
        return halo_collective(buf, group)
    return _exchange(buf, group)


# the flags form's launches since the last reset: two an exchange (the
# write and the copy-out); the COLLECTIVE route's exchanges, apart
halo_all_to_all_ranks.launches = 0
halo_all_to_all_ranks.collective_exchanges = 0


class HaloAllToAllRanks(torch.autograd.Function):
    """``HaloAllToAllRanks.apply(buf, group)``: :func:`halo_all_to_all_ranks`
    with a gradient. Block (p -> q) maps to (q -> p), so the backward is the
    same exchange of the gradient, made by every rank. The edge-partitioned
    path does not call it: there ``HaloGather`` and ``HaloReduce``
    (``edge_partition.py``) are each other's backward, as in the JAX
    package; this is the exchange alone with its gradient, as
    :class:`HaloAllToAll` is for the stacked form."""

    @staticmethod
    def forward(ctx, buf, group=None):
        ctx.group = group
        return halo_all_to_all_ranks(buf, group)

    @staticmethod
    def backward(ctx, grad):
        return halo_all_to_all_ranks(grad.contiguous(), ctx.group), None
