"""GEN softmax aggregation: the message, its segment softmax and its sum.

Counterpart of the GEN direction's message and aggregation in the JAX
package: ``lp_gnn_tpu/models/gen.py`` ``gen_dir_apply`` :136-145 (edge
encoder, the gather ``lp_gnn_tpu/ops/spmm.py:252 gather_src``, relu + eps,
the temperature) and ``_segment_softmax_agg`` :39-106 in its default
``seg`` mode. Over one direction's edges, sorted by destination (``ptr``
(num_dst+1), ``src`` (E), ``a`` (E) fp32) with x (S, D)::

    pre  = x[src] + a * w + b            (w, b: the edge encoder, 1 -> D)
    m    = relu(pre) + 1e-7
    aggr = sum over a segment of softmax(t * m) * m     (per channel; 0 if empty)

:func:`gen_agg_fwd` computes aggr (and, where a gradient will be taken, the
log-sum-exp the backward needs); :func:`gen_agg_bwd` the gradients of pre,
w, b and t from dL/daggr. On a CUDA tensor each launches its hand-written
kernel (``csrc/gen_agg.cu``) or raises; on a CPU tensor it runs its plain
version. :class:`GenSoftmaxAgg` is the differentiable form: its backward
is :func:`gen_agg_bwd`, then the gather's backward, ``gather_src``'s VJP
(spmm.py:279-283), which is the CSR SpMM (``csrc/spmm.cu``) over the
transpose ordering with the edge permutation as its index
(``dx = spmm_csr(t_ptr, eperm, 1, dpre)``).

:func:`gen_lse_merge` (``csrc/gen_lse_merge.cu``) merges the (aggr, lse)
of a segment's parts into the segment's own, by log-sum-exp: the
edge-partitioned GEN layer's owner-side step (``parallel/dist_gen.py``).

The JAX package's probe knobs of the TPU lowering (``LP_GNN_GEN_MAX``,
``LP_GNN_GEN_FUSE``, ``LP_GNN_GEN_ACC``) have no counterpart: the kernel
keeps an online max per segment, which costs nothing extra, so the port
computes the ``seg`` semantics, with fp32 sums.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import spmm as _spmm
from ._build import count_launch, launch_on, launch_with_workspace

EPS = 1e-7   # gen.py:36
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def padded_width(d: int, dtype: torch.dtype) -> int:
    """D rounded up to whole 16-byte pieces of ``dtype``: the row width of
    ``dpre``, so that the SpMM kernel can read it."""
    vec = max(16 // torch.empty((), dtype=dtype).element_size(), 1)
    return -(-d // vec) * vec


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation type: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def gen_agg_fwd_plain(ptr, src, a, x, w, b, t):
    """Plain PyTorch version, in the JAX package's order of roundings:
    the message, its logits and their exps in x's dtype (gen.py:136-145,
    :77-88), the two segment sums in fp32 (fp64 for fp64 x). Returns aggr
    and the log-sum-exp, (num_dst, D) each, in the accumulation type."""
    num_dst, d = ptr.shape[0] - 1, x.shape[1]
    acc = _acc(x.dtype)
    seg = _spmm.segment_ids(ptr, src.shape[0])
    e = a.to(x.dtype)[:, None] * w + b
    m = torch.relu(x.index_select(0, src.long()) + e) + EPS
    z = m * t
    idx = seg[:, None].expand(-1, d)
    mx = torch.full((num_dst, d), float("-inf"), dtype=x.dtype,
                    device=x.device).scatter_reduce(0, idx, z, "amax")
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros((), dtype=x.dtype))
    ex = torch.exp(z - mx.index_select(0, seg))
    num = torch.zeros(num_dst, d, dtype=acc, device=x.device).index_add_(
        0, seg, (ex * m).to(acc))
    den = torch.zeros(num_dst, d, dtype=acc, device=x.device).index_add_(
        0, seg, ex.to(acc))
    aggr = num / den.clamp(min=1e-16)
    lse = torch.where(den > 0, mx.to(acc) + torch.log(den),
                      torch.zeros((), dtype=acc))
    return aggr, lse


def gen_agg_bwd_plain(ptr, src, a, x, w, b, t, g, aggr, lse):
    """Plain PyTorch version of the backward, the kernel's formula in fp32
    (fp64 for fp64 x) from the same inputs: m and alpha = exp(t m - lse)
    recomputed, ``dpre = g alpha (1 + t (m - aggr)) [pre > 0]``, dw = sum
    of a dpre, db = sum of dpre, dt = sum of g alpha m (m - aggr), the
    terms in the accumulation type and their sums taken in fp64 (dt's terms
    cancel: an fp32 sum of a bench-size segment set errs by more than the
    kernel's limit). Returns dpre (E, padded_width(D)) in x's dtype,
    zero-filled past D, and dw, db (D,), dt () in the accumulation type."""
    d = x.shape[1]
    acc = _acc(x.dtype)
    seg = _spmm.segment_ids(ptr, src.shape[0])
    ar = a.to(x.dtype).to(acc)[:, None]
    # x + (a w + b), each operation rounded, as the kernel computes it
    pre = x.index_select(0, src.long()).to(acc) + (ar * w.to(acc) + b.to(acc))
    m = torch.relu(pre) + EPS
    tt = t.to(acc)
    al = torch.exp(tt * m - lse.to(acc).index_select(0, seg))
    gal = g.to(acc).index_select(0, seg) * al
    dev = m - aggr.to(acc).index_select(0, seg)
    dp = torch.where(pre > 0, gal * (1 + tt * dev), torch.zeros((), dtype=acc))
    dpre = torch.zeros(src.shape[0], padded_width(d, x.dtype), dtype=x.dtype,
                       device=x.device)
    dpre[:, :d] = dp.to(x.dtype)
    f64 = torch.float64
    return (dpre, (ar * dp).sum(0, dtype=f64).to(acc),
            dp.sum(0, dtype=f64).to(acc),
            (gal * m * dev).sum(dtype=f64).to(acc))


def gen_agg_fwd_split_plain(ptr, src, a, x, w, b, t, cuts):
    """Plain version of the kernel's forward over parts: the edges are cut
    at the positions ``cuts`` (any, sorted, inside a segment or not); each
    part of a segment gives its triple in base 2, over its edges' z = t
    log2(e) m: M its max, S the sum of 2^(z - M), N the sum of 2^(z - M) m;
    the triples of a segment are merged in edge order by the kernel's rule
    (``merge3``: rescale both to the larger M and add). Returns aggr = N / S
    and lse = ln 2 (M + log2 S), 0 for an empty segment, in fp32 (fp64 for
    fp64 x), the message in that type as the kernel computes it. CPU
    tensors only: a test oracle for the kernel's merges."""
    num_dst, d = ptr.shape[0] - 1, x.shape[1]
    n_e = src.shape[0]
    acc = _acc(x.dtype)
    seg = _spmm.segment_ids(ptr, n_e)
    part = torch.searchsorted(torch.as_tensor(cuts, dtype=torch.long),
                              torch.arange(n_e), right=True)
    # parts of segments: runs of edges of one segment and one cut range
    new = torch.ones(n_e, dtype=torch.bool)
    new[1:] = (seg[1:] != seg[:-1]) | (part[1:] != part[:-1])
    piece = torch.cumsum(new.long(), 0) - 1
    n_p = int(piece[-1]) + 1 if n_e else 0
    ar = a.to(x.dtype).to(acc)[:, None]
    pre = x.index_select(0, src.long()).to(acc) + (ar * w.to(acc) + b.to(acc))
    m = torch.relu(pre) + EPS
    t2 = t.to(acc) * math.log2(math.e)
    z = t2 * m
    idx = piece[:, None].expand(-1, d)
    pm = torch.full((n_p, d), float("-inf"), dtype=acc).scatter_reduce(
        0, idx, z, "amax")
    pe = torch.exp2(z - pm.index_select(0, piece))
    ps = torch.zeros(n_p, d, dtype=acc).index_add_(0, piece, pe)
    pn = torch.zeros(n_p, d, dtype=acc).index_add_(0, piece, pe * m)
    # merge each segment's parts in order: the j-th part of every segment
    # with one at once
    p_seg = seg[new]
    first = torch.full((num_dst,), n_p, dtype=torch.long)
    first = first.scatter_reduce(0, p_seg, torch.arange(n_p), "amin")
    rank = torch.arange(n_p) - first.index_select(0, p_seg)
    M = torch.full((num_dst, d), float("-inf"), dtype=acc)
    S = torch.zeros(num_dst, d, dtype=acc)
    N = torch.zeros(num_dst, d, dtype=acc)
    for j in range(int(rank.max()) + 1 if n_p else 0):
        sel = rank == j
        r = p_seg[sel]
        m2, s2, n2 = pm[sel], ps[sel], pn[sel]
        mo, so, no = M[r], S[r], N[r]
        mn = torch.maximum(mo, m2)
        fa, fb = torch.exp2(mo - mn), torch.exp2(m2 - mn)
        M[r], S[r], N[r] = mn, so * fa + s2 * fb, no * fa + n2 * fb
    full = S > 0
    aggr = torch.where(full, N / torch.where(full, S, 1), 0)
    lse = torch.where(full, math.log(2) * (M + torch.log2(
        torch.where(full, S, 1))), 0)
    return aggr, lse


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C launchers' arguments: ..., num_dst, nnz, D, dtype, the
# workspaces and their bytes (the forward's arrival counts, then its
# scratch), the stream (csrc/gen_agg.cu)
_ARGTYPES = {"lp_gen_agg_fwd": [_P] * 9 + [_I, _L, _I, _I] + [_P, _L] * 2
             + [_P],
             "lp_gen_agg_bwd": [_P] * 11 + [_I, _P, _I, _L, _I, _I, _P, _L,
                                            _P],
             "lp_gen_agg_attrs": [_I, _I, _I, _P]}


def _lib(name: str):
    fn = getattr(_build.load("gen_agg"), name)
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(ptr, src, a, x, w, b, t):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (S, D), got shape {tuple(x.shape)}")
    d = x.shape[1]
    if ptr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError("ptr and src must be int32")
    if a.dtype != torch.float32:
        raise TypeError("a must be float32")
    if ptr.dim() != 1 or ptr.shape[0] < 1 or src.dim() != 1 or \
            a.shape != src.shape:
        raise ValueError("ptr (num_dst+1,), src and a (E,) must be 1-D with "
                         "src and a of one length")
    if w.shape != (d,) or b.shape != (d,) or t.shape != ():
        raise ValueError(f"w and b must be ({d},) and t 0-d, got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}, {tuple(t.shape)}")
    if not w.dtype == b.dtype == t.dtype == x.dtype:
        raise TypeError(f"w, b and t must be x's dtype {x.dtype}")
    dev = x.device
    tensors = (ptr, src, a, x, w, b, t)
    if any(v.device != dev for v in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{ {v.device for v in tensors} }")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("ptr, src, a, x, w, b and t must be contiguous")
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, w, b, t)):
        raise NotImplementedError(
            "gen_agg_fwd / gen_agg_bwd are not differentiable themselves: "
            "GenSoftmaxAgg.apply gives the aggregation its backward. Run "
            "under torch.no_grad().")
    if dev.type == "cuda" and x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gen_agg kernel takes fp32 or bf16, not {x.dtype}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"gen_agg runs on cuda or cpu, not {dev}")
    return dev


def gen_agg_fwd(ptr, src, a, x, w, b, t, need_lse: bool = True):
    """The aggregation of one GEN direction (module docstring): ptr
    (num_dst+1,) and src (E,) int32, a (E,) fp32, x (S, D), w and b (D,)
    and t () in x's dtype (fp32 or bf16; fp64 on the CPU only). Returns
    (aggr, lse), (num_dst, D) fp32 each (fp64 for fp64): aggr, 0 where a
    segment is empty, and the per-segment log-sum-exp of t * m, which only
    the backward reads: with ``need_lse=False`` the kernel writes none and
    lse is None."""
    dev = _check(ptr, src, a, x, w, b, t)
    if dev.type == "cpu":
        aggr, lse = gen_agg_fwd_plain(ptr, src, a, x, w, b, t)
        return aggr, (lse if need_lse else None)
    num_dst, d = ptr.shape[0] - 1, x.shape[1]
    aggr = torch.empty(num_dst, d, dtype=torch.float32, device=dev)
    lse = torch.empty_like(aggr) if need_lse else None
    if aggr.numel() == 0:
        return aggr, lse
    rc = launch_with_workspace(
        "gen_agg_fwd", dev, _lib("lp_gen_agg_fwd"), ptr.data_ptr(),
        src.data_ptr(), a.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        t.data_ptr(), aggr.data_ptr(), 0 if lse is None else lse.data_ptr(),
        num_dst, src.shape[0], d, _DTYPE_CODE[x.dtype], buffers=2)
    if rc != 0:
        raise RuntimeError(f"gen_agg_fwd kernel launch failed: CUDA error {rc}")
    count_launch(gen_agg_fwd)
    return aggr, lse


gen_agg_fwd.launches = 0   # kernel launches since the last reset


def gen_agg_bwd(ptr, src, a, x, w, b, t, g, aggr, lse):
    """The backward of :func:`gen_agg_fwd` from g = dL/daggr, with its
    aggr and lse (num_dst, D) fp32. Returns dpre (E, padded_width(D)) in
    x's dtype, its columns past D zero (the gather's backward reads it with
    the SpMM), and dw, db (D,), dt () fp32, summed in a fixed order (no
    atomics: bit-identical over two calls). One call launches the per-CTA
    pass and the fixed-order reduce of its partial sums."""
    if lse is None:
        raise ValueError("gen_agg_bwd needs the forward's lse: run "
                         "gen_agg_fwd with need_lse=True")
    dev = _check(ptr, src, a, x, w, b, t)
    num_dst, d = ptr.shape[0] - 1, x.shape[1]
    acc = _acc(x.dtype)
    for name, v in (("g", g), ("aggr", aggr), ("lse", lse)):
        if v.shape != (num_dst, d) or v.dtype != acc or v.device != dev or \
                not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({num_dst}, {d}) "
                             f"{acc} tensor on {dev}")
    if dev.type == "cpu":
        return gen_agg_bwd_plain(ptr, src, a, x, w, b, t, g, aggr, lse)
    ld = padded_width(d, x.dtype)
    alloc = torch.zeros if ld != d else torch.empty
    dpre = alloc(src.shape[0], ld, dtype=x.dtype, device=dev)
    out = torch.zeros(2 * d + 1, dtype=torch.float32, device=dev)
    if num_dst == 0 or d == 0:
        return dpre, out[:d], out[d:2 * d], out[2 * d]
    rc = launch_with_workspace(
        "gen_agg_bwd", dev, _lib("lp_gen_agg_bwd"), ptr.data_ptr(),
        src.data_ptr(), a.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        t.data_ptr(), g.data_ptr(), aggr.data_ptr(), lse.data_ptr(),
        dpre.data_ptr(), ld, out.data_ptr(), num_dst, src.shape[0], d,
        _DTYPE_CODE[x.dtype])
    if rc != 0:
        raise RuntimeError(f"gen_agg_bwd kernel launch failed: CUDA error {rc}")
    count_launch(gen_agg_bwd)
    return dpre, out[:d], out[d:2 * d], out[2 * d]


gen_agg_bwd.launches = 0   # kernel launches since the last reset


def kernel_attrs(dtype: torch.dtype, d: int, backward: bool) -> dict:
    """Registers, resident CTAs an SM and static shared memory of the
    kernel that :func:`gen_agg_fwd` (or :func:`gen_agg_bwd`) launches for
    x of ``dtype`` and width ``d`` (16-byte aligned tensors), read from the
    loaded library on the current device."""
    out = (ctypes.c_int * 3)()
    vector = int(d % (16 // torch.empty((), dtype=dtype).element_size()) == 0)
    rc = _lib("lp_gen_agg_attrs")(int(backward), _DTYPE_CODE[dtype], vector,
                                  ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"lp_gen_agg_attrs failed: CUDA error {rc}")
    return {"regs": out[0], "ctas_per_sm": out[1], "smem_bytes": out[2]}


def gen_lse_merge_plain(local_edges, loc_aggr, loc_lse, ptr, idx, parts):
    """Plain PyTorch version of :func:`gen_lse_merge`: the parts of each row
    (its local part where ``local_edges`` > 0, then its slot parts), their
    largest lse, and the sums of exp(lse_p - max) and of those times
    aggr_p, in the inputs' type; 0 for a row without parts."""
    rows, d = loc_aggr.shape
    has = torch.nonzero(local_edges > 0)[:, 0]
    p_row = torch.cat([has, _spmm.segment_ids(ptr, idx.shape[0])])
    slot = parts.index_select(0, idx.long())
    p_aggr = torch.cat([loc_aggr.index_select(0, has), slot[:, :d]])
    p_lse = torch.cat([loc_lse.index_select(0, has), slot[:, d:2 * d]])
    mx = torch.full((rows, d), float("-inf"), dtype=loc_lse.dtype,
                    device=loc_lse.device).scatter_reduce(
        0, p_row[:, None].expand(-1, d), p_lse, "amax")
    e = torch.exp(p_lse - mx.index_select(0, p_row))
    s = torch.zeros_like(loc_aggr).index_add_(0, p_row, e)
    n = torch.zeros_like(loc_aggr).index_add_(0, p_row, e * p_aggr)
    full = s > 0
    s1 = torch.where(full, s, 1)
    return (torch.where(full, n / s1, 0),
            torch.where(full, mx + torch.log(s1), 0))


def _merge_lib():
    fn = _build.load("gen_lse_merge").lp_gen_lse_merge
    if fn.argtypes is None:   # without argtypes ctypes would cut pointers to int
        fn.argtypes = [_P] * 6 + [_L, _I, _I, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def gen_lse_merge(local_edges, loc_aggr, loc_lse, ptr, idx, parts):
    """The softmax aggregation of rows whose edges come in parts, from each
    part's (aggr_p, lse_p) (``csrc/gen_lse_merge.cu``): ``lse = log sum_p
    exp(lse_p)``, ``aggr = sum_p exp(lse_p - lse) aggr_p``, per row and
    channel, 0 and 0 for a row without parts. ``local_edges`` (R,) int32
    (> 0: the row has a local part, ``loc_aggr`` / ``loc_lse`` (R, D));
    ``ptr`` (R+1,) and ``idx`` (n,) int32 list each row's other parts as
    rows of ``parts`` (P, >= 2D), aggr in its first D columns and lse in
    the next D. fp32 on the card (fp64 too on the CPU). Returns (aggr, lse),
    (R, D) each."""
    rows, d = loc_aggr.shape
    dev = loc_aggr.device
    tensors = (local_edges, loc_aggr, loc_lse, ptr, idx, parts)
    if any(v.device != dev for v in tensors) or \
            not all(v.is_contiguous() for v in tensors):
        raise ValueError("gen_lse_merge takes contiguous tensors on one device")
    if local_edges.dtype != torch.int32 or ptr.dtype != torch.int32 or \
            idx.dtype != torch.int32:
        raise TypeError("local_edges, ptr and idx must be int32")
    if loc_lse.shape != (rows, d) or local_edges.shape != (rows,) or \
            ptr.shape != (rows + 1,) or parts.dim() != 2 or \
            parts.shape[1] < 2 * d:
        raise ValueError("gen_lse_merge: loc_aggr, loc_lse (R, D), "
                         "local_edges (R,), ptr (R+1,), parts (P, >= 2D)")
    if not loc_aggr.dtype == loc_lse.dtype == parts.dtype:
        raise TypeError("loc_aggr, loc_lse and parts must share one dtype")
    if dev.type == "cpu":
        return gen_lse_merge_plain(*tensors)
    if dev.type != "cuda":
        raise ValueError(f"gen_lse_merge runs on cuda or cpu, not {dev}")
    if parts.dtype != torch.float32:
        raise TypeError(f"gen_lse_merge kernel takes fp32, not {parts.dtype}")
    aggr = torch.empty_like(loc_aggr)
    lse = torch.empty_like(loc_aggr)
    if aggr.numel() == 0:
        return aggr, lse
    rc = launch_on(dev, _merge_lib(), local_edges.data_ptr(),
                   loc_aggr.data_ptr(), loc_lse.data_ptr(), ptr.data_ptr(),
                   idx.data_ptr(), parts.data_ptr(), parts.shape[1], rows, d,
                   aggr.data_ptr(), lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"gen_lse_merge kernel launch failed: CUDA error {rc}")
    count_launch(gen_lse_merge)
    return aggr, lse


gen_lse_merge.launches = 0   # kernel launches since the last reset


def gather_backward(t_ptr, eperm, dpre, d: int) -> torch.Tensor:
    """``gather_src``'s VJP (spmm.py:279-283): ``dx[s] = sum of dpre[e]``
    over the edges e of source s, taken in the transpose ordering (``t_ptr``
    over the sources, ``eperm`` the position of each of its edges in
    dpre's ordering) by the SpMM with unit values; the first d columns.
    fp64 on the CPU (a dtype of the plain versions only, for gradcheck)
    takes the SpMM's plain version, which the wrapper refuses fp64 for; on
    the card the wrapper raises for it."""
    ones = torch.ones(eperm.shape[0], dtype=torch.float32, device=dpre.device)
    if dpre.dtype == torch.float64 and dpre.device.type == "cpu":
        dx = _spmm.spmm_csr_plain(t_ptr, eperm, ones, dpre)
    else:
        dx = _spmm.spmm_csr(t_ptr, eperm, ones, dpre)
    return dx[:, :d]


class GenSoftmaxAgg(torch.autograd.Function):
    """``GenSoftmaxAgg.apply(ptr, src, a, x, w, b, t, t_ptr, eperm)`` ->
    aggr (num_dst, D) fp32, :func:`gen_agg_fwd`'s aggregation with a
    gradient for x, w, b and t. ``t_ptr`` and ``eperm`` are the transpose
    ordering (the edges sorted by source) and, for each of its edges, the
    position in this ordering; they are needed only for x's gradient.
    ``need_lse`` (an optional last argument, True by default) says whether
    a gradient will be taken: the forward writes the lse the backward reads
    only then. The backward is one :func:`gen_agg_bwd` call and, for x, one
    SpMM over the transpose ordering (:func:`gather_backward`)."""

    @staticmethod
    def forward(ctx, ptr, src, a, x, w, b, t, t_ptr, eperm, need_lse=True):
        aggr, lse = gen_agg_fwd(ptr, src, a, x, w, b, t, need_lse)
        ctx.save_for_backward(ptr, src, a, x, w, b, t, aggr, lse, t_ptr,
                              eperm)
        return aggr

    @staticmethod
    def backward(ctx, grad_aggr):
        ptr, src, a, x, w, b, t, aggr, lse, t_ptr, eperm = ctx.saved_tensors
        dpre, dw, db, dt = gen_agg_bwd(ptr, src, a, x, w, b, t,
                                       grad_aggr.contiguous(), aggr, lse)
        dx = None
        if ctx.needs_input_grad[3]:
            dx = gather_backward(t_ptr, eperm, dpre, x.shape[1])
        return (None, None, None, dx, dw.to(w.dtype), db.to(b.dtype),
                dt.to(t.dtype), None, None, None)


def gen_softmax_agg(ptr, src, a, x, w, b, t, t_ptr=None, eperm=None):
    """:class:`GenSoftmaxAgg` on contiguous w, b, t; refuses, before any
    work, a forward whose x will want a gradient without the transpose
    ordering's permutation. The forward writes its lse only where a
    gradient will be taken: in grad mode with x, w, b or t requiring one
    (remat's recompute is such a forward), not when serving."""
    grad = torch.is_grad_enabled()
    if eperm is None and grad and x.requires_grad:
        raise ValueError(
            "the GEN aggregation's gradient for x needs the edge "
            "permutations: build the graph with "
            "GraphTensors.from_graph(..., perms=True)")
    need_lse = grad and any(v.requires_grad for v in (x, w, b, t))
    return GenSoftmaxAgg.apply(ptr, src, a, x, w.contiguous(),
                               b.contiguous(), t.contiguous(), t_ptr, eperm,
                               need_lse)
