"""Which graphs the JAX package would stack: its padded leaf shapes,
computed in numpy without building padded tensors.

The JAX trainer groups the graphs of a graph-batched or dp step by the
full leaf-shape signature of ``pad_graph``'s output (``trainer.py:538-568``):
the ``(m_pad, n_pad, e_pad)`` bucket (``batching.py:113, 192-211``) and the
chunk counts of the two blocked MXU layouts (``:129-190``, ``:278``), which
depend on how the edges fall into 128-row blocks. The port pads nothing,
but it groups the same graphs in the same order, so that
``rng_np.permutation(len(stacks))`` (``:664``) and every draw after it stay
the JAX trainer's. :func:`stack_key` is that signature; the helpers are own
copies of ``batching.py``'s. :func:`block_layout` builds the layout itself,
for the blocked traversal that ``probe_spmm`` times beside the port's SpMM.
"""
from __future__ import annotations

import numpy as np

from .dataset import BipartiteGraph

BLOCK_R = 128       # dst rows a block (batching.py:102)
BLOCK_K = 512       # least edges a chunk
BLOCK_K_MAX = 1024  # most edges a chunk


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def make_buckets(base: int = 256, growth: float = 1.5,
                 max_size: int = 1 << 28) -> list[int]:
    """Geometric bucket sizes snapped to multiples of 128
    (batching.py:192)."""
    sizes = []
    s = float(base)
    while s < max_size:
        sizes.append(_round_up(int(s), 128))
        s *= growth
    return sizes


_DEFAULT_BUCKETS = make_buckets()


def bucket_for(size: int, buckets=None) -> int:
    """The smallest bucket >= size (batching.py:205)."""
    for b in buckets or _DEFAULT_BUCKETS:
        if b >= size:
            return b
    return _round_up(size, 128)


def pick_block_k(e_pad: int, num_dst: int, r: int = BLOCK_R) -> int:
    """Chunk depth from the padded sizes (batching.py:113)."""
    per_block = e_pad / max(_round_up(num_dst, r) // r, 1)
    k = BLOCK_K
    while k < per_block and k < BLOCK_K_MAX:
        k *= 2
    return k


def chunk_count(dst: np.ndarray, num_dst: int, k: int,
                r: int = BLOCK_R) -> int:
    """Chunks of ``block_layout`` (batching.py:129): each r-row block of
    the ``num_dst`` padded destinations takes ceil(its edges / k) chunks,
    at least one."""
    nblk = _round_up(num_dst, r) // r
    counts = np.bincount(np.asarray(dst, np.int64) // r, minlength=nblk)
    return int(np.maximum((counts + k - 1) // k, 1).sum())


def block_layout(dst: np.ndarray, src: np.ndarray, val: np.ndarray,
                 num_dst: int, r: int = BLOCK_R, k: int = BLOCK_K):
    """The JAX package's chunked per-destination-block edge layout
    (batching.py:141-190), array for array: each r-row block's edges (the
    edges sorted by ``dst``) in ceil(count / k) chunks of k slots, at
    least one a block; padding slots hold source 0, local row r - 1 and
    value 0. Returns (blk_src (B', k) int32, blk_dst (B', k) int32 local
    rows, blk_val (B', k) float32, out_blk (B',) int32 block of each
    chunk, the block count). The port's SpMM keeps its CSR; this layout
    feeds ``probe_spmm``'s blocked traversal only."""
    nblk = _round_up(num_dst, r) // r
    if len(dst) == 0:
        z = np.zeros((nblk, k), np.int32)
        return (z, np.full((nblk, k), r - 1, np.int32),
                np.zeros((nblk, k), np.float32),
                np.arange(nblk, dtype=np.int32), nblk)
    counts = np.bincount(dst // r, minlength=nblk)
    starts = np.zeros(nblk + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    n_chunks = int(np.maximum((counts + k - 1) // k, 1).sum())
    blk_src = np.zeros((n_chunks, k), np.int32)
    blk_dst = np.full((n_chunks, k), r - 1, np.int32)
    blk_val = np.zeros((n_chunks, k), np.float32)
    out_blk = np.zeros(n_chunks, np.int32)
    ci = 0
    for b in range(nblk):   # contiguous slice copies, as there
        s, e = int(starts[b]), int(starts[b + 1])
        if s == e:
            out_blk[ci] = b
            ci += 1
            continue
        for cs in range(s, e, k):
            ce = min(cs + k, e)
            blk_src[ci, :ce - cs] = src[cs:ce]
            blk_dst[ci, :ce - cs] = dst[cs:ce] - b * r
            blk_val[ci, :ce - cs] = val[cs:ce]
            out_blk[ci] = b
            ci += 1
    return blk_src, blk_dst, blk_val, out_blk, nblk


def chunk_ptr(out_blk: np.ndarray, num_blocks: int) -> np.ndarray:
    """Each block's chunk range from the sorted ``out_blk``
    (batching.py:278 ``_chunk_ptr``)."""
    ptr = np.zeros(num_blocks + 1, np.int32)
    np.cumsum(np.bincount(np.asarray(out_blk), minlength=num_blocks),
              out=ptr[1:])
    return ptr


def bucket_key(g: BipartiteGraph) -> tuple[int, int, int]:
    """``pad_graph(g).bucket_key()`` (batching.py:113): (m_pad, n_pad,
    e_pad), by which the JAX trainer groups dp x edge batches
    (trainer.py:580-583)."""
    return bucket_for(g.ncons), bucket_for(g.nvars), bucket_for(g.nnz)


def stack_key(g: BipartiteGraph) -> tuple[int, ...]:
    """What fixes the shapes of ``pad_graph(g)``'s leaves: the bucket,
    the feature widths and the two blocked layouts' chunk counts (their
    chunk depths follow from the bucket)."""
    m_pad, n_pad, e_pad = bucket_key(g)
    return (m_pad, n_pad, e_pad, g.c_feas.shape[1], g.v_feas.shape[1],
            chunk_count(g.row, m_pad, pick_block_k(e_pad, m_pad)),
            chunk_count(g.col, n_pad, pick_block_k(e_pad, n_pad)))
