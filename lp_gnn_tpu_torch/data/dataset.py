"""LP blobs: raw -> processed, and processed blobs as host-side bipartite
graphs.

Counterpart of ``lp_gnn_tpu/data/dataset.py`` (reference ``LPDataset``,
dataset.py:99-264). Blob format: ``raw/*.pk`` = ``[c, b_l, (row, col, data),
b_u, l, u, con_lbls, var_lbls, con_nms, var_nms]``; ``processed/*.pk`` =
``[row, col, data, c_feas, v_feas, y_s, y_t, nnodes]`` plus the ``.meta``
sidecar, written and read with this package's own msgpack codec, byte for
byte the JAX package's.
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import logging
import os
import os.path as osp

import numpy as np
from scipy.sparse import coo_matrix

from ..utils.misc import extract_fn, split_idxs_train_val
from ..utils.serialize import (json_dump, json_load, msgpack_dump,
                               msgpack_load, table_dump)
from .features import cvt_to_features
from .scaling import scaling


@dataclasses.dataclass
class BipartiteGraph:
    """One LP as a constraint<->variable bipartite graph (host-side).

    Edges in COO sorted by (row, col), i.e. grouped by constraint.
    """
    row: np.ndarray        # (nnz,) int32 constraint index
    col: np.ndarray        # (nnz,) int32 variable index
    val: np.ndarray        # (nnz,) float32 scaled A value
    c_feas: np.ndarray     # (m, 8) float32
    v_feas: np.ndarray     # (n, 8) float32
    y_s: np.ndarray        # (m,) int32 constraint labels
    y_t: np.ndarray        # (n,) int32 variable labels
    fn: str = ""           # instance name
    con_nms: list | None = None
    var_nms: list | None = None

    @property
    def ncons(self) -> int:
        return self.c_feas.shape[0]

    @property
    def nvars(self) -> int:
        return self.v_feas.shape[0]

    @property
    def nnz(self) -> int:
        return len(self.val)

    def validate(self) -> None:
        """Range checks the reference applies on load (dataset.py:235-238)."""
        tol = 1 + 1e-6
        if self.nnz and (self.val.max() > tol or self.val.min() < -tol):
            raise ValueError(f"{self.fn}: edge values outside [-1, 1]")
        if self.c_feas.size and (self.c_feas.max() > tol or
                                 self.c_feas.min() < -tol):
            raise ValueError(f"{self.fn}: constraint features outside [-1, 1]")


def process_one_raw(raw_path: str, processed_path: str) -> None:
    """raw/*.pk -> processed/*.pk + .meta (reference dataset.py:178-224):
    scale the LP, build the node features, check labels against bounds."""
    [c, b_l, (row, col, data), b_u, l, u,
     con_lbls, var_lbls, con_nms, var_nms] = msgpack_load(raw_path, copy=True)
    ncons, nvars = len(con_nms), len(var_nms)
    A = coo_matrix((data, (row, col)), shape=(ncons, nvars)).tocsr()
    c, b_l, A, b_u, l, u = scaling(c, b_l, A, b_u, l, u)
    v_feas, c_feas = cvt_to_features(c, b_l, A, b_u, l, u)
    v_feas = v_feas.astype(np.float32)
    c_feas = c_feas.astype(np.float32)
    y_s = np.asarray(con_lbls, dtype=np.int64)
    y_t = np.asarray(var_lbls, dtype=np.int64)

    # label/bound consistency (dataset.py:201-207): a row with a finite
    # lower bound tag cannot be labeled LL=0, one with an upper tag not UL=2
    cons_l_mask = np.abs(c_feas[:, -3]) > 0
    cons_u_mask = np.abs(c_feas[:, -1]) > 0
    vars_l_mask = np.abs(v_feas[:, -3]) > 0
    vars_u_mask = np.abs(v_feas[:, -1]) > 0
    if (y_s[cons_l_mask] == 0).any() or (y_s[cons_u_mask] == 2).any():
        raise ValueError(f"{raw_path}: constraint labels contradict the bounds")
    violates = int((y_t[vars_l_mask] == 0).sum())
    if violates:
        logging.warning("label violations on var lower-bound side: %d", violates)
    if (y_t[vars_u_mask] == 2).any():
        raise ValueError(f"{raw_path}: variable labels contradict the bounds")

    Ac = A.tocoo()
    msgpack_dump(
        [Ac.row, Ac.col, Ac.data.astype(np.float64), c_feas, v_feas,
         y_s, y_t, ncons + nvars],
        processed_path,
    )
    msgpack_dump(
        dict(num_cons=ncons, num_vars=nvars, raw_path=raw_path,
             processed_path=processed_path,
             con_nms=list(map(str, con_nms)), var_nms=list(map(str, var_nms))),
        processed_path + ".meta",
    )


def process_raw_dir(root: str, skip_exist: bool = True) -> list[str]:
    """Process every raw/*.pk under ``root`` into processed/. Returns the
    processed paths (reference LPDataset.process, dataset.py:178-224)."""
    raw_dir = osp.join(root, "raw")
    out_dir = osp.join(root, "processed")
    os.makedirs(out_dir, exist_ok=True)
    fns = sorted(glob.glob(osp.join(raw_dir, "*.pk")), key=lambda p: (len(p), p))
    out = []
    for raw_path in fns:
        dst = osp.join(out_dir, osp.basename(raw_path))
        if not (skip_exist and osp.exists(dst) and osp.exists(dst + ".meta")):
            process_one_raw(raw_path, dst)
        out.append(dst)
    return out


class LPDataset:
    """Random-access collection of processed LP graphs: stable name-sorted
    file order, subsets by index, optional ``.meta`` names."""

    def __init__(self, root: str, load_meta: bool = False):
        self.root = root
        self.load_meta = load_meta
        self.processed_dir = osp.join(root, "processed")
        fns = [f for f in os.listdir(self.processed_dir)
               if f.endswith(".pk")] if osp.isdir(self.processed_dir) else []
        self.fns = sorted(fns, key=lambda nm: (len(nm), nm))
        if not self.fns:
            raise ValueError(f"no processed .pk under {self.processed_dir}")
        self._indices = list(range(len(self.fns)))

    def __len__(self) -> int:
        return len(self._indices)

    def indices(self) -> list[int]:
        return list(self._indices)

    def subset(self, idxs) -> "LPDataset":
        ds = copy.copy(self)
        ds._indices = [self._indices[i] for i in idxs]
        return ds

    def __getitem__(self, i):
        if isinstance(i, (list, np.ndarray)):
            return self.subset(list(i))
        return self.get(self._indices[i])

    def get(self, file_idx: int) -> BipartiteGraph:
        fn = osp.join(self.processed_dir, self.fns[file_idx])
        [row, col, A_data, c_feas, v_feas, y_s, y_t, _nnodes] = \
            msgpack_load(fn, copy=True)
        g = BipartiteGraph(
            row=np.asarray(row, dtype=np.int32),
            col=np.asarray(col, dtype=np.int32),
            val=np.asarray(A_data, dtype=np.float32),
            c_feas=np.asarray(c_feas, dtype=np.float32),
            v_feas=np.asarray(v_feas, dtype=np.float32),
            y_s=np.asarray(y_s, dtype=np.int32),
            y_t=np.asarray(y_t, dtype=np.int32),
            fn=extract_fn(fn),
        )
        g.validate()
        # keep the reference's row-major edge order contract
        order = np.lexsort((g.col, g.row))
        g.row, g.col, g.val = g.row[order], g.col[order], g.val[order]
        if self.load_meta:
            meta = msgpack_load(fn + ".meta", copy=False)
            g.con_nms = list(meta["con_nms"])
            g.var_nms = list(meta["var_nms"])
        return g

    def size_info(self, recache: bool = False) -> list[dict]:
        """Per-graph size stats of the whole dataset, cached in
        ``size.json`` beside ``processed/`` (reference dataset.py:119-156);
        ``recache`` rewrites the cache."""
        dump_fn = osp.join(self.root, "size.json")
        if not recache and osp.exists(dump_fn):
            res = json_load(dump_fn)
            if len(res) == len(self.fns) and all(
                    r.get("fn") == osp.basename(self.fns[r["idx"]])
                    for r in res):
                return res
        res = []
        for idx in range(len(self.fns)):
            g = self.get(idx)
            res.append(dict(
                idx=idx, nedges=g.nnz, nnodes=g.ncons + g.nvars,
                fn=osp.basename(self.fns[idx]), ncons=g.ncons, nvars=g.nvars,
                density=g.nnz / max(g.ncons * g.nvars, 1),
                num_basis_vars=int((g.y_t == 1).sum()),
            ))
        json_dump(res, dump_fn)
        return res

    def dump_size_info(self, dst: str) -> list[dict] | None:
        """Start the results table ``dst`` (``time.json``, reference
        dataset.py:107-117): a row a graph, its size stats and its split
        (``train``/``val``). Keeps an existing table."""
        if osp.exists(dst):
            return None
        info = self.size_info()
        rows = [dict(info[i], fn=info[i]["fn"].replace(".pk", ""))
                for i in self._indices]
        by_idx = {r["idx"]: r for r in rows}
        tr, va = split_train_val(self, seed=0)
        for split, part in (("train", tr), ("val", va)):
            for i in part.indices():
                by_idx[i]["split"] = split
        table_dump(rows, dst)
        return rows


def split_train_val(ds: LPDataset, seed: int = 0):
    """70/30 split, seed forced to 0 (reference utils.py:256-272)."""
    tr, va = split_idxs_train_val(len(ds), seed)
    return ds.subset(tr), ds.subset(va)
