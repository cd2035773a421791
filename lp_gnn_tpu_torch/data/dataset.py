"""Processed LP blobs as host-side bipartite graphs.

Counterpart of ``lp_gnn_tpu/data/dataset.py`` (reference ``LPDataset``,
dataset.py:99-264). Blob format: ``processed/*.pk`` =
``[row, col, data, c_feas, v_feas, y_s, y_t, nnodes]`` plus the ``.meta``
sidecar, read with this package's own msgpack codec. Turning raw blobs into
processed ones (``process_one_raw``) is the data-prep slice's, not yet here.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import os.path as osp

import numpy as np

from ..utils.misc import extract_fn, split_idxs_train_val
from ..utils.serialize import json_dump, json_load, msgpack_load


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

    def size_info(self) -> list[dict]:
        """Per-graph size stats of the whole dataset, cached in
        ``size.json`` beside ``processed/`` (reference dataset.py:119-156)."""
        dump_fn = osp.join(self.root, "size.json")
        if osp.exists(dump_fn):
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

    def dump_size_info(self, dst: str):
        """Write the size table with its train/val split column to ``dst``
        (``time.h5``, reference dataset.py:107-117). Needs pandas; the
        caller checks that it is importable."""
        import pandas as pd
        from ..utils.serialize import df_dump
        if osp.exists(dst):
            return None
        df = pd.DataFrame(self.size_info()).loc[list(self._indices), :]
        df["fn"] = df.fn.str.replace(".pk", "", regex=False)
        tr, va = split_train_val(self, seed=0)
        df.loc[tr.indices(), "split"] = "train"
        df.loc[va.indices(), "split"] = "val"
        df_dump(df, dst)
        return df


def split_train_val(ds: LPDataset, seed: int = 0):
    """70/30 split, seed forced to 0 (reference utils.py:256-272)."""
    tr, va = split_idxs_train_val(len(ds), seed)
    return ds.subset(tr), ds.subset(va)
