"""Host-side C++ SpMM/SDDMM over the native engine's library (counterpart
of ``lp_gnn_tpu/ops/host_spmm.py``).

``tpulp_spmm`` / ``tpulp_sddmm`` of ``solver/native/tpulp.cc``, in fp64 on
the host, with the semantics of the JAX package's ``segment_spmm`` and of
the port's ``ops/spmm.py`` plain version: an independent oracle for the
device kernels (it shares no code with them), usable where no card is.
``solver.native.build()`` makes the library; ``available()`` says whether
it is there. Imports no torch.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..solver.native import open_cdll

_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is None:
        lib = open_cdll()
        if lib is None or not hasattr(lib, "tpulp_spmm"):
            return None
        c_ip = ctypes.POINTER(ctypes.c_int)
        c_dp = ctypes.POINTER(ctypes.c_double)
        lib.tpulp_spmm.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, c_ip, c_ip, c_dp, c_dp, c_dp]
        lib.tpulp_spmm.restype = None
        lib.tpulp_sddmm.argtypes = [ctypes.c_longlong, ctypes.c_int, c_ip,
                                    c_ip, c_dp, c_dp, c_dp]
        lib.tpulp_sddmm.restype = None
        _lib = lib
    return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native engine's library is not built: call "
                           "lp_gnn_tpu_torch.solver.native.build() first")
    return lib


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _as_f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _check_range(idx: np.ndarray, size: int, name: str) -> None:
    """The C++ kernels do raw pointer arithmetic: an index out of range
    would corrupt the heap, not drop as a device segment sum does."""
    if idx.shape[0] and (int(idx.min()) < 0 or int(idx.max()) >= size):
        raise ValueError(f"{name} out of range [0, {size})")


def spmm_host(dst, src, val, x, num_dst: int) -> np.ndarray:
    """out[d] = sum over edges e with dst[e]==d of val[e] * x[src[e]] —
    the plain version of ``ops.spmm`` in fp64 (no autograd)."""
    lib = _require()
    dst, src = _as_i32(dst), _as_i32(src)
    val = _as_f64(val)
    x = _as_f64(x)
    ne = int(dst.shape[0])
    dim = int(x.shape[1])
    if src.shape != (ne,) or val.shape != (ne,):
        raise ValueError(f"dst, src, val of shapes {dst.shape}, {src.shape}, "
                         f"{val.shape}")
    _check_range(dst, num_dst, "dst")
    _check_range(src, x.shape[0], "src")
    out = np.zeros((num_dst, dim), dtype=np.float64)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.tpulp_spmm(ne, num_dst, dim, dst.ctypes.data_as(c_ip),
                   src.ctypes.data_as(c_ip), val.ctypes.data_as(c_dp),
                   x.ctypes.data_as(c_dp), out.ctypes.data_as(c_dp))
    return out


def sddmm_host(dst, src, gout, x) -> np.ndarray:
    """g_val[e] = dot(gout[dst[e]], x[src[e]]) — the edge-value gradient of
    spmm (the SDDMM of the JAX package's ops/spmm.py:_segment_spmm_bwd)."""
    lib = _require()
    dst, src = _as_i32(dst), _as_i32(src)
    gout, x = _as_f64(gout), _as_f64(x)
    ne = int(dst.shape[0])
    dim = int(x.shape[1])
    if src.shape != (ne,) or gout.shape[1] != dim:
        raise ValueError(f"src of shape {src.shape}, gout {gout.shape}, x "
                         f"{x.shape}")
    _check_range(dst, gout.shape[0], "dst")
    _check_range(src, x.shape[0], "src")
    gval = np.zeros(ne, dtype=np.float64)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.tpulp_sddmm(ne, dim, dst.ctypes.data_as(c_ip),
                    src.ctypes.data_as(c_ip), gout.ctypes.data_as(c_dp),
                    x.ctypes.data_as(c_dp), gval.ctypes.data_as(c_dp))
    return gval
