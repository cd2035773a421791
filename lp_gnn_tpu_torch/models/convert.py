"""Weights carried across: JAX GCN_FC params and checkpoints -> state_dict.

:func:`state_dict_from_jax_params` is the exact inverse of
``lp_gnn_tpu/models/torch_import.py:56 gcn_fc_params_from_state_dict``::

    conv1.l2r.rel.w (in,out)  -> conv1.left2right.lin_rel.weight (out,in) = w.T
    conv1.l2r.rel.b           -> conv1.left2right.lin_rel.bias
    conv1.l2r.root.w          -> conv1.left2right.lin_root.weight
    conv1.r2l.*               -> conv1.right2left.*
    layers[i].*               -> layers.{i}.*
    lin_left / lin_right      -> lin_left / lin_right .weight (= w.T) / .bias

:func:`load_checkpoint` reads either checkpoint kind without JAX: a
reference or port ``mdl.pth`` (a torch state_dict), or a JAX ``mdl.ckpt``
(``lp_gnn_tpu/train/trainer.py:216 save_ckpt``, a pickle whose optimizer
state holds optax objects). For the latter, any ``jax.*`` / ``optax.*``
global becomes an inert stub, so unpickling imports neither; only
``params`` is kept.
"""
from __future__ import annotations

import pickle
import pickletools
from collections import OrderedDict

import numpy as np
import torch


def _put_lin(sd, prefix, p):
    sd[prefix + ".weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["w"], np.float32).T))
    if "b" in p:
        sd[prefix + ".bias"] = torch.from_numpy(
            np.array(p["b"], np.float32))


def _put_bidir(sd, prefix, p):
    _put_lin(sd, prefix + ".left2right.lin_rel", p["l2r"]["rel"])
    _put_lin(sd, prefix + ".left2right.lin_root", p["l2r"]["root"])
    _put_lin(sd, prefix + ".right2left.lin_rel", p["r2l"]["rel"])
    _put_lin(sd, prefix + ".right2left.lin_root", p["r2l"]["root"])


def state_dict_from_jax_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX GCN_FC params (numpy leaves) -> this package's GCN_FC state_dict."""
    sd: OrderedDict = OrderedDict()
    _put_bidir(sd, "conv1", params["conv1"])
    for i, layer in enumerate(params["layers"]):
        _put_bidir(sd, f"layers.{i}", layer)
    _put_lin(sd, "lin_left", params["lin_left"])
    _put_lin(sd, "lin_right", params["lin_right"])
    return sd


# ----------------------------------------------------------- checkpoints
class _Inert:
    """Stands in for a jax / optax class or function while unpickling."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


_STUB_ROOTS = ("jax", "jaxlib", "optax", "chex", "flax")
_ALLOWED = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),    # numpy >= 2 with protocol 5
    ("numpy._core.numeric", "_frombuffer"),
}


class _JaxCkptUnpickler(pickle.Unpickler):
    """Unpickles a JAX ``mdl.ckpt``: numpy arrays and plain containers are
    rebuilt, jax / optax globals become :class:`_Inert` stubs, and any
    other global is refused."""

    def find_class(self, module, name):
        if module.split(".")[0] in _STUB_ROOTS:
            return type(name, (_Inert,), {"__module__": module})
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing global {module}.{name} in a JAX checkpoint")


def is_torch_checkpoint(path: str) -> bool:
    """torch.save writes a zip archive (``PK``), or legacy pickles whose
    globals import from ``torch``; a JAX ckpt is a pickle of numpy arrays
    and optax state (same sniff as ``lp_gnn_tpu/train/trainer.py:240``)."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":
            return True
        f.seek(0)
        last_strings: list[str] = []
        for _stream in range(8):
            try:
                for op, arg, _pos in pickletools.genops(f):
                    mod = ""
                    if op.name == "GLOBAL":
                        mod = str(arg).split(" ")[0]
                    elif "UNICODE" in op.name or "STRING" in op.name:
                        last_strings = (last_strings + [str(arg)])[-2:]
                    elif op.name == "STACK_GLOBAL" and len(last_strings) == 2:
                        mod = last_strings[0]
                    if mod == "torch" or mod.startswith("torch."):
                        return True
            except (ValueError, EOFError, pickle.UnpicklingError):
                return False
    return False


def load_checkpoint(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A GCN_FC state_dict (fp32, on the CPU) from a torch ``mdl.pth`` or a
    JAX ``mdl.ckpt``."""
    if is_torch_checkpoint(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(sd, dict):
            raise ValueError(f"{path}: expected a state_dict, got "
                             f"{type(sd).__name__}")
        return OrderedDict((k, v.float()) for k, v in sd.items())
    with open(path, "rb") as f:
        ckpt = _JaxCkptUnpickler(f).load()
    if not isinstance(ckpt, dict) or "params" not in ckpt:
        raise ValueError(f"{path}: not a JAX checkpoint (no 'params')")
    return state_dict_from_jax_params(ckpt["params"])
