"""Weights carried across: JAX params and checkpoints -> state_dict.

:func:`state_dict_from_jax_params` maps the params tree of any JAX zoo
model (``lp_gnn_tpu/models/gcn.py``) onto this package's module names. For
GCN_FC it is the exact inverse of
``lp_gnn_tpu/models/torch_import.py:56 gcn_fc_params_from_state_dict``::

    conv1.l2r.rel.w (in,out)  -> conv1.left2right.lin_rel.weight (out,in) = w.T
    conv1.l2r.rel.b           -> conv1.left2right.lin_rel.bias
    conv1.l2r.root.w          -> conv1.left2right.lin_root.weight
    conv1.r2l.*               -> conv1.right2left.*
    layers[i].*               -> layers.{i}.*
    lin_left / lin_right      -> lin_left / lin_right .weight (= w.T) / .bias

GCN (``conv1..3``) and GCNDeeper (``conv_in``, ``blocks[i].conv``,
``conv_out``) reuse the GraphConv keys; a res+ block's ``norm_l`` /
``norm_r`` ``{g, b}`` become ``blocks.{i}.norm_l.weight`` / ``.bias``.
GENDeeper's GEN directions keep the JAX tree's names under the port's
direction names (``conv_in.left2right.edge.weight``, ``....t``,
``....mlp.l1``, ``....mlp.ln.weight``, ``....lin_src``, ...); the
reference's PyG ``GENConv`` keys are not reproduced (the JAX package maps
GCN_FC only, and no reference GEN checkpoint is at hand). GCNRand's one
leaf ``_`` keeps its name.

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


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _put_lin(sd, prefix, p):
    sd[prefix + ".weight"] = torch.from_numpy(
        np.array(np.asarray(p["w"], np.float32).T, order="C"))
    if "b" in p:
        sd[prefix + ".bias"] = _tensor(p["b"])


def _put_ln(sd, prefix, p):
    sd[prefix + ".weight"] = _tensor(p["g"])
    sd[prefix + ".bias"] = _tensor(p["b"])


def _put_gen_dir(sd, prefix, p):
    """One GEN direction (gen.py:109-124), in the port's module order."""
    _put_lin(sd, prefix + ".edge", p["edge"])
    sd[prefix + ".t"] = _tensor(p["t"])
    _put_lin(sd, prefix + ".mlp.l1", p["mlp"]["l1"])
    _put_ln(sd, prefix + ".mlp.ln", p["mlp"]["ln"])
    _put_lin(sd, prefix + ".mlp.l2", p["mlp"]["l2"])
    for side in ("lin_src", "lin_dst"):
        if side in p:
            _put_lin(sd, f"{prefix}.{side}", p[side])


def _put_bidir(sd, prefix, p):
    """A two-direction conv: GraphConv (``rel``, ``root``) or GEN."""
    for jax_dir, port_dir in (("l2r", "left2right"), ("r2l", "right2left")):
        d, pre = p[jax_dir], f"{prefix}.{port_dir}"
        if "rel" in d:
            _put_lin(sd, pre + ".lin_rel", d["rel"])
            _put_lin(sd, pre + ".lin_root", d["root"])
        else:
            _put_gen_dir(sd, pre, d)


def state_dict_from_jax_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX zoo params (numpy leaves) -> this package's state_dict of the
    same model, told apart by the tree's keys."""
    sd: OrderedDict = OrderedDict()
    if "_" in params:                                   # GCNRand
        sd["_"] = _tensor(params["_"])
    for name in ("conv1", "conv2", "conv3", "conv_in"):
        if name in params:
            _put_bidir(sd, name, params[name])
    for i, layer in enumerate(params.get("layers", [])):
        _put_bidir(sd, f"layers.{i}", layer)
    for i, blk in enumerate(params.get("blocks", [])):
        _put_bidir(sd, f"blocks.{i}.conv", blk["conv"])
        _put_ln(sd, f"blocks.{i}.norm_l", blk["norm_l"])
        _put_ln(sd, f"blocks.{i}.norm_r", blk["norm_r"])
    if "conv_out" in params:
        _put_bidir(sd, "conv_out", params["conv_out"])
    for name in ("lin_left", "lin_right"):
        if name in params:
            _put_lin(sd, name, params[name])
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
    """A state_dict of the zoo (fp32, on the CPU) from a torch ``mdl.pth``
    or a JAX ``mdl.ckpt`` of any architecture."""
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
