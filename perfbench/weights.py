"""The initial weights, drawn by the benchmark and handed alike to the
program and to the plain reference.

A reference lists its parameters (name, shape, initial value) in
``param_spec``; the uniform ones, ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))``
as ``torch.nn.Linear`` draws them, come out of one ``torch.rand`` call on
the run's device from a ``torch.Generator`` seeded from ``--seed``, in
float32, the type the parameters are kept in.
"""
from __future__ import annotations

import math

import torch

from .seeds import derive


def draw(spec: list[tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``spec``'s ``(name, shape, init)`` entries,
    ``init`` one of ``("uniform", bound)``, ``("ones",)``, ``("zeros",)``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    total = sum(math.prod(shape) for _, shape, init in spec
                if init[0] == "uniform")
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "uniform":
            k = math.prod(shape)
            out[name] = (u[at:at + k].view(shape) * 2 - 1) * init[1]
            at += k
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out
