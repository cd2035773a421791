"""Device choice: the GPU, or the CPU only when the caller asks for it."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default. Raises when a CUDA device is asked for and none
    is present: there is no silent CPU fallback. ``"cpu"`` runs the plain
    PyTorch versions of the kernels (the tests use it)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: lp_gnn_tpu_torch runs on the GPU. Pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU instead.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
