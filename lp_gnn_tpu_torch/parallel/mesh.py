"""The ``edge`` mesh (counterpart of ``lp_gnn_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over its devices
(``make_mesh`` :72) and its tests run the edge axis on a virtual 8-device
CPU mesh. The port's counterpart places the K shards of the ``edge`` axis
on devices it is given; in this version all K placements are one device
(the card of the run, or the CPU when asked), which is how the path runs on
one GPU. Shards on several cards (NVLink peer copies, NCCL) are ROADMAP.md
queue item 7; a placement that names two distinct devices raises.
Multi-host initialisation (``maybe_init_distributed`` :20) waits for queue
items 6 and 7.
"""
from __future__ import annotations

import dataclasses

import torch


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse "dp=2,edge=4" -> {"dp": 2, "edge": 4} (mesh.py:61)."""
    out: dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


@dataclasses.dataclass(frozen=True)
class EdgeMesh:
    """The device of each of the K shards along the ``edge`` axis."""
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("an edge mesh needs at least one shard")
        devs = sorted(map(str, set(self.devices)))
        if len(devs) > 1:
            raise NotImplementedError(
                f"edge shards on distinct devices {devs}: "
                "placing shards on several cards (NVLink peer copies, NCCL) "
                "is not ported yet (ROADMAP.md, queue item 7: edge "
                "partition); all shards share one device")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device that holds every shard."""
        return self.devices[0]


def make_mesh(n_shards: int, device: torch.device | str) -> EdgeMesh:
    """K shard placements on ``device`` (counterpart of ``make_mesh``
    :72, which takes K distinct devices)."""
    if n_shards < 1:
        raise ValueError(f"edge mesh of {n_shards} shards")
    return EdgeMesh((torch.device(device),) * n_shards)
