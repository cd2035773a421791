"""The ``edge`` mesh, the ``dp`` process group and the (dp, edge) grids of
devices and of ranks (counterpart of ``lp_gnn_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over its devices
(``make_mesh`` :72) and its tests run the edge axis on a virtual 8-device
CPU mesh. The port's :class:`EdgeMesh` says where the K shards of the
``edge`` axis live, in one of three layouts:

- every shard in this process, on one device (the card of the run, or the
  CPU when asked): the stacked path, which runs on one GPU;
- every shard in this process, one shard a device: shard k on
  ``devices[k]``, the JAX package's own layout of ``--mesh_shape edge=K``
  over K devices of one process (``train/trainer.py:346-387``,
  ``infer/predict.py:35-50``). Each shard's forward runs in a thread of
  its own, on its device and stream (``shard_threads.ShardThreads``), and
  K1 between them is the device form of ``parallel/halo.py``. The device
  list may repeat a device: the CPU tests and a run on one card take this
  layout so, with a stream a shard;
- one shard a process: under the contract below with K ranks and
  ``--mesh_shape edge=K``, rank k holds shard k (``group`` names the
  ranks), as the JAX package's edge axis spans ``jax.devices()`` across
  processes (``train/trainer.py:356-391``). The ranks may share one card
  or have a card each; K1 between them is the rank form of
  ``parallel/halo.py``.

In one process that sees at least D*E cards and joins no process group,
``--mesh_shape dp=D`` and ``dp=D,edge=E`` take JAX's own layout, a fourth
one: the (dp, edge) grid of devices (:class:`DeviceGrid`,
``make_mesh({"dp": D, "edge": E})`` :72, ``train/trainer.py:346-387,
476-490``). Cell (d, e) lives on ``cuda:(i + d*E + e) mod n`` from the
run's card i, the row-major reshape of the device list; each cell runs in
a thread and on a CUDA stream of its own; row d is an edge mesh with one
shard a device over its E cells, and column 0 holds the dp devices. The
entry points take it under one rule, :func:`one_shard_a_device`, which
also gives ``--mesh_shape edge=K`` its one shard a device.

With ``--mesh_shape dp=D,edge=E`` over D*E ranks the ranks form JAX's
(dp, edge) device grid (:class:`RankGrid`, :func:`make_grid`): rank r is
cell (d, e) = (r // E, r % E), the order in which ``make_mesh`` reshapes
the global device list, row-major. The E ranks of row d are the row's
edge group (an :class:`EdgeMesh` over them holds shard e on rank (d, e));
the D ranks of column e are a dp group. Over D ranks instead, each rank
holds all E shards of its graphs (``parallel/combined.py``).

The ``dp`` axis is one process a rank, joined by ``torch.distributed``
from the JAX package's environment contract (``maybe_init_distributed``
:20): ``LP_GNN_DIST_COORD`` (host:port of rank 0), ``LP_GNN_DIST_NPROCS``
(the world size) and ``LP_GNN_DIST_PROC_ID`` (this rank). A launcher sets
them, one process a rank. Rank r computes on ``cuda:{r % device_count}``
(or the CPU when asked); the group runs NCCL where every rank has a card
of its own and gloo otherwise (the CPU, or ranks that share a card: NCCL
refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .shard_threads import Member, ShardThreads


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
    """The K shards of the ``edge`` axis as this process holds them:
    ``devices``, the device of each shard held here, and ``group``, the
    process group whose rank k holds shard k (then one shard is held here),
    or None (every shard is held here). ``row``: the grid row whose edge
    group ``group`` is (:class:`RankGrid`; 0 outside a grid). Row 0 serves:
    the other rows skip the val and predict passes. ``threads``: with every
    shard here, one a device, their threads and streams (the devices may
    repeat); None for the stacked layout, whose one device is repeated K
    times. Inside shard k's thread its one-shard mesh has ``devices[k]``
    alone and the group ``threads.member(k)`` (:meth:`member`)."""
    devices: tuple[torch.device, ...]
    group: object = None
    row: int = 0
    threads: ShardThreads | None = dataclasses.field(default=None,
                                                     compare=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("an edge mesh needs at least one shard")
        if self.threads is not None:
            if self.group is not None or \
                    self.threads.devices != tuple(self.devices):
                raise ValueError("an edge mesh with one shard a device holds "
                                 "every shard in this process, shard k on "
                                 "devices[k]")
        elif len(set(self.devices)) > 1:
            raise ValueError(
                f"edge shards on distinct devices "
                f"{sorted(map(str, set(self.devices)))} without their "
                "threads: make_mesh(K, [device of each shard])")
        if self.group is not None and len(self.devices) != 1:
            raise ValueError("an edge mesh over ranks holds one shard a rank")

    @property
    def per_device(self) -> bool:
        """Whether every shard is held here, one a device (``threads``)."""
        return self.threads is not None

    @property
    def n_shards(self) -> int:
        """K, the shards of the axis (not only those held here)."""
        if self.group is None:
            return len(self.devices)
        if isinstance(self.group, Member):
            return self.group.size
        return dist.get_world_size(self.group)

    @property
    def shards(self) -> tuple[int, ...]:
        """The shards held here: all K, or this rank's (or thread's) one."""
        if self.group is None:
            return tuple(range(len(self.devices)))
        if isinstance(self.group, Member):
            return (self.group.rank,)
        return (dist.get_rank(self.group),)

    @property
    def device(self) -> torch.device:
        """The device that holds this process's shards, or with one shard a
        device the lead, shard 0's: it holds the master parameters and the
        stacked logits and labels."""
        return self.devices[0]

    def member(self, k: int) -> "EdgeMesh":
        """Shard k's one-shard mesh, with one shard a device."""
        return EdgeMesh((self.devices[k],), self.threads.member(k), self.row)


def make_mesh(n_shards: int, device, group=None, row: int = 0) -> EdgeMesh:
    """K shards on ``device`` (the stacked layout), or, given a list of K
    devices, shard k on ``device[k]``, every shard in this process, one
    thread and stream a shard (counterpart of ``make_mesh`` :72, which
    takes K distinct devices; here the list may repeat one), or, given
    ``group``, shard k on its rank k, this rank's on ``device``; K must
    then be the group's size (``row``: the grid row of ``group``)."""
    if n_shards < 1:
        raise ValueError(f"edge mesh of {n_shards} shards")
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(d) for d in device)
        if len(devs) != n_shards or group is not None:
            raise ValueError(f"an edge mesh of {n_shards} shards, one a "
                             f"device, over {len(devs)} devices"
                             + (" and a group" if group is not None else ""))
        if len({d.type for d in devs}) > 1:
            raise ValueError("edge shards on devices of two kinds: "
                             f"{[str(d) for d in devs]}")
        return EdgeMesh(devs, threads=ShardThreads(devs))
    if group is None:
        return EdgeMesh((torch.device(device),) * n_shards)
    world = dist.get_world_size(group)
    if world != n_shards:
        raise ValueError(f"an edge mesh of {n_shards} shards over a group of "
                         f"{world} ranks: one shard a rank")
    return EdgeMesh((torch.device(device),), group, row)


def one_shard_a_device(device: torch.device, n: int) -> bool:
    """The entry points' one rule for a mesh of ``n`` cells in one process:
    a device of its own a cell where no process group is joined,
    ``device`` is a card and at least ``n`` cards are visible. JAX lays a
    mesh over the first ``n`` of ``jax.devices()`` where it has that many
    (``make_mesh`` :72; ``infer/predict.py:47``, ``train/trainer.py:350-353,
    476-481``); the port asks with n = K for ``--mesh_shape edge=K`` and n =
    D*E for ``dp=D[,edge=E]`` (E = 1 for dp alone)."""
    world, _ = world_and_rank()
    return world == 1 and device.type == "cuda" and \
        torch.cuda.device_count() >= n


def shard_devices(device: torch.device, n: int) -> list[torch.device]:
    """The device of each of ``n`` cells, one a device: on the card,
    ``device``'s card and the next ones, cuda:(i + k) mod the cards
    visible (cuda:k from cuda:0; fewer cards than cells repeat them); on
    the CPU, the CPU ``n`` times."""
    if device.type != "cuda":
        return [device] * n
    cards, i = torch.cuda.device_count(), device.index or 0
    return [torch.device("cuda", (i + k) % cards) for k in range(n)]


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """JAX's (dp, edge) device grid in one process: cell (d, e) on
    ``devices[d*E + e]`` (the devices may repeat: one card, or the CPU in
    tests), a thread and stream a cell. ``threads``: every cell's, in (d, e)
    order (the parameters' one broadcast a step). ``rows[d]``: row d's edge
    mesh, one shard a device over its E cells, shard e on cell (d, e)'s
    device and stream. ``col``: the threads of column 0, the dp devices, on
    the same streams."""
    dp: int
    edge: int
    devices: tuple[torch.device, ...]
    threads: ShardThreads = dataclasses.field(compare=False)
    rows: tuple[EdgeMesh, ...] = dataclasses.field(compare=False)
    col: ShardThreads = dataclasses.field(compare=False)

    @property
    def device(self) -> torch.device:
        """The lead, cell (0, 0)'s: it holds the master parameters."""
        return self.devices[0]


def make_device_grid(dp: int, edge: int, devices) -> DeviceGrid:
    """The (dp, edge) grid over ``devices``, D*E of them in (d, e) order
    (``shard_devices(device, D*E)`` for JAX's layout from the run's
    card)."""
    devs = tuple(torch.device(d) for d in devices)
    if dp < 1 or edge < 1 or len(devs) != dp * edge:
        raise ValueError(f"a (dp={dp}, edge={edge}) grid over {len(devs)} "
                         "devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a grid over devices of two kinds: "
                         f"{[str(d) for d in devs]}")
    threads = ShardThreads(devs)
    rows = tuple(
        EdgeMesh(devs[d * edge:(d + 1) * edge], row=d,
                 threads=threads.part(range(d * edge, (d + 1) * edge)))
        for d in range(dp))
    return DeviceGrid(dp, edge, devs, threads, rows,
                      threads.part(range(0, dp * edge, edge)))


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """This rank's cell of the (dp, edge) grid of D*E ranks: (d, e), its
    row's edge group ``row`` (the E ranks of row d; shard e of the row's
    graphs lives here) and its column's dp group ``col`` (the D ranks of
    column e)."""
    dp: int
    edge: int
    d: int
    e: int
    row: object
    col: object


def grid_ranks(dp: int, edge: int) -> tuple[list[list[int]], list[list[int]]]:
    """The global ranks of every row and every column of a (dp, edge) grid:
    rank r is cell (r // edge, r % edge), the device order of JAX's
    ``make_mesh`` (a row-major reshape of the device list, :81-83)."""
    rows = [[d * edge + e for e in range(edge)] for d in range(dp)]
    return rows, [list(c) for c in zip(*rows)]


# (dp, edge) -> (the default group it was made under, the grid): a grid's
# groups are made once a process group, by every rank together
_GRIDS: dict = {}


def make_grid(dp: int, edge: int) -> RankGrid:
    """This rank's cell of the (dp, edge) grid over the process group's
    D*E ranks. Every rank makes every row group and every column group
    (``dist.new_group`` is collective: each rank in the same order,
    groups it is not in included); the grid is kept and returned again
    while the process group lives."""
    world, rank = world_and_rank()
    if dp * edge != world or dp < 1 or edge < 1:
        raise ValueError(f"a (dp={dp}, edge={edge}) grid over {world} ranks")
    cached = _GRIDS.get((dp, edge))
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    rows, cols = grid_ranks(dp, edge)
    row_groups = [dist.new_group(r) for r in rows]
    col_groups = [dist.new_group(c) for c in cols]
    d, e = divmod(rank, edge)
    grid = RankGrid(dp, edge, d, e, row_groups[d], col_groups[e])
    _GRIDS[(dp, edge)] = (dist.group.WORLD, grid)
    return grid


def grid_from_shape(spec: dict[str, int]) -> RankGrid | None:
    """The grid that ``--mesh_shape dp=D,edge=E`` (parsed) names over a
    process group of exactly D*E ranks, both axes above 1; else None (one
    process, dp ranks each holding all E shards, or edge ranks alone)."""
    dp, edge = int(spec.get("dp", 1)), int(spec.get("edge", 1))
    world, _ = world_and_rank()
    if world > 1 and dp > 1 and edge > 1 and dp * edge == world:
        return make_grid(dp, edge)
    return None


class DistEnv(NamedTuple):
    coord: str    # host:port of rank 0
    world: int
    rank: int


def dist_env() -> DistEnv | None:
    """The ``LP_GNN_DIST_*`` contract of this process (mesh.py:20-50), or
    None where ``LP_GNN_DIST_COORD`` is unset."""
    coord = os.environ.get("LP_GNN_DIST_COORD", "")
    if not coord:
        return None
    env = DistEnv(coord, int(os.environ["LP_GNN_DIST_NPROCS"]),
                  int(os.environ["LP_GNN_DIST_PROC_ID"]))
    if env.world < 1 or not 0 <= env.rank < env.world:
        raise ValueError(f"LP_GNN_DIST_PROC_ID={env.rank} outside "
                         f"LP_GNN_DIST_NPROCS={env.world}")
    return env


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or a process
    outside the contract."""
    env = dist_env()
    return env is None or env.rank == 0


def init_distributed(device: torch.device) -> tuple[torch.device, bool]:
    """Join the process group of the contract, if one is set: returns this
    rank's device (``cuda:{rank % device_count}`` for ``cuda``) and whether
    this call created the group (its caller then destroys it)."""
    env = dist_env()
    if env is None:
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", env.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    own_card = device.type == "cuda" and \
        env.world <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{env.coord}",
                            world_size=env.world, rank=env.rank)
    logging.info("process group: rank %d of %d, %s, %s", env.rank,
                 env.world, backend, device)
    return device, True


def world_and_rank() -> tuple[int, int]:
    """(ranks, this rank) of the process group; (1, 0) without one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def leave_distributed(created: bool) -> None:
    """The end of a run under the contract: the rank form's receive windows
    released (``parallel/halo.py release_windows``: each rank's card
    drained, then a barrier, so that no stream of the group still waits on
    or writes a flag or window when one is freed; on an error's way out it
    first tells the peers, whose waits for this rank then end; it raises
    where a copy-out recorded an abort that no exchange raised), then the process
    group destroyed, with the grids made over it, where ``created``
    (``init_distributed``'s second result)."""
    from .halo import release_windows
    release_windows()
    if created:
        _GRIDS.clear()
        dist.destroy_process_group()
