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
them, one process a rank, on one host or on several, as JAX joins its
processes over DCN (README.md:62-66). Before the group exists the ranks
swap their :class:`Placement` through a ``TCPStore`` at the coordinator
(:func:`init_distributed`): each rank's host (:func:`host_key`), its index
among the ranks of its host and, from that, its card (``cuda:{local index
% the host's cards}``, or the CPU when asked) and the card's UUID. The
placement picks the group's backend, NCCL where no two ranks share a card
of one host and gloo otherwise (the CPU, or ranks that share a card: NCCL
refuses two ranks on one device), and each edge group's route of K1
(:func:`rank_form`, read by ``parallel/halo.py`` through
:func:`group_route`: a group on one host keeps K1's rank form, a group that
spans hosts exchanges by the backend's all-to-all). Ranks of
one host need not be contiguous in rank order; the contract holds across
hosts as on one.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import socket
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


BOOT_ID = "/proc/sys/kernel/random/boot_id"
STORE_TIMEOUT = datetime.timedelta(minutes=30)   # init_process_group's own


def host_key() -> str:
    """This process's host: its name and the boot of its kernel. Two ranks
    share a host only where both agree, since CUDA IPC and POSIX shared
    memory need one kernel (a name alone may repeat across machines)."""
    try:
        with open(BOOT_ID) as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


def local_indices(hosts) -> list[int]:
    """Each rank's index among the ranks of its host, in rank order."""
    seen: dict = {}
    out = []
    for h in hosts:
        out.append(seen.get(h, 0))
        seen[h] = out[-1] + 1
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where the ranks of the process group run, as every rank learned it
    before the group existed: rank r's host key (``hosts[r]``), its index
    among its host's ranks (``local``), its device (``devices``, as the
    rank names it), its card's UUID (``cards``; None off the card) and its
    host's count of cards (``host_cards``; 0 off the card), which gave
    the rank its card and which the log names."""
    hosts: tuple[str, ...]
    local: tuple[int, ...]
    devices: tuple[str, ...]
    cards: tuple
    host_cards: tuple[int, ...]

    @property
    def own_cards(self) -> bool:
        """Whether every rank has a card that no other rank of its host
        computes on: no card is time-shared."""
        pairs = list(zip(self.hosts, self.cards))
        return None not in self.cards and len(set(pairs)) == len(pairs)

    @property
    def backend(self) -> str:
        """NCCL where every rank has a card of its own, gloo otherwise."""
        return "nccl" if self.own_cards else "gloo"

    def n_hosts(self, ranks=None) -> int:
        """The hosts of ``ranks`` (every rank by default)."""
        ranks = range(len(self.hosts)) if ranks is None else ranks
        return len({self.hosts[r] for r in ranks})

    def describe(self) -> str:
        """Each rank's host (its name, a few characters of its boot id, and
        its index there) and card, for the log."""
        def host(h):
            name, _, boot = h.partition("/")
            return f"{name}/{boot[:8]}" if boot else name
        return "; ".join(
            f"rank {r} on {host(h)}#{i} {d}"
            + (f" ({c[:13]}; host cards {n})" if c else "")
            for r, (h, i, d, c, n) in enumerate(zip(
                self.hosts, self.local, self.devices, self.cards,
                self.host_cards)))


# the placement of the process group this process joined, kept while the
# group lives (halo.py and dryrun_multihost.py read it, never gather it)
_PLACEMENT: list = [None]


def placement() -> Placement | None:
    """The placement of the process group, or None without one."""
    return _PLACEMENT[0]


def _swap(store, env: DistEnv, name: str, value) -> list:
    """Every rank's ``value`` (JSON), in rank order, through ``store``."""
    store.set(f"lp_gnn/placement/{name}/{env.rank}", json.dumps(value))
    keys = [f"lp_gnn/placement/{name}/{r}" for r in range(env.world)]
    store.wait(keys)
    return [json.loads(store.get(k)) for k in keys]


def init_distributed(device: torch.device) -> tuple[torch.device, bool]:
    """Join the process group of the contract, if one is set: returns this
    rank's device and whether this call created the group (its caller
    then destroys it). The ranks first swap their placement through a
    ``TCPStore`` at ``LP_GNN_DIST_COORD`` (rank 0 its master), in two
    rounds: the host keys and card counts, which give each rank its index
    on its host and, on the card, its card ``cuda:(index % cards)``; then
    each rank's device and card UUID. The placement picks the backend
    (``Placement.backend``) and the group is made on the same store."""
    env = dist_env()
    if env is None:
        return device, False
    if dist.is_initialized():
        pl = placement()
        if pl is None:
            raise RuntimeError("a process group made outside init_distributed "
                               "has no placement of its ranks")
        if device.type == "cuda":
            device = torch.device(pl.devices[env.rank])
            torch.cuda.set_device(device)
        return device, False
    addr, port = env.coord.rsplit(":", 1)
    store = dist.TCPStore(addr, int(port), env.world, env.rank == 0,
                          timeout=STORE_TIMEOUT)
    on_card = device.type == "cuda"
    first = _swap(store, env, "host",
                  [host_key(), torch.cuda.device_count() if on_card else 0])
    hosts = [h for h, _ in first]
    local = local_indices(hosts)
    card = None
    if on_card:
        device = torch.device("cuda", local[env.rank] % first[env.rank][1])
        torch.cuda.set_device(device)
        card = str(torch.cuda.get_device_properties(device).uuid)
    second = _swap(store, env, "card", [str(device), card])
    pl = Placement(tuple(hosts), tuple(local),
                   tuple(d for d, _ in second), tuple(c for _, c in second),
                   tuple(n for _, n in first))
    dist.init_process_group(pl.backend, store=store, world_size=env.world,
                            rank=env.rank)
    _PLACEMENT[0] = pl
    logging.info("process group: rank %d of %d, %s, %s; %d host(s): %s",
                 env.rank, env.world, pl.backend, device, pl.n_hosts(),
                 pl.describe())
    return device, True


# the routes of K1 over a group of ranks (rank_form): the rank form's two
# forms on one host, the backend's all-to-all across hosts
FLAGS, SIGNALLED, COLLECTIVE = "flags", "signalled", "collective"


def rank_form(placement: Placement, ranks) -> str:
    """The route of the group of global ``ranks`` from the world's
    placement: COLLECTIVE where they run on more than one host (CUDA IPC
    and shared memory end at a host); on one host SIGNALLED where no rank
    of the world shares its card with another, so that no card is
    time-shared (a spinning kernel costs only its own card's SMs), FLAGS
    else, where no kernel may spin. A pure function of what every rank
    holds alike, so every rank takes the same route."""
    if placement.n_hosts(ranks) > 1:
        return COLLECTIVE
    return SIGNALLED if placement.own_cards else FLAGS


def group_ranks(group) -> list[int]:
    """The global ranks of ``group`` (the default group if None)."""
    return dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group)


# (a group's global ranks) -> the route its exchanges take, as this rank
# chose it from the placement; and each group seen, with the placement
# its route came from (both cleared with the process group)
ROUTES: dict[tuple[int, ...], str] = {}
_SEEN: dict = {}


def group_route(group) -> str:
    """The route of ``group`` (None: the default group), :func:`rank_form`
    of the placement :func:`init_distributed` kept, computed the first time
    the group is seen under that placement and recorded in ROUTES."""
    pl = placement()
    if pl is None:
        raise RuntimeError("no placement of the ranks: join the process "
                           "group through parallel/mesh.py init_distributed")
    seen = _SEEN.get(group)
    if seen is not None and seen[0] is pl:
        return seen[1]
    ranks = tuple(group_ranks(group))
    ROUTES[ranks] = route = rank_form(pl, ranks)
    _SEEN[group] = (pl, route)
    return route


def forget_routes() -> None:
    """Clear the routes taken (ROUTES) and the groups seen, so that the
    next exchange of each group computes its route anew."""
    ROUTES.clear()
    _SEEN.clear()


def group_routes(spec: dict[str, int]) -> list[tuple[list[int], str]]:
    """The edge groups that ``--mesh_shape`` (parsed) lays over the ranks
    (the grid's rows, or every rank for ``edge=K`` over K), each with the
    route of K1 its placement gives it (:func:`rank_form`); none outside
    those layouts."""
    world, _ = world_and_rank()
    dp, edge = int(spec.get("dp", 1)), int(spec.get("edge", 1))
    pl = placement()
    if pl is None or world == 1 or edge <= 1:
        return []
    if dp > 1 and dp * edge == world:
        groups = grid_ranks(dp, edge)[0]
    elif dp == 1 and edge == world:
        groups = [list(range(world))]
    else:
        return []
    return [(g, rank_form(pl, g)) for g in groups]


def log_routes(spec: dict[str, int]) -> None:
    """Log every edge group's ranks and route (:func:`group_routes`)."""
    routes = group_routes(spec)
    if routes:
        logging.info("edge groups over ranks: %s", "; ".join(
            f"ranks {r} {route}" for r, route in routes))


def from_primary(fn, *args):
    """``fn(*args)`` on rank 0, its result sent to every rank of the
    process group (``broadcast_object_list``), or ``fn(*args)`` itself
    without one: under the contract only rank 0 is sure to hold what rank
    0 wrote (a checkpoint of an earlier run), since each host has its own
    files. An error on rank 0 raises on every rank."""
    world, rank = world_and_rank()
    if world == 1:
        return fn(*args)
    box: list = [None]
    if rank == 0:
        try:
            box = [(True, fn(*args))]
        except Exception as e:   # sent on, and raised here after
            box, err = [(False, repr(e))], e
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        if rank == 0:
            raise err
        raise RuntimeError(f"rank 0 could not load what it sends: {value}")
    return value


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
    group destroyed, with the grids made over it, its placement and the
    routes its groups took, where ``created`` (``init_distributed``'s
    second result)."""
    from .halo import release_windows
    release_windows()
    if created:
        _GRIDS.clear()
        forget_routes()
        _PLACEMENT[0] = None
        dist.destroy_process_group()
