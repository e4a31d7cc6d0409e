"""The mesh of processes: one process per card.

The counterpart of ``em_adapt_tpu/parallel/mesh.py``. The JAX package
builds one mesh over every device and lets XLA insert the collectives;
here each process drives one card (or the CPU) and joins a
``torch.distributed`` process group: NCCL carries CUDA tensors between
cards and gloo carries host tensors (``backend="cpu:gloo,cuda:nccl"``, one
group for both); on the CPU, or where NCCL cannot run (two processes on
one card), the group is gloo alone.

:func:`init_world` joins the group and returns the :class:`World`: the
rank, the world size, the local rank and the device. :func:`make_plan`
lays the world out as the mesh ``data × space × model`` of
``MeshConfig.axes`` (row-major in the order of the axes, as the JAX
package reshapes its devices, so the last axis is the innermost) and
returns the :class:`MeshPlan`: this rank's coordinate on each axis and a
process group for each line of ranks that a collective runs over:

* ``data``: the batch's images (``Trainer``'s rows, ``DatasetShard``);
* ``space``: the image's rows (``parallel/spatial.py``: the halo
  exchanges of every conv and pool, the score map gathered for the
  E-step);
* ``model``: fc6's output channels and fc7's input channels
  (``parallel/tensor.py``, the rules of :data:`TP_RULES`);
* ``ddp``: the data × space ranks of one model index, whose gradients
  ``DistributedDataParallel`` averages, and over which the loss's sums
  (:func:`all_sum`) and eval's confusion counts are taken, so that a
  model replica is counted once.

The E-step's batch max (:func:`global_max`) is taken over the world: a
max is the same however many replicas of a value enter it. Host-side
agreements (a barrier, a broadcast of rank 0's value, the check that the
ranks agree) run over the world too.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from em_adapt_torch.config import MeshConfig
from em_adapt_torch.device import resolve_device

#: Seconds a rendezvous or a collective may wait for the other processes
#: before it raises (``train --dist-timeout``).
DEFAULT_TIMEOUT = 1800.0

#: Parameter leaves sharded over the ``model`` axis, (layer, leaf) -> the
#: dimension split in the JAX package's HWIO layout
#: (``em_adapt_tpu/parallel/mesh.py::TP_RULES``): fc6 column-parallel
#: (its output channels and bias), fc7 row-parallel (its input channels);
#: fc7's bias and fc8 stay whole on every rank.
TP_RULES: dict[tuple[str, str], int] = {
    ("fc6", "w"): 3,  # [kh,kw,cin,cout] -> split cout (column parallel)
    ("fc6", "b"): 0,
    ("fc7", "w"): 2,  # [1,1,cin,cout]  -> split cin  (row parallel)
}


def resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> dict[str, int]:
    """Concrete axis sizes for ``n_devices``: an axis of -1 takes what the
    fixed axes leave; raises when that does not divide, or when more than
    one axis is -1 (``em_adapt_tpu/parallel/mesh.py::resolve_axis_sizes``)."""
    sizes = dict(cfg.axes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wild} in {cfg.axes}")
    fixed = int(np.prod([s for s in sizes.values() if s != -1])) or 1
    for k, v in sizes.items():
        if v == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[k] = n_devices // fixed
    return sizes


def data_axis_size(cfg: MeshConfig, world_size: int) -> int:
    """The data axis of ``cfg`` over ``world_size`` processes; raises unless
    the axes use exactly that many (one card a process)."""
    sizes = resolve_axis_sizes(cfg, world_size)
    total = int(np.prod(list(sizes.values())))
    if total != world_size:
        raise ValueError(f"mesh axes {sizes} use {total} devices, have {world_size} processes")
    return sizes[cfg.data_axis]


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the process group that :func:`init_world`
    joined: ``rank`` of ``size``, its ``local_rank`` on its host, and the
    ``device`` it trains on."""

    rank: int
    size: int
    local_rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Wait until every process has come here (a host all-reduce)."""
        dist.all_reduce(torch.zeros(1))

    def broadcast(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a float64 on the host)."""
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.broadcast(t, 0)
        return float(t.item())

    def sum_host(self, array: np.ndarray, plan: "MeshPlan") -> np.ndarray:
        """The elementwise sum of an integer host array (an int64
        all-reduce: exact for any count) over ``plan``'s ``ddp`` group (the
        data × space ranks of this rank's model index), where a model
        replica enters once."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
        if plan.ddp_size > 1:
            dist.all_reduce(t, group=plan.ddp_group)
        return t.numpy()

    def check_same(self, value: int, what: str) -> None:
        """Raise unless every rank passes the same ``value`` (a max over the
        world, which replicas do not change)."""
        t = torch.tensor([value, -value], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if t[0] != -t[1]:
            raise RuntimeError(f"the ranks disagree on {what}: from {int(-t[1])} to {int(t[0])}")

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _init_method(coordinator: str | None) -> str:
    """'HOST:PORT' -> a TCP rendezvous; a ``file://`` URL (a FileStore, for
    processes of one host) passes as it is; None -> torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``)."""
    if coordinator is None:
        return "env://"
    if coordinator.startswith("file://"):
        return coordinator
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {coordinator!r}: expected HOST:PORT or file://PATH")
    return f"tcp://{host}:{port}"


def init_world(
    device: str | torch.device | None = None,
    *,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "auto",
    timeout: float = DEFAULT_TIMEOUT,
) -> World:
    """Join the process group and return this process's :class:`World`.

    With ``coordinator`` (``train --coordinator HOST:PORT --num-processes N
    --process-id I``) the rank and size are the arguments; without it they
    come from torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and
    the rendezvous from ``MASTER_ADDR``/``MASTER_PORT``). The device is
    ``device`` when it names one with its index (``cuda:0``, ``cpu``);
    otherwise ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaulting to the rank
    modulo the cards), made the current card before anything is built on
    it. ``backend``: "auto" is gloo on the CPU and NCCL for CUDA tensors
    with gloo for host tensors on a card; "gloo" is gloo for both (two
    processes on one card, which NCCL refuses). A process that cannot
    reach the others within ``timeout`` seconds raises; it never trains
    alone."""
    if dist.is_initialized():
        raise RuntimeError("init_world: this process has already joined a process group")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        rank, size = int(process_id), int(num_processes)
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--multihost without --coordinator needs torchrun's environment; missing "
                f"{', '.join(missing)}")
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if not 0 <= rank < size:
        raise ValueError(f"process id {rank} not in [0, {size})")
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == "cuda" and dev.index is None):
        if not torch.cuda.is_available():
            resolve_device(dev)  # raises: no card, and the CPU was not asked for
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        # Before any model, generator or kernel library is made: they take
        # the current card (device.py::resolve_device).
        torch.cuda.set_device(dev)
    if backend not in ("auto", "gloo"):
        raise ValueError(f"backend={backend!r}: expected 'auto' or 'gloo'")
    group_backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" and backend == "auto" else "gloo"
    dist.init_process_group(group_backend, init_method=_init_method(coordinator), rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout))
    return World(rank=rank, size=size, local_rank=local_rank, device=dev)


#: The axes of the plan, in the names that :class:`MeshPlan` uses.
AXES = ("data", "space", "model")


def mesh_layout(cfg: MeshConfig, world_size: int, rank: int) -> tuple[dict[str, int],
                                                                      dict[str, int]]:
    """({axis: size}, {axis: this rank's coordinate}) over ``AXES`` for
    ``world_size`` processes: ``cfg.axes`` resolved (raising unless they
    use exactly the world) and ``rank`` unravelled row-major in their
    order, as ``em_adapt_tpu/parallel/mesh.py::make_mesh`` reshapes the
    devices; an axis that ``cfg`` leaves out has size 1."""
    data_axis_size(cfg, world_size)
    sizes = resolve_axis_sizes(cfg, world_size)
    canon = {cfg.data_axis: "data", cfg.space_axis: "space", "model": "model"}
    names = list(sizes)
    coords = np.unravel_index(rank, [sizes[n] for n in names]) if names else ()
    out_sizes = {a: 1 for a in AXES}
    out_coords = {a: 0 for a in AXES}
    for name, c in zip(names, coords):
        out_sizes[canon[name]] = sizes[name]
        out_coords[canon[name]] = int(c)
    return out_sizes, out_coords


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """This rank's place in the mesh: ``sizes`` and ``coords`` over
    :data:`AXES`, and ``groups``, the process group of each axis line
    through this rank and of ``ddp`` (None where it is the whole world;
    an axis line of this rank alone has none, the ``ddp`` line has one). The JAX package's
    ``MeshPlan`` names: ``num_data_shards``, ``num_space_shards``,
    ``num_model_shards``. ``MeshPlan()`` is one process."""

    sizes: dict = dataclasses.field(default_factory=lambda: {a: 1 for a in AXES})
    coords: dict = dataclasses.field(default_factory=lambda: {a: 0 for a in AXES})
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def num_data_shards(self) -> int:
        return self.sizes["data"]

    @property
    def num_space_shards(self) -> int:
        return self.sizes["space"]

    @property
    def num_model_shards(self) -> int:
        return self.sizes["model"]

    @property
    def data_index(self) -> int:
        return self.coords["data"]

    @property
    def space_index(self) -> int:
        return self.coords["space"]

    @property
    def model_index(self) -> int:
        return self.coords["model"]

    @property
    def ddp_size(self) -> int:
        """The ranks of one model replica's data-parallel average: data × space."""
        return self.sizes["data"] * self.sizes["space"]

    @property
    def space_group(self):
        return self.groups.get("space")

    @property
    def model_group(self):
        return self.groups.get("model")

    @property
    def ddp_group(self):
        return self.groups.get("ddp")


def make_plan(cfg: MeshConfig, world: World | None) -> MeshPlan:
    """The :class:`MeshPlan` of ``world`` laid out by ``cfg``
    (:func:`mesh_layout`); ``MeshPlan()`` without a world. A collective:
    every rank calls it, with the same ``cfg``, since each group is made
    by ``dist.new_group``, which every rank enters in the same order."""
    if world is None:
        return MeshPlan()
    sizes, coords = mesh_layout(cfg, world.size, world.rank)
    every = [mesh_layout(cfg, world.size, r)[1] for r in range(world.size)]
    groups = {}
    for name, axes in (("data", ("data",)), ("space", ("space",)), ("model", ("model",)),
                       ("ddp", ("data", "space"))):
        n = int(np.prod([sizes[a] for a in axes]))
        if n == world.size:
            groups[name] = None  # the default group: the world
            continue
        if n == 1 and name != "ddp":  # DDP takes a group even of this rank alone
            continue
        lines: dict[tuple, list[int]] = {}
        for r, c in enumerate(every):  # the ranks that differ only on ``axes``
            lines.setdefault(tuple(c[a] for a in AXES if a not in axes), []).append(r)
        for key in sorted(lines):  # every rank makes every line's group, in one order
            group = dist.new_group(lines[key])
            if world.rank in lines[key]:
                groups[name] = group
    return MeshPlan(sizes=sizes, coords=coords, groups=groups)


def world_size() -> int:
    """The number of processes of this process's group; 1 outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The max of ``x`` over the whole world's batch, as a [1] float32
    tensor on ``x``'s device (an all-reduce of the local max over the
    world when it has more than one process: replicas of a value over the
    space or model axis leave a max as it is)."""
    m = x.detach().amax().to(torch.float32).reshape(1)
    if world_size() > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m


def all_sum(x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """``x`` summed over ``plan``'s ``ddp`` group, the data × space ranks of
    this rank's model index; ``x`` itself where that group is this rank
    alone. No gradient flows through the sum."""
    if plan.ddp_size == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=plan.ddp_group)
    return out
