"""Data-parallel training over processes: one process per card.

The counterpart of the data axis of ``em_adapt_tpu/parallel/mesh.py``.
The JAX package builds one mesh over every device and lets XLA insert the
gradient psum; here each process drives one card (or the CPU), joins a
``torch.distributed`` process group, and the model is wrapped in
``DistributedDataParallel``: NCCL carries CUDA tensors between cards and
gloo carries host tensors (``backend="cpu:gloo,cuda:nccl"``, one group for
both); on the CPU, or where NCCL cannot run (two processes on one card),
the group is gloo alone.

:func:`init_world` joins the group and returns the :class:`World`: the
rank, the world size, the local rank and the device. The few links
between images that the training step has are taken over the world here:
the E-step's batch max (:func:`global_max`), the semi-supervised loss's
valid-pixel count and the logged loss (:func:`all_sum`). Host-side
agreements (a barrier, a broadcast of rank 0's value, the sum of eval's
integer confusion matrices) go through gloo on host tensors, so they
never wait behind the card's queue.

The ``space`` axis (spatial partitioning) and the ``model`` axis (tensor
parallelism of fc6/fc7) are not ported: ROADMAP.md Queue 1 items 11c and
11b (``config.py::check_mesh`` raises for them).
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

    def sum_host(self, array: np.ndarray) -> np.ndarray:
        """The elementwise sum over the world of an integer host array (an
        int64 all-reduce: exact for any count)."""
        t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
        dist.all_reduce(t)
        return t.numpy()

    def check_same(self, value: int, what: str) -> None:
        """Raise unless every rank passes the same ``value``."""
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


def current_shard() -> tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The max of ``x`` over the whole world's batch, as a [1] float32
    tensor on ``x``'s device (an all-reduce of the local max when the world
    has more than one process)."""
    m = x.detach().amax().to(torch.float32).reshape(1)
    if current_shard()[1] > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the world (``x`` itself in a world of one); no
    gradient flows through the sum."""
    if current_shard()[1] == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out
