"""The ('data', 'model') mesh over processes: the port of ``rectpu/parallel/mesh.py``.

rectpu runs one program over a mesh of devices (GSPMD and ``shard_map``).
The port runs one process per rank and one device per process, as rectpu's
own multi-process tests run it (``tests/mp_worker.py``, one local device a
process). Rank ``r`` sits at mesh position ``(d, m) = (r // M, r % M)``: the
row-major order of rectpu's ``np.asarray(devices).reshape(num_data,
num_model)`` (``mesh.py:23-33``), so a rank holds the batch slice and the
table rows that rectpu gives the device at that position.

Each axis is an ``Axis``: a process subgroup (every rank creates every group,
in one order) with this rank's index in it. The collectives of
``parallel/collectives.py`` run over an axis.

Backends, chosen here and nowhere else: Gloo for CPU tensors; on CUDA, NCCL
where the machine has a card for every local rank, else Gloo with every rank
on the one card. The port hands Gloo CUDA tensors for every collective it
runs (``chip_smoke.py`` phase 8 runs them all on an NVIDIA H100 with torch
2.11.0+cu128); PyTorch's Gloo process group copies each CUDA payload into
host memory, runs the collective there and copies the result back, so every
collective crosses host memory twice. The compute stays on the card.

``distributed_init`` is the counterpart of rectpu's ``mesh.py:36-48``: it
starts the default process group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
explicit arguments, and does nothing for a world of one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: the process ``group`` (None for
    an axis of one rank, which runs no collective), its ``size``, this rank's
    ``index`` in it and the global ``ranks`` of the group in order."""

    name: str
    group: object
    size: int
    index: int
    ranks: tuple


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``num_data x num_model`` mesh."""

    num_data: int
    num_model: int
    rank: int
    device: torch.device
    backend: str | None
    data: Axis
    model: Axis
    world: Axis

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.num_data, MODEL_AXIS: self.num_model}

    @property
    def coords(self) -> tuple[int, int]:
        return self.rank // self.num_model, self.rank % self.num_model

    def axis(self, name: str) -> Axis:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}[name]


def choose_backend(device: torch.device, local_world: int) -> str:
    """"nccl" where every local rank has its own card, else "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device, local_rank: int, local_world: int) -> torch.device:
    """The device of a rank: the CPU, or the rank's own card where the
    machine has one for every local rank, else card 0 for all."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank)
    return torch.device("cuda", 0)


def distributed_init(device: str | torch.device = "cuda", init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> bool:
    """Start the default process group (the multi-process bootstrap that
    replaces TF_CONFIG). Reads torchrun's environment for what is not given;
    ``init_method`` defaults to ``env://``. Returns whether a group of more
    than one rank is up; a world of one starts nothing. The backend is
    ``choose_backend``'s."""
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank, local_world)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def _axis(name, groups, ranks_of, rank) -> Axis:
    for ranks, group in groups:
        if rank in ranks:
            return Axis(name, group if len(ranks) > 1 else None, len(ranks),
                        ranks.index(rank), tuple(ranks))
    raise AssertionError(f"rank {rank} is in no {name} group of {ranks_of}")


def make_mesh(num_data: int, num_model: int = 1, device: str | torch.device = "cpu") -> Mesh:
    """This process's view of a ('data', 'model') mesh over the default
    process group, or of a 1x1 mesh when no group is up. Raises when the
    world size differs from ``num_data * num_model``. ``device`` is the
    device type; the rank's own device follows ``rank_device``."""
    need = num_data * num_model
    if num_data < 1 or num_model < 1:
        raise ValueError(f"mesh ({num_data}x{num_model}) needs positive axes")
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(f"mesh ({num_data}x{num_model}) needs {need} processes, but "
                             "no process group is up (launch with torchrun, or call "
                             "distributed_init)")
        dev = torch.device(device)
        one = Axis(DATA_AXIS, None, 1, 0, (0,))
        return Mesh(1, 1, 0, dev, None, one, Axis(MODEL_AXIS, None, 1, 0, (0,)),
                    Axis("world", None, 1, 0, (0,)))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != need:
        raise ValueError(f"mesh ({num_data}x{num_model}) needs {need} processes, the "
                         f"process group has {world}")
    backend = dist.get_backend()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank, local_world)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group needs a CUDA device")
    # every rank creates every group, in the same order
    data_groups = [[d * num_model + m for d in range(num_data)] for m in range(num_model)]
    model_groups = [[d * num_model + m for m in range(num_model)] for d in range(num_data)]
    made = {}
    for ranks in data_groups + model_groups:
        key = tuple(ranks)
        if key not in made:
            made[key] = dist.new_group(ranks) if 1 < len(ranks) < world else None
    whole = tuple(range(world))
    made[whole] = dist.group.WORLD

    def group_of(ranks):
        return made[tuple(ranks)]

    data = _axis(DATA_AXIS, [(r, group_of(r)) for r in data_groups], data_groups, rank)
    model = _axis(MODEL_AXIS, [(r, group_of(r)) for r in model_groups], model_groups, rank)
    world_axis = Axis("world", dist.group.WORLD, world, rank, whole)
    return Mesh(num_data, num_model, rank, dev, backend, data, model, world_axis)
