"""Row meshes (the port of ``spectral_tpu.parallel.mesh``).

The reference's only parallelism is one thread-pool task per image row
(reference ``src/main.rs:1280-1322``); the JAX package's is data
parallelism over pixel rows on a 1D device mesh. Here a mesh is an
ordered tuple of row slots, each with an explicit ``torch.device`` and
the rank of the process that owns it: slot ``i`` renders the ``i``-th
slab of ``height / size`` rows.

* In one process on the CPU, ``make_mesh(8, device="cpu")`` has 8 slots
  on ``cpu`` (the twin of the reference's 8 virtual devices).
* On the card, a process's slots go to its GPUs round-robin, so one
  H100 holds ``make_mesh(4)``. A process of a multi-process group has
  one GPU: its current device (``distributed.initialize`` sets it).
* Across processes the slots split evenly among the ranks in rank
  order: ``make_mesh(8)`` over 2 processes gives 4 slots to each.

A mesh never mixes the CPU and the card, and it never puts a slot on
the CPU because no card was found: ``device="cuda"`` without CUDA
raises.
"""

from __future__ import annotations

import dataclasses

import torch

from spectral_tpu_torch.parallel import distributed

ROW_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class Slot:
    index: int  # the slot's place on the row axis
    device: torch.device
    rank: int  # the process that renders it


@dataclasses.dataclass(frozen=True)
class Mesh:
    slots: tuple[Slot, ...]

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def device_type(self) -> str:
        return self.slots[0].device.type

    def local_slots(self) -> tuple[Slot, ...]:
        """This process's slots, in row order."""
        r = distributed.rank()
        return tuple(s for s in self.slots if s.rank == r)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """``[H, W, ...]`` framebuffers split on the row axis over ``mesh``."""

    mesh: Mesh


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A full copy of a tensor on every slot's device."""

    mesh: Mesh


def process_devices(device: str = "cuda") -> list[torch.device]:
    """The devices this process renders on: ``cpu``; or the card, all of
    them in one process and the current one in a process group."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device='cuda') needs a CUDA GPU and "
            "torch.cuda.is_available() is False; pass device='cpu'"
        )
    if distributed.is_multiprocess():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, device: str = "cuda") -> Mesh:
    """A 1D mesh of ``n_devices`` row slots (default: one per device of
    every process), split evenly among the processes in rank order, each
    process's slots on its devices round-robin."""
    devices = process_devices(device)
    world = distributed.world_size()
    if n_devices is None:
        n_devices = world * len(devices)
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n_devices}")
    if n_devices % world:
        raise ValueError(
            f"{n_devices} mesh slots do not split evenly over {world} processes"
        )
    per = n_devices // world
    me = distributed.rank()
    slots = []
    for i in range(n_devices):
        owner, j = divmod(i, per)
        # another process's slot is named by its kind only: its device
        # index is that process's business
        dev = devices[j % len(devices)] if owner == me else torch.device(devices[0].type)
        slots.append(Slot(i, dev, owner))
    return Mesh(tuple(slots))


def row_sharding(mesh: Mesh) -> RowSharding:
    """Sharding for ``[H, W, ...]`` framebuffers: split the row axis."""
    return RowSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
