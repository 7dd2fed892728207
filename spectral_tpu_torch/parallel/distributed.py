"""Multi-process runtime (the port of ``spectral_tpu.parallel.distributed``).

Every process runs the same program; ``initialize`` joins them into one
``torch.distributed`` process group, and the row-sharded render works
unchanged over the global mesh (``parallel/mesh.py``): rows are pixel
disjoint, so a frame needs no collective. Only the framebuffer fetch
(``fetch_global``, an all-gather once per save or preview) and a sharded
persist render's one MIN per launch cross processes.

The collective backend follows one rule: NCCL where each process has a
card of its own, gloo on the CPU or where processes share a card (NCCL
refuses two ranks on one GPU). Nothing switches backend after a failure.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def choose_backend(device: str, num_processes: int) -> str:
    """``"nccl"`` when the processes render on the card and each has one of
    its own (the host's cards at least the processes of this host),
    ``"gloo"`` on the CPU or where processes share a card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "distributed rendering on device='cuda' needs a CUDA GPU and "
            "torch.cuda.is_available() is False; pass device='cpu'"
        )
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
) -> str:
    """Join this process into the process group and return its backend.

    Arguments left None come from the variables torchrun sets:
    ``MASTER_ADDR:MASTER_PORT`` for the coordinator, ``WORLD_SIZE`` and
    ``RANK`` (the reference reads ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``). Call it before any
    device use. The backend is ``choose_backend``'s; a process that
    renders on the card takes card ``LOCAL_RANK`` (torchrun's; else
    ``process_id``) modulo the host's cards as its current device."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "no coordinator: pass HOST:PORT or set MASTER_ADDR and MASTER_PORT"
            )
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    backend = choose_backend(device, num_processes)
    if torch.device(device).type == "cuda":
        lr = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(lr % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return backend


def is_multiprocess() -> bool:
    return world_size() > 1


def in_group() -> bool:
    """Whether this process joined a process group (of any size): the
    collectives below then run over it, even for one process."""
    d = torch.distributed
    return d.is_available() and d.is_initialized()


def world_size() -> int:
    return torch.distributed.get_world_size() if in_group() else 1


def rank() -> int:
    return torch.distributed.get_rank() if in_group() else 0


def is_primary() -> bool:
    """True on the process that owns logging and image export."""
    return rank() == 0


def backend() -> str | None:
    return torch.distributed.get_backend() if in_group() else None


def collective_device() -> torch.device:
    """Where this process's collectives take their tensors: its current
    card under NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fetch_global(slabs) -> np.ndarray:
    """This process's row slabs (a tensor, or a list of tensors in slot
    order) joined with every other process's into the full array on
    every process: an all-gather in rank order, like the reference's
    ``process_allgather(tiled=True)``. The mesh splits the slots evenly
    among ranks in rank order, so every process holds the same number
    of rows."""
    if torch.is_tensor(slabs):
        slabs = [slabs]
    if not in_group():
        return torch.cat([s.cpu() for s in slabs]).numpy()
    dev = collective_device()
    local = torch.cat([s.to(dev) for s in slabs]).contiguous()
    parts = [torch.empty_like(local) for _ in range(world_size())]
    torch.distributed.all_gather(parts, local)
    return torch.cat(parts).cpu().numpy()


def _all_reduce(values, op) -> list:
    if not in_group():
        return list(values)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=collective_device())
    torch.distributed.all_reduce(t, op=op)
    return t.cpu().tolist()


def all_min(values) -> list:
    """The elementwise minimum over every process of a short list of
    numbers (one ``all_reduce(MIN)``; the list itself outside a group)."""
    return _all_reduce(values, torch.distributed.ReduceOp.MIN)


def all_sum(values) -> list:
    """The elementwise sum over every process of a short list of numbers
    (one ``all_reduce(SUM)``; the list itself outside a group)."""
    return _all_reduce(values, torch.distributed.ReduceOp.SUM)


def env_configured() -> bool:
    """True when torchrun's multi-process variables are set."""
    return all(k in os.environ for k in _ENV)


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if in_group():
        torch.distributed.destroy_process_group()
