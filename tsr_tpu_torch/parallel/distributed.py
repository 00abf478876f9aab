"""Multi-process initialization and data sharding helpers.

Port of ``tsr_tpu/parallel/distributed.py``. JAX joins processes with
``jax.distributed.initialize`` and feeds a global array from each
process's rows; here each process is one rank of a ``torch.distributed``
group on ``env://`` (torchrun's variables, or the arguments) that drives
one device, and the train steps in ``tsr_tpu_torch.train.common`` run
unchanged on each rank's rows once the state is placed on a mesh
(``parallel.mesh.shard_state``).

Backends: NCCL when every rank of the host has a card of its own; gloo on
the CPU and when ranks share a card (NCCL refuses two ranks on one
device). :func:`initialize` says which it took.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# seconds any rendezvous or collective may wait before it fails
TIMEOUT_S = 600.0

_DEVICE: Optional[torch.device] = None


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def rank_placement(device_type: str, local_rank: int, local_world: int
                   ) -> Tuple[str, torch.device]:
    """``(backend, device)`` of a rank: on ``cpu`` gloo; on ``cuda`` the
    card ``local_rank % cards``, with NCCL when the host has a card per
    rank and gloo when ranks share one."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu for the gloo backend on the CPU")
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= local_world else "gloo"
    return backend, torch.device("cuda", local_rank % cards)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda", backend: Optional[str] = None
               ) -> Optional[str]:
    """Join this process to its group: ``init_process_group`` on
    ``env://``. No-op in one process (no arguments and no torchrun
    variables). When the group is already initialized (a caller's own
    torchrun code made it), only the rank's device is recorded and set.

    Arguments default to torchrun's variables: ``coordinator``
    (``"host:port"``) to ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to
    ``WORLD_SIZE``, ``process_id`` to ``RANK``. ``device`` (``"cuda"`` or
    ``"cpu"``) and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` pick the rank's
    device and, unless given, the backend (:func:`rank_placement`).
    Returns the backend, or None for the no-op.
    """
    global _DEVICE
    local_rank = _int_env("LOCAL_RANK")
    local_world = _int_env("LOCAL_WORLD_SIZE")
    if dist.is_initialized():
        _, _DEVICE = rank_placement(
            torch.device(device).type,
            dist.get_rank() if local_rank is None else local_rank,
            dist.get_world_size() if local_world is None else local_world)
        if _DEVICE.type == "cuda":
            torch.cuda.set_device(_DEVICE)
        return dist.get_backend()
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    # `is None` (not `or`): process_id 0, the first rank, is falsy
    n = (num_processes if num_processes is not None
         else _int_env("WORLD_SIZE"))
    pid = process_id if process_id is not None else _int_env("RANK")
    if coordinator is None and n is None:
        return None
    if coordinator is None or n is None or pid is None:
        raise ValueError(
            f"initialize needs a coordinator, a world size and a rank; got "
            f"{coordinator!r}, {n!r}, {pid!r} (set MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK, or pass them)")
    addr, _, port = coordinator.rpartition(":")
    os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = addr, port
    chosen, dev = rank_placement(
        torch.device(device).type,
        pid if local_rank is None else local_rank,
        n if local_world is None else local_world)
    backend = backend or chosen
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **({"device_id": dev} if backend == "nccl" else {}))
    _DEVICE = dev
    return backend


def shutdown() -> None:
    """Leave the group (no-op when none was joined)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def rank_device() -> torch.device:
    """The device :func:`initialize` gave this rank. Raises when none was
    recorded: the CPU is never taken by default."""
    if _DEVICE is None:
        raise RuntimeError(
            "no device recorded for this rank: call "
            "parallel.distributed.initialize(device=...) first, or pass "
            "device= to parallel.mesh.make_mesh")
    return _DEVICE


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard(indices: np.ndarray, mesh=None) -> np.ndarray:
    """Split a global index set across processes (each rank feeds its own
    slice of the global batch): ``np.array_split`` over the world, or over
    the data axis of ``mesh`` (ranks of one model group feed the same
    rows)."""
    if mesh is not None:
        return np.array_split(indices, mesh.data)[mesh.data_rank]
    return np.array_split(indices, process_count())[process_index()]


def make_global_batch(local_batch, mesh):
    """A batch sharded over ``mesh``'s data axis from each rank's rows, of
    the global shape (``DTensor.from_local`` with ``Shard(0)`` on the data
    axis, replicated on the model axis; the port's counterpart of
    ``jax.make_array_from_process_local_data``). The train steps take it
    and compute on the rank's rows (``.to_local()``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.as_tensor(np.ascontiguousarray(local_batch)
                        if isinstance(local_batch, np.ndarray)
                        else local_batch).to(mesh.device)
    return DTensor.from_local(x, mesh.device_mesh, [Shard(0), Replicate()],
                              run_check=False)
