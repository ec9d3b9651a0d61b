"""Joining a process group and feeding each rank its rays (port of
``vf_nerf_tpu/parallel/multihost.py``).

The reference imports ``torch.distributed`` and never initializes it
(``train/vector_field_nerf_train.py:10-11``). Here every rank runs the same
program on one device: ``initialize_multihost`` wires the ranks over
``torch.distributed`` (NCCL for CUDA, gloo for the CPU), every rank builds
the same global batch from the shared seed and trains on its
``local_ray_slice``; ``parallel/mesh.py`` holds the reductions that make the
sharded step the one-process step.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)
_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def env_cluster() -> bool:
    """Whether the environment describes a cluster (``torchrun``'s
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)."""
    return all(k in os.environ for k in _ENV_KEYS)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda",
                         timeout_s: float = 1800.0) -> bool:
    """Join the process group; True iff it has more than one rank.

    ``coordinator_address`` (``host:port``, ``tcp://host:port`` or
    ``file:///path``) with ``num_processes`` and ``process_id`` asks for a
    cluster explicitly; otherwise the environment's (``torchrun``) is
    joined. A cluster that was asked for and fails to come up raises: a
    misconfiguration must not degrade to one process. With no cluster in
    the environment this logs a warning and returns False."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    backend = backend or default_backend(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit cluster needs num_processes and "
                             "process_id")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        return dist.get_world_size() > 1
    if env_cluster():
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return dist.get_world_size() > 1
    log.warning("no cluster in the environment (%s unset); continuing in "
                "one process", ", ".join(_ENV_KEYS))
    return False


def local_device(platform: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (the rank modulo the local
    card count without it), or the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def local_ray_slice(n_global: int, rank: Optional[int] = None,
                    world: Optional[int] = None) -> slice:
    """This rank's contiguous slice of a global ray axis of ``n_global``
    rays (a multiple of the rank count: the runners trim the batch to one).

    Every rank assembles the same global batch from the shared seed and
    must train on its own slice only, or the global batch holds each ray
    once per rank."""
    if rank is None or world is None:
        rank, world = (dist.get_rank(), dist.get_world_size()) \
            if dist.is_initialized() else (0, 1)
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def global_mesh(device) -> List[torch.device]:
    """Every rank's device, in rank order (``device``: this rank's)."""
    if not dist.is_initialized():
        return [torch.device(device)]
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(torch.device(device)))
    return [torch.device(n) for n in names]


def check_world(requested: int) -> Tuple[int, int]:
    """(rank, rank count) of the process group, or (0, 1) without one.
    ``requested`` is a config's ``num_devices`` as written: 0 takes the
    group's ranks, or this process's one device without a group (only
    ``launch`` reads 0 as every local card). Raises if it is set above 1
    and no group is up: one process trains on one device."""
    rank, size = (dist.get_rank(), dist.get_world_size()) \
        if dist.is_initialized() else (0, 1)
    if size == 1 and requested > 1:
        raise RuntimeError(
            f"num_devices asks for {requested} ranks but this process has "
            "no process group: train through `python -m "
            "vf_nerf_torch.train.exp_runner`, which starts one process per "
            "device, or under torchrun")
    return rank, size


def broadcast_from_rank0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def launch(fn: Callable, args: tuple, platform: str, requested: int
           ) -> None:
    """A command line's run of ``fn(*args)``: in the environment's cluster
    (``torchrun``) when there is one, else in ``requested`` spawned ranks
    when that is more than one, else here."""
    if env_cluster():
        device = local_device(platform)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize_multihost(device=device)
    elif requested > 1:
        spawn(fn, requested, platform, args)
        return
    fn(*args)


def spawn(fn: Callable, nprocs: int, platform: str, args: tuple = (),
          backend: Optional[str] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes, rank r on
    ``local_device(platform)`` with ``LOCAL_RANK`` r, joined through a
    file store in a fresh temporary directory (no TCP port). On CUDA the
    kernels are built first, here, so that the ranks load one library. A
    rank that fails makes this raise (``torch.multiprocessing``'s
    ``ProcessRaisedException``); ``fn`` must be importable by name."""
    if platform != "cpu":
        from vf_nerf_torch.kernels import load_library
        load_library()
    store_dir = tempfile.mkdtemp(prefix="vf_nerf_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=nprocs, join=True,
            args=(nprocs, platform, backend,
                  f"file://{os.path.join(store_dir, 'store')}", fn, args))
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank_main(rank: int, nprocs: int, platform: str,
               backend: Optional[str], store: str, fn: Callable,
               args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    device = local_device(platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_multihost(store, nprocs, rank, backend=backend, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()
