"""Data parallelism over ``torch.distributed`` (port of
``vf_nerf_tpu/parallel/mesh.py``; reference single-process
``nn.DataParallel``, ``models/nerf/vector_field_nerf.py:70-75``).

The JAX package shards the ray axis of a batch over a 1-D device mesh and
replicates the state; GSPMD then reduces every mean, masked count and
train-mode BatchNorm statistic over the *global* batch and inserts the
gradient all-reduce. Here the unit is one process per device (a rank):
NCCL for CUDA tensors, gloo on the CPU (``multihost.py`` joins the group).
Every rank holds the same state and draws the same global batch, takes its
contiguous slice of the ray axis, and reduces what the global step reduces:

- counts (``global_sum``, detached: masks carry no gradient) and maxima
  (``global_max``);
- train-mode BatchNorm's row sums through ``all_reduce_sum``, an autograd
  function whose backward and forward-mode (``jvp``) rules are the same
  all-reduce, so ``torch.func.jvp`` in ``networks.vf_jacobian`` and the
  reverse pass through it both go across the ranks;
- after the backward, every gradient in one flat all-reduce sum
  (``all_reduce_flat``). Each rank's loss is its numerator over the global
  count, so the sum over ranks is the one-process loss and the summed
  gradients are its gradients; the clip and Adam then run alike on every
  rank and the replicas stay equal without a broadcast.

``sharded()`` (more than one rank) switches the loss and BatchNorm to
these reductions; at one rank they keep the one-process arithmetic, bit for
bit. ``distributed()`` (a process group, of any size) runs the collectives
that are identities at one rank: the gradient and metric all-reduces.

Inside one process, a list of local devices (``make_mesh``) serves the
eval render and the octant spread, as the JAX package's single-process
mesh does (``VectorFieldNerf.enable_mesh_eval``,
``DeviceMeshExtractor.extract_many``).
"""

from __future__ import annotations

import copy
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


def indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(num_devices: int = 0,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The first ``num_devices`` (0: all) of ``devices``, or of this
    process's CUDA devices."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [indexed(d) for d in devices]
    if num_devices and num_devices > 0:
        devs = devs[:num_devices]
    if not devs:
        raise RuntimeError("no CUDA device for the mesh; pass devices=[...] "
                           "(e.g. ['cpu', 'cpu']) to build one on the CPU")
    return devs


def on_stream_of(device: torch.device, home, fn):
    """``fn()`` in a device slot's worker thread: off CUDA as it is; on
    CUDA with ``device`` current and a new stream of it that first waits
    for ``home`` (the caller's stream, whose work ``fn`` reads), finished
    before the return."""
    if device.type != "cuda":
        return fn()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(home)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = fn()
    stream.synchronize()
    return out


def trim_to_multiple(n: int, devices: int) -> int:
    """Largest multiple of ``devices`` ≤ n (the JAX runners' trim)."""
    return (n // devices) * devices


def world() -> Tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed() -> bool:
    """A process group is up (of any size)."""
    return dist.is_available() and dist.is_initialized()


def sharded() -> bool:
    """More than one rank shares each batch."""
    return world()[1] > 1


def shard_rows(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s contiguous rows of an axis of ``n`` rows over
    ``size`` ranks; the first ``n % size`` ranks take one row more
    (``np.array_split``'s split). For ``n`` a multiple of ``size`` it is
    ``multihost.local_ray_slice``."""
    per, extra = divmod(n, size)
    start = rank * per + min(rank, extra)
    return slice(start, start + per + (1 if rank < extra else 0))


def replicate(module: nn.Module, devices: Iterable) -> List[nn.Module]:
    """One copy of ``module`` per device, its parameters and buffers
    included (the module itself on its own device); ``load_state_dict``
    refreshes a copy."""
    home = indexed(next(module.parameters()).device)
    return [module if indexed(dev) == home
            else copy.deepcopy(module).to(indexed(dev)) for dev in devices]


class _AllReduceSum(torch.autograd.Function):
    """``y = Σ_ranks x`` on every rank. Its backward sums the cotangents
    (each rank's loss reads y) and its forward-mode rule sums the
    tangents."""

    @staticmethod
    def forward(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)

    @staticmethod
    def jvp(ctx, tangent):
        return _AllReduceSum.apply(tangent)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, on the autograd graph (``x`` itself at one
    rank)."""
    return _AllReduceSum.apply(x) if sharded() else x


@torch.no_grad()
def global_sum(x) -> torch.Tensor:
    """The sum over ranks of a count, detached (``x`` at one rank)."""
    if not sharded():
        return x
    y = torch.as_tensor(x).detach().clone()
    dist.all_reduce(y)
    return y


@torch.no_grad()
def global_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum over ranks, detached (``x`` at one rank)."""
    if not sharded():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def global_mean(values: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch: its sum over
    the global element count (``torch.mean`` at one rank)."""
    if not sharded():
        return torch.mean(values)
    count = global_sum(torch.full((), float(values.numel()),
                                  device=values.device))
    return torch.sum(values) / count


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over the ranks in place, through one flat buffer
    (one collective per call)."""
    if not distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
