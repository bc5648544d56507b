"""The port's collectives over the data-parallel ranks: JAX's ``pmean``,
``psum``, ``psum_scatter`` and ``all_gather`` over ``DP_AXIS``.

Each takes the rank's ``Mesh`` (``parallel/mesh.py``); on a mesh without a
process group (one process) each is the identity. Under NCCL they call
``torch.distributed`` on the card's tensors. gloo reduces and broadcasts
CUDA tensors but does not reduce-scatter or all-gather them, so under gloo
``reduce_scatter`` and ``all_gather`` stage the vector through pinned host
memory: ``reduce_scatter`` all-reduces the whole host copy and keeps the
rank's shard (the same sums a reduce-scatter gives), ``all_gather`` gathers
the host copies of the shards; each copy back to the card is synchronous.
This is the rig of several ranks on one card and of the CPU tests; it checks
what the ranks compute, not NCCL's speed. The rank's log says so once.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.distributed as dist


def _host(t: torch.Tensor, mesh) -> torch.Tensor:
    """A pinned host buffer of ``t``'s size and dtype, kept in the mesh's
    ``staging`` between calls (a CPU tensor is its own host buffer)."""
    if t.device.type == "cpu":
        return t
    if not mesh.staging:
        logging.getLogger("univl_tpu_torch").warning(
            "gloo: reduce-scatter and all-gather of CUDA tensors go through pinned host memory")
    key = (t.numel(), t.dtype)
    if key not in mesh.staging:
        mesh.staging[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
    return mesh.staging[key]


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``psum``: ``t`` summed over the ranks, in place."""
    if mesh.distributed and mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """``pmean``: ``t`` averaged over the ranks, in place (the sum, then one
    division by the rank count)."""
    if mesh.distributed and mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(mesh.size)
    return t


def reduce_scatter(flat: torch.Tensor, mesh, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``psum_scatter(tiled=True)``: rank r's shard, ``flat[r*S:(r+1)*S]``
    summed over the ranks (``S = len(flat) // size``), into ``out``."""
    shard = flat.numel() // mesh.size
    if out is None:
        out = torch.empty(shard, dtype=flat.dtype, device=flat.device)
    if not mesh.distributed:
        return out.copy_(flat)
    if mesh.backend == "nccl":
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM)
        return out
    host = _host(flat, mesh)
    if host is not flat:
        host.copy_(flat)
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    return out.copy_(host[mesh.rank * shard:(mesh.rank + 1) * shard])


def all_gather(shard: torch.Tensor, mesh, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``all_gather(tiled=True)``: every rank's shard, in rank order, into
    ``out`` (``size`` times the shard's length)."""
    if out is None:
        out = torch.empty(shard.numel() * mesh.size, dtype=shard.dtype, device=shard.device)
    if not mesh.distributed:
        return out.copy_(shard)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, shard)
        return out
    host_out = _host(out, mesh)
    dist.all_gather(list(host_out.chunk(mesh.size)), shard.cpu())
    if host_out is not out:
        out.copy_(host_out)
    return out
