"""The port's collectives: JAX's ``pmean``, ``psum``, ``psum_scatter`` and
``all_gather`` over an axis of the mesh, and the tensor-parallel operators of
Megatron as autograd functions.

Each takes a ``Mesh`` (``parallel/mesh.py``) or one of its axis views
(``mesh.axis(DP_AXIS)``, ``mesh.axis(TP_AXIS)``), whose ``group`` it runs
over; on a mesh without a process group (one process) each is the identity.
Under NCCL they call ``torch.distributed`` on the card's tensors. gloo
reduces and broadcasts CUDA tensors but does not reduce-scatter or
all-gather them, so under gloo ``reduce_scatter`` and ``all_gather`` stage
the vector through pinned host memory: ``reduce_scatter`` all-reduces the
whole host copy and keeps the rank's shard (the same sums a reduce-scatter
gives), ``all_gather`` gathers the host copies of the shards; each copy back
to the card is synchronous. Under gloo a bf16 tensor goes through f32 (exact
for a gather; a sum rounded once). This is the rig of several ranks on one
card and of the CPU tests; it checks what the ranks compute, not NCCL's
speed. The rank's log says so once.

The tensor-parallel operators (Megatron, arXiv:1909.08053 and 2205.05198),
each over the tp view:
  - ``copy_to_tp``: identity forward, all-reduce backward: the input of a
    column-parallel product, whose gradient each rank holds a part of;
  - ``reduce_from_tp``: all-reduce forward, identity backward: the output of
    a row-parallel product, and the vocab-parallel lookup;
  - under sequence parallelism, in their place, ``gather_rows`` (all-gather
    of the rows forward, reduce-scatter backward) and ``scatter_rows``
    (reduce-scatter forward, all-gather backward);
  - ``split_rows`` and ``join_rows``: a region's entry and exit (the rank's
    rows of a replicated tensor forward, the gather backward; and the
    reverse), around the sequence-parallel stack.
Rows are the leading dim, split in equal contiguous shares, rank r's share r.
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


def _active(mesh) -> bool:
    return mesh.distributed and mesh.size > 1


def _gloo_dtype(t: torch.Tensor) -> torch.Tensor:
    """gloo's operand: bf16 widened to f32."""
    return t.float() if t.dtype == torch.bfloat16 else t


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``psum``: ``t`` summed over the ranks, in place."""
    if _active(mesh):
        if mesh.backend == "gloo" and t.dtype == torch.bfloat16:
            wide = t.float()
            dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=mesh.group)
            t.copy_(wide)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """``pmax``: the element-wise maximum over the ranks, in place."""
    if _active(mesh):
        wide = _gloo_dtype(t) if mesh.backend == "gloo" else t
        dist.all_reduce(wide, op=dist.ReduceOp.MAX, group=mesh.group)
        if wide is not t:
            t.copy_(wide)
    return t


def all_reduce_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """``pmean``: ``t`` averaged over the ranks, in place (the sum, then one
    division by the rank count)."""
    if _active(mesh):
        all_reduce_sum(t, mesh)
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
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=mesh.group)
        return out
    wide = _gloo_dtype(flat)
    host = _host(wide, mesh)
    if host is not wide:
        host.copy_(wide)
    elif host is flat:
        host = flat.clone()  # a CPU operand: the reduction must not overwrite it
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.copy_(host[mesh.rank * shard:(mesh.rank + 1) * shard])


def all_gather(shard: torch.Tensor, mesh, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``all_gather(tiled=True)``: every rank's shard, in rank order, into
    ``out`` (``size`` times the shard's length)."""
    if out is None:
        out = torch.empty(shard.numel() * mesh.size, dtype=shard.dtype, device=shard.device)
    if not mesh.distributed:
        return out.copy_(shard.reshape(-1))
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, shard.contiguous(), group=mesh.group)
        return out
    wide_out = _gloo_dtype(out) if out.dtype == torch.bfloat16 else out
    host_out = _host(wide_out, mesh)
    dist.all_gather(list(host_out.chunk(mesh.size)), _gloo_dtype(shard).reshape(-1).cpu(),
                    group=mesh.group)
    if host_out is not out:
        out.copy_(host_out)
    return out


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` ([n, ...]) in rank order: [size * n, ...]."""
    if not _active(mesh):
        return t
    t = t.contiguous()
    return all_gather(t, mesh).view(t.shape[0] * mesh.size, *t.shape[1:])


def scatter_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's share of the rows of ``t`` ([size * n, ...]) summed over
    the ranks: [n, ...]."""
    if not _active(mesh):
        return t
    n = check_rows(t.shape[0], mesh)
    t = t.contiguous()
    return reduce_scatter(t.view(-1), mesh).view(n, *t.shape[1:])


def check_rows(rows: int, mesh) -> int:
    """The rows a rank holds of ``rows``: an equal share, or an error."""
    if rows % mesh.size:
        raise ValueError(f"sequence parallelism splits the {rows} rows of a block equally over "
                         f"{mesh.size} tensor-parallel ranks: give batch and lengths whose "
                         f"product the rank count divides")
    return rows // mesh.size


def local_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's share of the rows of a replicated ``t``."""
    n = check_rows(t.shape[0], mesh)
    return t[mesh.rank * n:(mesh.rank + 1) * n]


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.mesh), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(g, ctx.mesh), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return scatter_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.mesh), None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return local_rows(x, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.mesh), None


class _JoinRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_rows(g, ctx.mesh).contiguous(), None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTp.apply(x, mesh) if _active(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTp.apply(x, mesh) if _active(mesh) else x


def gather_rows_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherRows.apply(x, mesh) if _active(mesh) else x


def scatter_rows_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ScatterRows.apply(x, mesh) if _active(mesh) else x


def split_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SplitRows.apply(x, mesh) if _active(mesh) else x


def join_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    return _JoinRows.apply(x, mesh) if _active(mesh) else x
