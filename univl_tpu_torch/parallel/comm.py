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

The pipeline's two operators (``parallel/pp.py``), each over the pp view:
  - ``ring_hop``: JAX's ``lax.ppermute`` with the perm s -> s + 1 (mod S),
    stage s's tensor to stage s + 1; its backward is the inverse hop. Each
    hop posts its send and its receive together (``isend``/``irecv``, then
    both waits), so a ring never deadlocks as blocking sends can on gloo;
    under gloo the bytes go through pinned host memory. A hop also threads a
    scalar ``token`` from the one before it, so the backward runs every
    rank's hops in the reverse of the forward's order, each of them, even
    the hops whose output no stage reads: the ranks' point-to-point calls
    pair up in the backward as in the forward;
  - ``deliver_last``: the last stage's tensor on every stage (JAX's psum
    over a one-hot). Every stage then takes the same loss from its copy, so
    the backward hands the last stage the stages' mean of their gradients
    (JAX's ``shard_map`` transposes a replicated output so), not their sum:
    the sequential loop's gradient, not S times it.
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


def check_batch(batch_size: int, mesh) -> None:
    """The condition of the data-parallel serving classes (JAX's assert):
    ``mesh``'s ranks (None: one process) share a batch equally."""
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} is not a multiple of the mesh's {mesh.size} "
                         f"ranks: each rank encodes an equal share of a batch")


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


def _staged(t: torch.Tensor, mesh, role: str) -> torch.Tensor:
    """A pinned host byte buffer for ``t`` kept in the mesh's ``staging``
    under ``role`` (a send and a receive in flight together need two); a
    CPU tensor's own bytes."""
    if t.device.type == "cpu":
        return t.reshape(-1).view(torch.uint8)
    key = (role, t.numel() * t.element_size())
    if key not in mesh.staging:
        mesh.staging[key] = torch.empty(key[1], dtype=torch.uint8, pin_memory=True)
    return mesh.staging[key]


def exchange(send: torch.Tensor, recv: torch.Tensor, to: int, frm: int, mesh) -> torch.Tensor:
    """Send ``send`` to the group's rank ``to`` and receive ``recv`` from
    rank ``frm``, both posted before either waits. Under gloo the bytes go
    through pinned host memory (exact in every dtype)."""
    group = mesh.group
    dst, src = (dist.get_global_rank(group, r) if group is not None else r for r in (to, frm))
    if mesh.backend == "nccl":
        ops = [dist.P2POp(dist.isend, send.contiguous(), dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv
    send = send.contiguous()
    out, inbox = _staged(send, mesh, "send"), _staged(recv, mesh, "recv")
    if send.device.type != "cpu":
        out.copy_(send.reshape(-1).view(torch.uint8))
    works = [dist.isend(out, dst, group=group), dist.irecv(inbox, src, group=group)]
    for work in works:
        work.wait()
    if recv.device.type != "cpu":
        recv.reshape(-1).view(torch.uint8).copy_(inbox)
    return recv


def broadcast_from(t: torch.Tensor, root: int, mesh) -> torch.Tensor:
    """``t`` of the group's rank ``root`` on every rank, in place (under gloo
    through pinned host memory, as bytes)."""
    if not _active(mesh):
        return t
    src = dist.get_global_rank(mesh.group, root) if mesh.group is not None else root
    if mesh.backend == "nccl":
        dist.broadcast(t, src, group=mesh.group)
        return t
    host = _staged(t, mesh, "broadcast")
    if t.device.type != "cpu" and mesh.rank == root:
        host.copy_(t.reshape(-1).view(torch.uint8))
    dist.broadcast(host, src, group=mesh.group)
    if t.device.type != "cpu":
        t.reshape(-1).view(torch.uint8).copy_(host)
    return t


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, token, mesh):
        ctx.mesh = mesh
        s, n = mesh.rank, mesh.size
        recv = exchange(h, torch.empty_like(h), (s + 1) % n, (s - 1) % n, mesh)
        return recv, token.clone()

    @staticmethod
    def backward(ctx, g_recv, g_token):
        mesh = ctx.mesh
        s, n = mesh.rank, mesh.size
        g_h = exchange(g_recv, torch.empty_like(g_recv), (s - 1) % n, (s + 1) % n, mesh)
        return g_h, g_token, None


class _DeliverLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, token, mesh):
        ctx.mesh = mesh
        return broadcast_from(y.clone(), mesh.size - 1, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = all_reduce_sum(g.contiguous().clone(), mesh).div_(mesh.size)
        last = mesh.rank == mesh.size - 1
        return (g if last else None), torch.zeros((), device=g.device), None


def ring_hop(h: torch.Tensor, token: torch.Tensor, mesh):
    """(stage s - 1's ``h`` on stage s, the next token); see the module's
    docstring."""
    return _RingHop.apply(h, token, mesh)


def deliver_last(y: torch.Tensor, token: torch.Tensor, mesh) -> torch.Tensor:
    """The last stage's ``y`` on every stage (the others pass a tensor of its
    shape and dtype); see the module's docstring."""
    return _DeliverLast.apply(y, token, mesh) if _active(mesh) else y
