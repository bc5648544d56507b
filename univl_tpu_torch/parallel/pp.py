"""GPipe pipeline parallelism over the mesh's pp axis, the port's
``univl_tpu/parallel/pp.py``.

As in JAX a library primitive, which no CLI calls: UniVL fits one card, and
at its 12/6/2/3-layer towers the bubble (S - 1) / (M + S - 1) costs more than
it buys (``docs/SCALING.md``). It is there for deeper stacks:

  - ``place_stacked_params`` gives stage s the modules and parameters of
    layers [s*L/S, (s+1)*L/S) and nothing else: the S-fold saving of
    parameter and optimizer-state memory that pipelining exists for;
  - ``pipeline_apply`` runs GPipe's M + S - 1 ticks: at tick t stage s runs
    its layers on microbatch t - s where that is one of the M, then every
    stage hands its result to the next (``comm.ring_hop``, JAX's
    ``lax.ppermute`` s -> s + 1 mod S). Where JAX's fill and drain ticks run
    the stage on zero buffers, these skip the layers and hop the zeros, so
    every rank makes the same point-to-point calls at every tick;
  - autograd's backward of the ticks is the reverse pipeline (a hop's
    backward is the inverse hop), as ``jax.grad`` of the scan is JAX's: one
    definition serves training and inference.

The last stage's output reaches every stage (``comm.deliver_last``), and
each stage may take the same loss from it: the gradient is the sequential
loop's, not S times it. A layer keeps its global index ``i``, so the port's
keyed dropout folds the index the sequential stack folds
(``nn/layers.py:_run_layer``); microbatch m draws from its own fold.

Correctness: pipeline == sequential layer loop, forward and every parameter
gradient, and the JAX package's ``pipelined_stack_fn``
(``tests/test_torch_pp.py``).
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from univl_tpu_torch.nn.layers import _run_layer
from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel import mesh as dp_mesh
from univl_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS, Mesh

MICROBATCH_TAG = 5  # folded with the microbatch's index before a layer folds its own


def make_mesh_pp(dp: int, pp: int, device: str = "cuda", backend: Optional[str] = None,
                 **kw) -> Mesh:
    """This rank's place in a (dp, pp) grid of ``dp * pp`` launched ranks
    (pp the inner axis, so a stage's neighbour is the next rank); the
    counterpart of JAX's ``make_mesh_pp``, which lays out devices instead."""
    ranks = int(os.environ.get("WORLD_SIZE", 1))
    if ranks != dp * pp:
        raise ValueError(f"need {dp * pp} ranks, have {ranks}")
    return dp_mesh.init(device, backend, pp=pp, **kw)


def stage_range(n_layers: int, mesh: Mesh) -> range:
    """The global indexes of the layers of this rank's stage."""
    view = mesh.axis(PP_AXIS)
    if n_layers % view.size:
        raise ValueError(f"{n_layers} layers do not split over {view.size} pipeline stages")
    per = n_layers // view.size
    return range(view.rank * per, (view.rank + 1) * per)


def place_stacked_params(stack, mesh: Mesh) -> nn.ModuleDict:
    """This stage's layers of ``stack`` (a ``TransformerStack``, or any
    module whose ``layer`` lists the layers) on the rank's device, keyed by
    their global index; the other layers are not moved, so the rank holds
    their parameters nowhere on its device. A reference-named state dict
    loads into the stack first (``load_state_dict``)."""
    layers = stack.layer
    return nn.ModuleDict({str(i): layers[i].to(mesh.device)
                          for i in stage_range(len(layers), mesh)})


def pipeline_apply(body: Callable, stage_layers: Mapping, x: torch.Tensor, n_microbatches: int,
                   mesh: Mesh) -> torch.Tensor:
    """Run a layer stack as a GPipe pipeline over ``mesh``'s pp axis.

    ``body(layer, h, i, m) -> h`` runs one layer on microbatch ``m``'s rows
    (JAX's ``body(layer_params, h)``, with the layer's global index ``i`` and
    ``m`` for the port's keyed randomness and per-row inputs such as a key
    mask); it keeps ``h``'s shape and dtype. ``stage_layers`` maps this
    stage's global indexes to its layers (``place_stacked_params``). ``x``
    ([B, ...], B a multiple of ``n_microbatches``) is stage 0's input; every
    stage passes a tensor of its shape and dtype, and only stage 0 reads it.

    Returns [B, ...], the last stage's output, on every stage. Every stage
    runs the backward of it (its loss's, or zeros), since its hops take part
    in the others' backward."""
    view = mesh.axis(PP_AXIS)
    S, s, M = view.size, view.rank, n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    layers = sorted((int(i), layer) for i, layer in stage_layers.items())
    x_mb = x.split(B // M)
    track = torch.is_grad_enabled()
    token = torch.zeros((), device=x.device, requires_grad=track)
    idle = torch.zeros_like(x_mb[0])  # what a fill or drain tick hands on
    buf, outs = None, []
    for t in range(M + S - 1):
        m = t - s
        if 0 <= m < M:
            h = x_mb[m] if s == 0 else buf
            for i, layer in layers:
                h = body(layer, h, i, m)
            if h.shape != idle.shape or h.dtype != idle.dtype:
                raise ValueError(f"body changed h from {tuple(idle.shape)} {idle.dtype} to "
                                 f"{tuple(h.shape)} {h.dtype}")
            if s == S - 1:
                outs.append(h)
        else:
            h = idle
        if S > 1:
            buf, token = comm.ring_hop(h, token, view)
    y = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
    return comm.deliver_last(y, token, view)


def pipelined_stack_fn(body: Callable, mesh: Mesh, n_microbatches: int) -> Callable:
    """``(stage_layers, x) -> y`` running ``body`` layers as a pipeline over
    the mesh's pp axis; with a dp axis each dp group pipelines its own share
    of the rows of the global batch ``x`` (JAX's ``P('dp')``), and ``y`` is
    the global output on every rank (an all-gather over dp whose backward
    keeps the rank's rows).

    The dp mean of the gradient: JAX's ``jax.grad`` of the global loss sums
    the dp shards' contributions inside its program. Here every rank takes
    the global loss from ``y`` and its backward leaves each stage's
    parameter gradients holding its own dp group's share, so the caller sums
    them over the dp axis (``sum_dp_grads``) before the optimizer steps."""
    dp = mesh.axis(DP_AXIS)

    def fn(stage_layers: Mapping, x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[0] // dp.size
        if rows * dp.size != x.shape[0]:
            raise ValueError(f"batch {x.shape[0]} does not split over {dp.size} dp groups")
        local = x[dp.rank * rows:(dp.rank + 1) * rows]
        return comm.join_rows(pipeline_apply(body, stage_layers, local, n_microbatches, mesh), dp)

    return fn


def sum_dp_grads(stage_layers: nn.Module, mesh: Mesh) -> None:
    """Sum each parameter's gradient over the dp axis, in place: the global
    loss's gradient from the dp groups' shares (``pipelined_stack_fn``)."""
    dp = mesh.axis(DP_AXIS)
    for p in stage_layers.parameters():
        if p.grad is not None:
            comm.all_reduce_sum(p.grad, dp)


def transformer_body(key_mask: torch.Tensor, rng=None) -> Callable:
    """The ``body`` of the encoders' ``TransformerLayer``: microbatch m's rows
    of ``key_mask`` ([B, L]), and in training, layer i of microbatch m draws
    from ``rng.fold(MICROBATCH_TAG, m)`` folded with i (``rng`` a
    ``Randomness``: the stack's run, ``Randomness.run(tag)``)."""

    def body(layer, h, i, m):
        mb = h.shape[0]
        run = None if rng is None else rng.fold(MICROBATCH_TAG, m)
        return _run_layer(layer, h, key_mask[m * mb:(m + 1) * mb], run, i)

    return body
