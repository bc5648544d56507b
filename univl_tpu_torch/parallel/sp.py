"""Megatron sequence parallelism over the tp axis, the counterpart of
``univl_tpu/parallel/sp.py``.

Under tensor parallelism alone every rank of a tp group computes the
LayerNorm, dropout and residual regions of each block on the whole
``[B, L, H]`` stream, and each row-parallel product ends in an all-reduce.
Sequence parallelism (arXiv:2205.05198 §4.2) splits those regions over the
ranks: the all-reduce becomes a reduce-scatter into the rank's rows, and an
all-gather brings them back before the next column-parallel product. The
bytes on the wire are the same; the regions' work and activation memory are
divided by the tp size.

JAX constrains the residual stream to ``P(None, 'tp', None)`` at each block
boundary of the encoders' stacks (text, visual, cross; not the decoder,
``univl_tpu/models/univl.py:142-156``) and lets GSPMD place the pair of
collectives; the function is unchanged. The port writes them: the stack
takes the rank's rows on entry (``enter``), each layer gathers the rows
before its column-parallel products and scatters after its row-parallel
ones (``comm.gather_rows_tp``, ``comm.scatter_rows_tp``), and the stack
gathers them on exit (``leave``). The port shards the flattened ``[B * L]``
rows contiguously, rank r holding rows ``[r * n, (r + 1) * n)`` with
``n = B * L / tp``, where JAX shards the sequence dim. Every op of a region
(the bias, dropout, residual add and LayerNorm) works on each row alone, so
any split of the rows computes the same function; the contiguous one gives
each rank one row offset, which the dropout counters of #4 and #5
(``kernels/ffn.py``, ``row0``) and the full-shape draws of the plain dropout
(``nn/layers.py:dropout``) take, so the masks are the unsplit run's. The
rank count must divide ``B * L``.

The replicated parameters of the regions (each block's two LayerNorms and
the row-parallel products' biases) get from a rank the gradient of its rows
only; ``sp_params`` lists them, and the trainer sums their gradients over
the tp group before the data-parallel reduction.
"""

from __future__ import annotations

from typing import List

import torch

from univl_tpu_torch.parallel import comm


def enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of the replicated ``[B, L, H]`` stream, ``[n, H]``."""
    return comm.split_rows(x.reshape(-1, x.shape[-1]), mesh)


def leave(x: torch.Tensor, mesh, shape) -> torch.Tensor:
    """Every rank's rows of the stream again, as ``shape`` ``[B, L, H]``."""
    return comm.join_rows(x, mesh).view(shape)


def sp_params(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The replicated parameters whose gradients a sequence-parallel rank
    holds a share of: those of the row-sharded regions."""
    out = []
    for module in model.modules():
        if getattr(module, "sp", None) is not None and hasattr(module, "sp_parameters"):
            out.extend(module.sp_parameters())
    return out
