"""The trainer, with the semantics of ``univl_tpu/train/trainer.py``.

One optimizer step takes a batch with a leading micro-batch axis,
``[accum, B, ...]``: each micro-batch's loss is computed over its own rows
(the reference's per-device negatives), its gradients are summed into
``.grad``, and the sum is divided by ``accum`` before the optimizer steps;
the returned metrics are the micro-batches' mean. Step ``global_step`` draws
all its dropout from one CPU generator seeded from ``(seed, global_step)``
(the counterpart of ``fold_in(base_key, global_step)``), one key a
micro-batch, so a step is reproducible on its own and a run can later
resume at any step.

Data parallelism (``mesh``, ``parallel/mesh.py``) runs one trainer a rank,
each on its rows of every global micro-batch (JAX's ``P(None, 'dp')``):
rank r's micro-batch i draws the key that micro-batch ``r * accum + i``
draws in one process with ``size * accum`` micro-batches, so two ranks
compute what one process computes with two accumulated micro-batches. The
gradients land in one flat f32 buffer (each parameter's ``.grad`` a view of
it, zeros where a parameter got none, as in ``BertAdam.step``; each view
starts where its own allocation would, 512-byte aligned, so the
multi-tensor kernels take the same vectorized route and sum a gradient's
norm in the same order as for a gradient of its own); after the
micro-batch loop the buffer takes one ``all_reduce_mean`` (JAX's ``pmean``
after its scan) and the optimizer steps, or with ``zero1`` the ZeRO-1
optimizer (``train/zero1.py``, a ``Zero1BertAdam``) takes the buffer unreduced and
reduce-scatters it itself. The metrics are averaged over the ranks, as
``pmean`` does. The model is not wrapped in ``DistributedDataParallel``:
FT-Joint never runs the cross tower or the decoder, which DDP would need to
be told about, and the one reduction after the loop is JAX's.

Tensor parallelism (a mesh with ``tp`` above 1, the model cut by
``parallel/tp.py:parallelize``): the ranks of a tp group read the same rows
and draw the same keys, so the data-parallel rules above run over the dp
group (``mesh.axis(DP_AXIS)``): rank r skips the keys of the dp ranks before
its dp index, the gradients and metrics are averaged over the dp group, and
ZeRO-1 is ``train/zero1_tp.py``'s. Under sequence parallelism the gradients
of the row-sharded regions' replicated parameters (``parallel/sp.py``) are
first summed over the tp group.

The JAX package's ``train_steps`` (K steps in one dispatch) works around
XLA's per-dispatch cost and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from univl_tpu_torch.nn.layers import draw_key
from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, Mesh
from univl_tpu_torch.parallel.sp import sp_params
from univl_tpu_torch.train.zero1 import Zero1BertAdam, flat_offsets
from univl_tpu_torch.train.zero1_tp import Zero1TpBertAdam


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, global_step)."""
    state = np.random.SeedSequence([seed, global_step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | int(state[1]) << 32)


class Trainer:
    """Trains any module whose ``forward(batch, generator)`` returns a dict
    of scalar losses with key ``"loss"``."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 grad_accum_steps: int = 1, seed: int = 0, mesh: Optional[Mesh] = None):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.model = model
        self.optimizer = optimizer
        self.grad_accum_steps = grad_accum_steps
        self.seed = seed
        self.mesh = mesh or Mesh()
        self.dp = self.mesh.axis(DP_AXIS)
        # ZeRO-1 takes the flat gradient
        self.zero1 = isinstance(optimizer, (Zero1BertAdam, Zero1TpBertAdam))
        self.sp_params = sp_params(model)
        self._flat = None  # the gradient buffer of a data-parallel or ZeRO-1 step

    def _grad_buffer(self) -> torch.Tensor:
        """The flat f32 gradient buffer, zeroed, each parameter's ``.grad`` a
        view of it (in the optimizer groups' order; ZeRO-1's padded size)."""
        if self.zero1:  # the optimizer's layout
            params, offsets = self.optimizer.flat_params, self.optimizer.offsets
        else:
            params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self._flat is None:
            if self.zero1:
                size = self.optimizer.padded
            else:
                offsets, size = flat_offsets(params)
            self._flat = torch.zeros(size, dtype=torch.float32, device=params[0].device)
            self._views = [self._flat[o:o + p.numel()].view_as(p)
                           for p, o in zip(params, offsets)]
        else:
            self._flat.zero_()
        for p, view in zip(params, self._views):
            p.grad = view
        return self._flat

    def train_step(self, batch: Dict[str, torch.Tensor],
                   global_step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (arrays ``[accum, B, ...]`` on the
        model's device; the rank's rows under data parallelism); returns the
        mean metrics as device tensors (no sync)."""
        accum = self.grad_accum_steps
        if any(v.shape[0] != accum for v in batch.values()):
            raise ValueError(f"batch arrays must lead with the {accum} micro-batches")
        self.model.train()
        generator = step_generator(self.seed, global_step)
        for _ in range(self.dp.rank * accum):  # the keys of the dp ranks before this one
            draw_key(generator)
        flat = self._grad_buffer() if (self.dp.size > 1 or self.zero1) else None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            out = self.model({k: v[i] for k, v in batch.items()}, generator)
            out["loss"].backward()
            for k, v in out.items():
                sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
        if self.sp_params:
            self._sum_sp_grads()
        if flat is None:
            if accum > 1:
                grads = [p.grad for p in self.model.parameters() if p.grad is not None]
                torch._foreach_div_(grads, accum)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        else:
            if accum > 1:
                flat.div_(accum)
            if self.zero1:
                self.optimizer.step(flat)
            else:
                comm.all_reduce_mean(flat, self.dp)
                self.optimizer.step()
        metrics = {k: v / accum for k, v in sums.items()}
        if self.dp.size > 1:
            keys = sorted(metrics)
            mean = comm.all_reduce_mean(torch.stack([metrics[k].float() for k in keys]),
                                        self.dp)
            metrics = dict(zip(keys, mean.unbind()))
        return metrics

    def _sum_sp_grads(self) -> None:
        """The row-sharded regions' replicated gradients summed over the tp group."""
        grads = [p.grad for p in self.sp_params]
        both = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                   self.mesh.axis(TP_AXIS))
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
            both.split([g.numel() for g in grads]), grads)])
