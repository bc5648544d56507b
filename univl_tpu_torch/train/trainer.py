"""A single-device trainer with the semantics of ``univl_tpu/train/trainer.py``.

One optimizer step takes a batch with a leading micro-batch axis,
``[accum, B, ...]``: each micro-batch's loss is computed over its own rows
(the reference's per-device negatives), its gradients are summed into
``.grad``, and the sum is divided by ``accum`` before the optimizer steps;
the returned metrics are the micro-batches' mean. Step ``global_step`` draws
all its dropout from one CPU generator seeded from ``(seed, global_step)``
(the counterpart of ``fold_in(base_key, global_step)``), so a step is
reproducible on its own and a run can later resume at any step.

The JAX package's ``train_steps`` (K steps in one dispatch) works around
XLA's per-dispatch cost and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def step_generator(seed: int, global_step: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, global_step)."""
    state = np.random.SeedSequence([seed, global_step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) | int(state[1]) << 32)


class Trainer:
    """Trains any module whose ``forward(batch, generator)`` returns a dict
    of scalar losses with key ``"loss"``."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 grad_accum_steps: int = 1, seed: int = 0):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.model = model
        self.optimizer = optimizer
        self.grad_accum_steps = grad_accum_steps
        self.seed = seed

    def train_step(self, batch: Dict[str, torch.Tensor],
                   global_step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (arrays ``[accum, B, ...]`` on the
        model's device); returns the mean metrics as device tensors (no sync)."""
        accum = self.grad_accum_steps
        if any(v.shape[0] != accum for v in batch.values()):
            raise ValueError(f"batch arrays must lead with the {accum} micro-batches")
        self.model.train()
        generator = step_generator(self.seed, global_step)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            out = self.model({k: v[i] for k, v in batch.items()}, generator)
            out["loss"].backward()
            for k, v in out.items():
                sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
        if accum > 1:
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, accum)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return {k: v / accum for k, v in sums.items()}
