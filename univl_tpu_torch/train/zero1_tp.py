"""ZeRO-1 under tensor parallelism: BertAdam on a (dp, tp) mesh, the
counterpart of ``univl_tpu/train/zero1_tp.py``.

The flat ZeRO-1 of ``train/zero1.py`` assumes every data-parallel rank holds
whole parameters; under tensor parallelism a rank holds its share of the
split ones (``parallel/tp.py``), whose moments the split already divides by
the tp size. So the parameters are partitioned by their layout, as JAX
partitions its tree by ``tp_pspec``:

  - tp-replicated parameters (LayerNorms, position and type tables, the
    feature projection, poolers, the row-parallel products' biases, a table
    tp does not divide): the flat ZeRO-1 path over the dp group, a
    ``Zero1BertAdam`` on the dp view, its moments and master sharded over the
    dp ranks;
  - tp-split parameters (attention and FFN weights, the vocab-parallel
    table and biases): per-tensor BertAdam on the rank's shares, their
    gradients averaged over the dp group.

The global clip sees the whole gradient's norm: the flat part's per-leaf
sums (over dp) plus the split tensors' squares summed over the tp ranks, the
replicated ones counted once; each split tensor's per-tensor clip takes its
whole norm too. Equivalent to the replicated BertAdam on the same mesh up to
the order of f32 sums, as in JAX (``tests/test_zero1.py:325-367``).

The trainer's flat gradient buffer (``flat_params``, ``offsets``,
``padded``) holds the replicated parameters first, in ZeRO-1's padded layout,
then the split ones. ``state_dict`` is ``BertAdam``'s layout on the rank's
shares (every parameter's m and v, the flat part's gathered over dp), which
the checkpoints gather over tp into the tp=1 layout; ``load_state_dict``
takes it back. Both are collectives.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, Mesh
from univl_tpu_torch.train.optimization import BertAdam, clip_by_norm_, univl_param_groups
from univl_tpu_torch.train.zero1 import FLAT_ALIGN, Zero1BertAdam, flat_offsets


class Zero1TpBertAdam(BertAdam):
    """``BertAdam`` (same arguments, same rules) on a (dp, tp) ``mesh``: the
    flat ZeRO-1 over dp for the parameters outside ``sharded`` (ids), per
    tensor for those in it. ``step`` takes the rank's flat f32 gradient of
    ``padded`` elements, unreduced over dp."""

    def __init__(self, params, mesh: Mesh, sharded, **kw):
        super().__init__(params, **kw)
        self.mesh = mesh
        self.dp, self.tp = mesh.axis(DP_AXIS), mesh.axis(TP_AXIS)
        self.sharded = frozenset(sharded)
        groups = [dict(g, params=[p for p in g["params"] if id(p) not in self.sharded])
                  for g in self.param_groups]
        self.flat = Zero1BertAdam([g for g in groups if g["params"]], mesh=self.dp, **kw)
        self.split_groups = [(g, [p for p in g["params"] if id(p) in self.sharded])
                             for g in self.param_groups]
        self.split_params = [p for _, ps in self.split_groups for p in ps]
        self.split_offsets, split_total = flat_offsets(self.split_params)
        self.flat_params = self.flat.flat_params + self.split_params
        self.offsets = self.flat.offsets + [self.flat.padded + o for o in self.split_offsets]
        self.padded = self.flat.padded + -(-split_total // FLAT_ALIGN) * FLAT_ALIGN
        self._index = {id(p): i for i, p in enumerate(
            p for g in self.param_groups for p in g["params"])}

    @torch.no_grad()
    def step(self, flat_grad: torch.Tensor):
        head, tail = flat_grad[:self.flat.padded], flat_grad[self.flat.padded:]
        leaf_sq = self.flat.reduce_grads(head)
        comm.all_reduce_mean(tail, self.dp)
        grads = [tail[o:o + p.numel()].view_as(p)
                 for p, o in zip(self.split_params, self.split_offsets)]
        split_sq = self.full_sq(grads, self.split_params)
        factors = self.lr_factors()
        norm = None
        if self.global_clip_norm is not None:
            norm = (leaf_sq.sum() + split_sq.sum()).sqrt()
            clip_by_norm_(grads, norm, self.global_clip_norm)
            factor = torch.where(norm >= self.global_clip_norm,
                                 self.global_clip_norm / norm, 1.0)
            split_sq = split_sq * (factor * factor)
        self.flat.update_shard(leaf_sq, norm)  # at its own steps, which are these
        at = 0
        for j, (group, params) in enumerate(self.split_groups):
            if not params:
                continue
            g = grads[at:at + len(params)]
            if self.max_grad_norm > 0:
                coef = self.tensor_clip(split_sq[at:at + len(params)].sqrt())
                g = torch._foreach_mul(g, list(coef.unbind()))
            ms, vs = zip(*(self._moments(p) for p in params))
            self.update_(g, list(ms), list(vs), params, group, factors[j])
            at += len(params)
        self.steps += 1
        self.flat.steps = self.steps
        self.flat.gather_params(head)
        for p in self.split_params:
            p.grad = None

    def state_dict(self) -> Dict:
        """``BertAdam.state_dict``'s layout on the rank's shares (the flat
        part's moments gathered over dp): a collective."""
        sd = torch.optim.Optimizer.state_dict(self)
        sd["steps"] = self.steps
        flat = self.flat.state_dict()
        state = {}
        if self.steps:
            for i, p in enumerate(self.flat.flat_params):
                state[self._index[id(p)]] = flat["state"][i]
            for p in self.split_params:
                state[self._index[id(p)]] = {k: v.clone() for k, v in self.state[p].items()}
        sd["state"] = state
        return sd

    def load_state_dict(self, state_dict: Dict) -> None:
        """A ``BertAdam`` state on the rank's shares (``state_dict``'s layout)."""
        for group, saved in zip(self.param_groups, state_dict["param_groups"]):
            group.update({k: v for k, v in saved.items() if k != "params"})
        self.steps = int(state_dict["steps"])
        state = state_dict["state"]

        def saved(p):
            i = self._index[id(p)]
            return state.get(i, state.get(str(i)))

        flat_state = {i: saved(p) for i, p in enumerate(self.flat.flat_params)
                      if saved(p) is not None}
        self.flat.load_state_dict({"param_groups": [
            {k: v for k, v in g.items() if k != "params"} for g in self.flat.param_groups],
            "steps": self.steps, "state": flat_state})
        self.state.clear()
        for p in self.split_params:
            st = saved(p)
            if st is not None:
                dt = self.state_dtype or p.dtype
                self.state[p] = {k: st[k].to(device=p.device, dtype=dt).clone()
                                 for k in ("m", "v")}


def make_univl_zero1_tp_optimizer(model: torch.nn.Module, mesh: Mesh, sharded, lr: float,
                                  t_total: int, warmup_proportion: float = 0.1,
                                  coef_lr: float = 1.0, schedule: str = "warmup_linear",
                                  weight_decay: float = 0.01, global_clip_norm: float = 1.0,
                                  state_dtype: Optional[str] = None) -> Zero1TpBertAdam:
    """The (dp, tp) twin of ``make_univl_zero1_optimizer`` (the same
    parameter groups and clips); ``sharded``: the ids of the tp-split
    parameters (``parallel/tp.py``'s layout)."""
    return Zero1TpBertAdam(univl_param_groups(model, coef_lr, weight_decay), mesh=mesh,
                           sharded=sharded, lr=lr, warmup=warmup_proportion, t_total=t_total,
                           schedule=schedule, weight_decay=weight_decay, max_grad_norm=1.0,
                           global_clip_norm=global_clip_norm, state_dtype=state_dtype)
