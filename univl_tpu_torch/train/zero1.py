"""ZeRO-1 BertAdam: the optimizer state and update sharded over the
data-parallel ranks, the counterpart of ``univl_tpu/train/zero1.py``.

The parameters, in the order of the optimizer's groups, are one flat f32
vector of ``total`` elements (each parameter 512-byte aligned,
``flat_offsets``: the trainer's gradient buffer has the same layout), padded to ``size * shard``; rank r owns elements
``[r * shard, (r + 1) * shard)``. A step:
  - reduce-scatters the flat gradient (the trainer's buffer, with zeros where
    a parameter got none) and divides the rank's shard by the rank count:
    the mean gradient's shard;
  - the per-leaf squared norms: ``_foreach_norm`` of the shard's segments
    (one view for each parameter that intersects the shard), summed by leaf
    into an ``[n_leaves]`` vector, then one ``all_reduce_sum``. The global
    norm is the root of their sum: the global clip (``BertAdam.step``'s
    formula) scales the shard, and the leaf sums by its factor squared;
    then the reference's per-tensor clip coefficients from them;
  - BertAdam's moments and update (``BertAdam.update_``, each segment with
    its group's weight decay and lr scale) on the shard's moments ``m`` and
    ``v`` (``state_dtype``: stored rounded, the update from the stored
    values) and its f32 master copy of the parameters, into which the
    update is added;
  - one ``all_gather`` of the new master shards into the flat buffer (the
    gradient, which the step no longer needs), then ``_foreach_copy_`` into
    the parameters, whose ``.grad`` (views of that buffer, now holding
    parameter values) it sets to None.
JAX's row plan and boundary-row fixes exist because XLA on the TPU cannot
gather per element; here a shard is a list of segment views. With the
master initialised from the parameters the update is the replicated
BertAdam's, element for element; only the norms' sums run in another order
(the global norm from leaf sums, a leaf's from its ranks' partial sums).

``state_dict`` gathers the moments into the replicated ``BertAdam`` layout
(``replicated_state_from_zero1``), and ``load_state_dict`` takes that layout
(``zero1_state_from_replicated``), so a train state crosses between
``--zero1`` and the replicated optimizer at the same rank count. Both are
collectives under a process group: every rank calls them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel.mesh import Mesh
from univl_tpu_torch.train.optimization import BertAdam, clip_by_norm_, univl_param_groups

FLAT_ALIGN = 128  # f32 elements: 512 bytes, the caching allocator's alignment


def flat_offsets(params, align: int = FLAT_ALIGN):
    """(each parameter's offset, the length): the parameters one after the
    other in a flat vector, each starting at a multiple of ``align``."""
    offsets, end = [], 0
    for p in params:
        offsets.append(end)
        end = -(-(end + p.numel()) // align) * align
    return offsets, end


class _Segments:
    """One group's views into the rank's shard: gradient, moments, master."""

    def __init__(self):
        self.g: List[torch.Tensor] = []
        self.m: List[torch.Tensor] = []
        self.v: List[torch.Tensor] = []
        self.master: List[torch.Tensor] = []
        self.leaf: List[int] = []  # the parameter's index in the flat order
        self.params: List[tuple] = []  # (parameter, start, end) in its flat elements


class Zero1BertAdam(BertAdam):
    """``BertAdam`` (same arguments, same rules) with its state sharded over
    ``mesh``'s ranks. ``step`` takes the rank's flat f32 gradient of
    ``padded`` elements, unreduced."""

    def __init__(self, params, mesh: Optional[Mesh] = None, **kw):
        super().__init__(params, **kw)
        self.mesh = mesh or Mesh()
        self.flat_params = [p for g in self.param_groups for p in g["params"]]
        self.offsets, self.total = flat_offsets(self.flat_params)
        size, rank = self.mesh.size, self.mesh.rank
        self.shard = -(-self.total // (size * FLAT_ALIGN)) * FLAT_ALIGN
        self.padded = self.shard * size
        device = self.flat_params[0].device
        sdt = self.state_dtype or torch.float32
        self.m = torch.zeros(self.shard, dtype=sdt, device=device)
        self.v = torch.zeros(self.shard, dtype=sdt, device=device)
        self.master = torch.zeros(self.shard, dtype=torch.float32, device=device)
        self.g = torch.zeros(self.shard, dtype=torch.float32, device=device)
        lo, hi = rank * self.shard, (rank + 1) * self.shard
        self._groups: List[tuple] = []
        leaf = 0
        for j, group in enumerate(self.param_groups):
            segs = _Segments()
            segs.group_index = j
            for p in group["params"]:
                a, b = max(self.offsets[leaf], lo), min(self.offsets[leaf] + p.numel(), hi)
                if a < b:
                    sa, sb = a - lo, b - lo
                    for dst, src in ((segs.g, self.g), (segs.m, self.m), (segs.v, self.v),
                                     (segs.master, self.master)):
                        dst.append(src[sa:sb])
                    segs.leaf.append(leaf)
                    segs.params.append((p, a - self.offsets[leaf], b - self.offsets[leaf]))
                leaf += 1
            if segs.g:
                segs.leaf_index = torch.tensor(segs.leaf, dtype=torch.long, device=device)
                self._groups.append((group, segs))
        self._leaf_index = torch.cat([s.leaf_index for _, s in self._groups])
        self._all_g = [t for _, s in self._groups for t in s.g]
        self.load_master()

    def load_master(self) -> None:
        """The master shard from the parameters as they are now."""
        with torch.no_grad():
            for _, segs in self._groups:
                for dst, (p, a, b) in zip(segs.master, segs.params):
                    dst.copy_(p.detach().reshape(-1)[a:b].float())

    def flat_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each parameter's view of a flat vector of this layout."""
        return [flat[o:o + p.numel()].view_as(p) for p, o in zip(self.flat_params, self.offsets)]

    @torch.no_grad()
    def step(self, flat_grad: torch.Tensor):
        leaf_sq = self.reduce_grads(flat_grad)
        norm = leaf_sq.sum().sqrt() if self.global_clip_norm is not None else None
        self.update_shard(leaf_sq, norm)
        self.steps += 1
        self.gather_params(flat_grad)

    def reduce_grads(self, flat_grad: torch.Tensor) -> torch.Tensor:
        """The mean gradient's shard into ``g``; returns the per-leaf squared
        norms of the whole gradient (an ``[n_leaves]`` vector, summed over
        the ranks)."""
        mesh = self.mesh
        g = comm.reduce_scatter(flat_grad, mesh, out=self.g)
        if mesh.size > 1:
            g.div_(mesh.size)
        norms = torch.stack(torch._foreach_norm(self._all_g))
        leaf_sq = torch.zeros(len(self.flat_params), dtype=torch.float32, device=g.device)
        leaf_sq.index_add_(0, self._leaf_index, norms * norms)
        return comm.all_reduce_sum(leaf_sq, mesh)

    def update_shard(self, leaf_sq: torch.Tensor, norm: Optional[torch.Tensor]) -> None:
        """The global clip at ``norm`` (the whole gradient's; None: no clip),
        the per-tensor clips and BertAdam's update of the shard's master at
        the learning rate of ``steps``."""
        if norm is not None:
            clip_by_norm_([self.g], norm, self.global_clip_norm)
            factor = torch.where(norm >= self.global_clip_norm,
                                 self.global_clip_norm / norm, 1.0)
            leaf_sq = leaf_sq * (factor * factor)
        factors = self.lr_factors()
        for group, segs in self._groups:
            gs = segs.g
            if self.max_grad_norm > 0:
                coef = self.tensor_clip(leaf_sq[segs.leaf_index].sqrt())
                gs = torch._foreach_mul(gs, list(coef.unbind()))
            self.update_(gs, segs.m, segs.v, segs.master, group, factors[segs.group_index])

    def gather_params(self, flat_grad: torch.Tensor) -> None:
        """The new master shards gathered into ``flat_grad`` and copied into
        the parameters, whose ``.grad`` it sets to None."""
        full = comm.all_gather(self.master, self.mesh, out=flat_grad)
        torch._foreach_copy_(self.flat_params, self.flat_views(full[:self.total]))
        for p in self.flat_params:
            p.grad = None  # the buffer now holds parameters, not gradients

    def state_dict(self) -> Dict:
        """The replicated ``BertAdam.state_dict``: every parameter's m and v,
        gathered from the shards (none before the first step, as there)."""
        sd = torch.optim.Optimizer.state_dict(self)
        sd["steps"] = self.steps
        views = {k: self.flat_views(comm.all_gather(getattr(self, k).float(), self.mesh))
                 for k in ("m", "v")}
        if self.steps:
            sd["state"] = {i: {k: views[k][i].to(self.state_dtype or p.dtype, copy=True)
                               for k in ("m", "v")}
                           for i, p in enumerate(self.flat_params)}
        return sd

    def load_state_dict(self, state_dict: Dict) -> None:
        """A replicated ``BertAdam`` state (or this optimizer's): the rank's
        shard of its moments, its step count, and the master shard from the
        parameters, which are loaded first."""
        for group, saved in zip(self.param_groups, state_dict["param_groups"]):
            group.update({k: v for k, v in saved.items() if k != "params"})
        self.steps = int(state_dict["steps"])
        state = state_dict["state"]
        with torch.no_grad():
            self.m.zero_()
            self.v.zero_()
            for _, segs in self._groups:
                for i, (p, a, b) in enumerate(segs.params):
                    st = state.get(segs.leaf[i], state.get(str(segs.leaf[i])))
                    if st is None:
                        continue
                    for dst, key in ((segs.m[i], "m"), (segs.v[i], "v")):
                        dst.copy_(st[key].reshape(-1)[a:b].to(dst.device))
        self.load_master()


def make_univl_zero1_optimizer(model: torch.nn.Module, mesh: Optional[Mesh], lr: float,
                               t_total: int, warmup_proportion: float = 0.1,
                               coef_lr: float = 1.0, schedule: str = "warmup_linear",
                               weight_decay: float = 0.01, global_clip_norm: float = 1.0,
                               state_dtype: Optional[str] = None) -> Zero1BertAdam:
    """The ZeRO-1 twin of ``make_univl_optimizer`` (the same parameter
    groups and clips)."""
    return Zero1BertAdam(univl_param_groups(model, coef_lr, weight_decay), mesh=mesh, lr=lr,
                         warmup=warmup_proportion, t_total=t_total, schedule=schedule,
                         weight_decay=weight_decay, max_grad_norm=1.0,
                         global_clip_norm=global_clip_norm, state_dtype=state_dtype)
