"""BertAdam as a ``torch.optim.Optimizer``, with UniVL's parameter groups.

Ports ``univl_tpu/train/optimization.py`` and keeps every rule of the
reference optimizer (modules/optimization.py), which is not Adam:
  - the training loop's global gradient clip first, with optax
    ``clip_by_global_norm``'s formula: g unchanged if the global norm is
    below the limit, else ``(g / norm) * limit``;
  - then a clip of each parameter's gradient inside the step, dividing by
    ``norm + 1e-6``;
  - moments without bias correction;
  - weight decay added to the update, not to the gradient;
  - the learning rate computed from the step count before its increment, so
    the first update under warmup uses lr 0;
  - ``state_dtype="bfloat16"``: moments stored rounded, their math in f32.

Everything but the schedule runs on the device in ``torch._foreach_*`` ops,
with no host sync: the step count lives on the host, so the learning rate is
a host number. ``state_dict`` carries the step count beside the moments, so
one ``load_state_dict`` restores the whole optimizer.

Under tensor parallelism (``set_tensor_parallel``) a rank holds its share of
the split parameters and their moments: the global norm and the per-tensor
clip norms sum the squares of a split tensor's shares over the tp ranks and
count a replicated one once, so both clips see the whole gradient's norms.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from univl_tpu_torch.nn.layers import LayerNormTF
from univl_tpu_torch.parallel import comm


def warmup_cosine(x, warmup=0.002):
    return x / warmup if x < warmup else 0.5 * (1.0 + np.cos(math.pi * x))


def warmup_constant(x, warmup=0.002):
    return x / warmup if x < warmup else 1.0


def warmup_linear(x, warmup=0.002):
    """Triangular: peak at warmup * t_total, zero at t_total."""
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


def clip_by_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place, given the global ``norm``: g
    if it is below ``max_norm``, else ``(g / norm) * max_norm``, decided on
    the device."""
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``clip_by_norm_`` with the norm of ``grads``."""
    clip_by_norm_(grads, torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))),
                  max_norm)


class BertAdam(torch.optim.Optimizer):
    """The reference BertAdam. Each parameter group may carry ``weight_decay``
    and ``lr_scale`` (a multiplier of the learning rate: ``coef_lr``)."""

    def __init__(self, params, lr: float, warmup: float = -1.0, t_total: int = -1,
                 schedule: str = "warmup_linear", b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 global_clip_norm: Optional[float] = None, state_dtype: Optional[str] = None):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; choose from {sorted(SCHEDULES)}")
        defaults = dict(lr=lr, weight_decay=weight_decay, lr_scale=1.0)
        super().__init__(params, defaults)
        self.warmup, self.t_total, self.schedule = warmup, t_total, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm, self.global_clip_norm = max_grad_norm, global_clip_norm
        self.state_dtype = {None: None, "float32": None, "bfloat16": torch.bfloat16}[state_dtype]
        self.steps = 0  # updates taken; the schedule reads it before the increment
        self.tp = None  # the tp view, with the ids of the split parameters in ``sharded``
        self.sharded = frozenset()

    def set_tensor_parallel(self, mesh, sharded) -> None:
        """The parameters whose ids are in ``sharded`` are shares split over
        ``mesh``'s ranks (the tp view): their norms sum over the ranks."""
        if mesh.size > 1:
            self.tp, self.sharded = mesh, frozenset(sharded)

    def full_sq(self, tensors: List[torch.Tensor], params: List[torch.Tensor],
                sq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The squared norms of ``tensors`` (the gradients of ``params``) as
        whole tensors: a split one's summed over the tp ranks, a collective."""
        if sq is None:
            norms = torch.stack(torch._foreach_norm(tensors))
            sq = norms * norms
        split = torch.tensor([id(p) in self.sharded for p in params], device=sq.device)
        part = comm.all_reduce_sum(torch.where(split, sq, 0.0), self.tp)
        return torch.where(split, part, sq)

    def lr_at(self, step: int) -> float:
        """The schedule's learning rate factor times ``lr`` at ``step``, in
        f32 arithmetic as the JAX package computes it."""
        lr = self.defaults["lr"]
        if self.t_total == -1:
            return lr
        progress = np.float32(step) / np.float32(self.t_total)
        factor = SCHEDULES[self.schedule](progress, np.float32(self.warmup))
        return float(np.float32(lr) * np.float32(factor))

    def state_dict(self):
        sd = super().state_dict()
        sd["steps"] = self.steps
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        steps = int(state_dict.pop("steps"))
        super().load_state_dict(state_dict)
        self.steps = steps
        if self.state_dtype is not None:
            # the base class casts the moments to the parameter's dtype; the
            # round trip through f32 is exact, so this restores them bit for bit
            for st in self.state.values():
                for key in ("m", "v"):
                    st[key] = st[key].to(self.state_dtype)

    def _moments(self, p: torch.Tensor):
        st = self.state[p]
        if not st:
            dt = self.state_dtype or p.dtype
            st["m"] = torch.zeros_like(p, dtype=dt)
            st["v"] = torch.zeros_like(p, dtype=dt)
        return st["m"], st["v"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("BertAdam takes no closure")
        groups = [(g, g["params"]) for g in self.param_groups]
        # a parameter without a gradient takes a zero one, as in the JAX tree
        grads = {p: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for _, ps in groups for p in ps}
        if self.global_clip_norm is not None:
            if self.tp is None:
                clip_by_global_norm_(list(grads.values()), self.global_clip_norm)
            else:
                gs = list(grads.values())
                clip_by_norm_(gs, self.full_sq(gs, list(grads)).sum().sqrt(),
                              self.global_clip_norm)
        lr_t = self.lr_at(self.steps)
        for group, params in groups:
            if not params:
                continue
            g = [grads[p] for p in params]
            if self.max_grad_norm > 0:
                norms = torch.stack(torch._foreach_norm(g))
                if self.tp is not None:
                    norms = self.full_sq(g, params, norms * norms).sqrt()
                g = torch._foreach_mul(g, list(self.tensor_clip(norms).unbind()))
            ms, vs = zip(*(self._moments(p) for p in params))
            self.update_(g, list(ms), list(vs), list(params), group, lr_t)
        self.steps += 1

    def tensor_clip(self, norms: torch.Tensor) -> torch.Tensor:
        """The reference's per-tensor clip coefficients from the tensors'
        gradient norms (after the global clip)."""
        return torch.clamp(self.max_grad_norm / (norms + 1e-6), max=1.0)

    def update_(self, g: List[torch.Tensor], ms: List[torch.Tensor], vs: List[torch.Tensor],
                params: List[torch.Tensor], group: Dict, lr_t: float) -> None:
        """One group's moments and update in place, from its clipped
        gradients ``g``: the moments in f32 (stored rounded to
        ``state_dtype``, and the update computed from the stored values), the
        weight decay read from ``params``, which take the update."""
        m32 = [m.float() for m in ms]  # the f32 state itself; copies of bf16 state
        v32 = [v.float() for v in vs]
        torch._foreach_mul_(m32, self.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(v32, self.b2)
        torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, 1 - self.b2), g))
        if self.state_dtype is None:
            m_new, v_new = m32, v32
        else:
            for dst, src in zip(ms + vs, m32 + v32):
                dst.copy_(src)
            m_new, v_new = [m.float() for m in ms], [v.float() for v in vs]
        upd = torch._foreach_div(m_new, torch._foreach_add(torch._foreach_sqrt(v_new), self.eps))
        if group["weight_decay"] > 0.0:
            torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
        alpha = np.float32(lr_t) * np.float32(group["lr_scale"])
        torch._foreach_add_(params, upd, alpha=-float(alpha))


def univl_param_groups(model: torch.nn.Module, coef_lr: float,
                       weight_decay: float = 0.01) -> List[Dict]:
    """The JAX package's tree rules mapped to torch names: no weight decay on
    any bias or LayerNorm weight (``normalize_video.visual_norm2d.weight``
    included), ``lr * coef_lr`` on the whole text branch (``bert.*``: JAX's
    ``text``, ``word_embed`` and ``text_pos_embed``)."""
    ln_weights = {id(m.weight) for m in model.modules() if isinstance(m, LayerNormTF)}
    groups: Dict[tuple, List] = {}
    for name, p in model.named_parameters():
        decay = not (name.endswith("bias") or id(p) in ln_weights)
        scale = coef_lr if name.startswith("bert.") else 1.0
        groups.setdefault((decay, scale), []).append(p)
    return [{"params": ps, "weight_decay": weight_decay if decay else 0.0, "lr_scale": scale}
            for (decay, scale), ps in sorted(groups.items(), key=lambda kv: kv[0])]


def make_univl_optimizer(model: torch.nn.Module, lr: float, t_total: int,
                         warmup_proportion: float = 0.1, coef_lr: float = 1.0,
                         schedule: str = "warmup_linear", weight_decay: float = 0.01,
                         global_clip_norm: float = 1.0,
                         state_dtype: Optional[str] = None) -> BertAdam:
    """BertAdam with the training loop's global clip and UniVL's parameter groups
    (``univl_tpu.train.optimization.make_univl_optimizer``)."""
    return BertAdam(univl_param_groups(model, coef_lr, weight_decay), lr=lr,
                    warmup=warmup_proportion, t_total=t_total, schedule=schedule,
                    weight_decay=weight_decay, max_grad_norm=1.0,
                    global_clip_norm=global_clip_norm, state_dtype=state_dtype)
