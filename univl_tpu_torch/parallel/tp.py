"""Megatron tensor parallelism over the tp axis of the (dp, tp) mesh, the
counterpart of ``univl_tpu/parallel/tp.py``.

JAX leaves tp an auto axis: GSPMD partitions the XLA program along the
parameter shardings of ``tp_pspec`` and places the collectives, while its
Pallas calls stay whole. The port writes the split itself: each rank holds
its share of the sharded parameters (``shard_state_dict``), the modules of
``nn/`` run on it and call the operators of ``parallel/comm.py`` where the
math crosses ranks, and the kernels (#2 on a rank's heads, #3-#5 split at
the row-parallel product, ``kernels/ffn.py``) run on what the rank holds.
The split is the standard one (arXiv:1909.08053), keyed by the reference
parameter names the port uses (``tp_spec``):

    attention q/k/v weight, bias  [H, H], [H]  dim 0: column-parallel
    (attention.self, and the decoder's slf_attn.att and enc_attn.att)
    attention output dense weight [H, H]       dim 1: row-parallel
    (attention.output, slf_attn.output, enc_attn.output; bias replicated)
    FFN intermediate weight, bias [F, H], [F]  dim 0: column-parallel
    FFN output dense weight       [H, F]       dim 1: row-parallel
    word embedding table          [V, H]       dim 0: vocab-parallel
    (bert's, which the decoder and the masked-language head share)
    masked-language and decoder classifier biases [V]  dim 0
    everything else (LayerNorms, position and type tables, the feature
    projection, poolers, heads' transforms)    replicated

Weights are ``nn.Linear``'s ``[out, in]``, so JAX's kernel spec
``P(None, 'tp')`` is dim 0 here and ``P('tp', None)`` dim 1. A dimension the
tp size does not divide stays replicated, as in JAX (vocab 30,522 at tp 4),
and so does a layer whose head count it does not divide (the port splits
whole heads); the numbers are the same either way. A rank's share of dim d
is the contiguous block ``tp_index``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from univl_tpu_torch.parallel import comm
from univl_tpu_torch.parallel.mesh import TP_AXIS

_COLUMN = re.compile(r"\.(attention\.self|slf_attn\.att|enc_attn\.att)\.(query|key|value)\."
                     r"(weight|bias)$|\.intermediate\.dense\.(weight|bias)$")
_ROW = re.compile(r"\.output\.dense\.weight$")
_ATTENTION = re.compile(r"\.(attention\.self|slf_attn\.att|enc_attn\.att)\.|"
                        r"\.(attention|slf_attn|enc_attn)\.output\.dense\.")
_VOCAB = ("bert.embeddings.word_embeddings.weight", "cls.predictions.bias",
          "decoder.classifier.cls.predictions.bias")
_TOWERS = {"bert": "bert", "visual": "visual", "cross": "cross", "decoder": "decoder"}


def tp_spec(name: str, shape, tp: int, heads: Optional[int] = None) -> Optional[int]:
    """The dim of parameter ``name`` (shape ``shape``) split over ``tp``
    ranks, or None where it is replicated. ``heads``: the attention heads of
    its layer (an attention weight whose heads ``tp`` does not divide stays
    replicated)."""
    if name in _VOCAB:
        dim = 0
    elif _COLUMN.search(name):
        dim = 0
    elif _ROW.search(name):
        dim = 1
    else:
        return None
    if shape[dim] % tp:
        return None
    if heads is not None and _ATTENTION.search(name) and heads % tp:
        return None
    return dim


def _heads(cfg, name: str) -> Optional[int]:
    tower = _TOWERS.get(name.split(".", 1)[0])
    return getattr(cfg, tower).num_attention_heads if tower else None


def param_layout(cfg, shapes: Mapping[str, tuple], tp: int) -> Dict[str, Optional[int]]:
    """``tp_spec`` of every parameter of a model of ``cfg`` (``shapes``: its
    full state dict's names and shapes)."""
    return {name: tp_spec(name, tuple(shape), tp, _heads(cfg, name))
            for name, shape in shapes.items()}


def shard(t: torch.Tensor, dim: Optional[int], tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of ``t`` along ``dim`` (all of it
    for None)."""
    if dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], layout: Mapping[str, Optional[int]],
                     tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """A full state dict (the tp=1 names and shapes) cut to rank ``rank``'s shares."""
    return {k: shard(v, layout.get(k), tp, rank) for k, v in sd.items()}


def gather(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """The full tensor from every tp rank's share of it along ``dim``: a
    collective over ``mesh`` (the tp view) that every rank calls."""
    if dim is None or mesh.size == 1:
        return t
    rows = comm.gather_rows(t.movedim(dim, 0).contiguous(), mesh)
    return rows.movedim(0, dim).contiguous()


def gather_state_dict(sd: Mapping[str, torch.Tensor], layout: Mapping[str, Optional[int]],
                      mesh) -> Dict[str, torch.Tensor]:
    """The tp=1 state dict from the ranks' shares (``shard_state_dict``'s inverse)."""
    return {k: gather(v.detach(), layout.get(k), mesh) for k, v in sd.items()}


@dataclass
class VocabShard:
    """A rank's rows [start, start + size) of a vocab-parallel table."""

    mesh: object  # the tp view
    start: int
    size: int


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                vocab: Optional[VocabShard]) -> torch.Tensor:
    """The rows ``ids`` of a whole or a vocab-parallel table: the rank looks
    up the ids in its rows, zeros elsewhere, and the ranks' lookups are
    summed (one rank's row and zeros: exact)."""
    if vocab is None:
        return F.embedding(ids, table)
    local = ids - vocab.start
    inside = (local >= 0) & (local < vocab.size)
    rows = F.embedding(torch.where(inside, local, 0), table) * inside[..., None].to(table.dtype)
    return comm.reduce_from_tp(rows, vocab.mesh)


class TensorParallel:
    """What ``parallelize`` put on a model: the tp view, the layout of its
    parameters, and whether the encoders' stacks run sequence-parallel."""

    def __init__(self, mesh, layout: Dict[str, Optional[int]], sequence_parallel: bool):
        self.mesh, self.layout, self.sequence_parallel = mesh, layout, sequence_parallel

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def gather_state_dict(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gather_state_dict(sd, self.layout, self.mesh)

    def shard_state_dict(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return shard_state_dict(sd, self.layout, self.size, self.rank)

    def sharded_ids(self, model: torch.nn.Module) -> set:
        """The ids of ``model``'s split parameters (the optimizers' ``sharded``)."""
        return {id(p) for n, p in model.named_parameters() if self.layout.get(n) is not None}

    def _moment_dims(self, model: torch.nn.Module, optimizer) -> list:
        """The split dim of each of the optimizer's parameters, in its index order."""
        names = {id(p): n for n, p in model.named_parameters()}
        return [self.layout.get(names[id(p)]) for g in optimizer.param_groups
                for p in g["params"]]

    def gather_optimizer_state(self, sd: Dict, model, optimizer) -> Dict:
        """A ``BertAdam.state_dict`` on the rank's shares in the tp=1 layout:
        each split parameter's m and v gathered (a collective)."""
        dims = self._moment_dims(model, optimizer)
        state = {i: {k: gather(v, dims[int(i)], self.mesh) if k in ("m", "v") else v
                     for k, v in st.items()}
                 for i, st in sorted(sd["state"].items(), key=lambda kv: int(kv[0]))}
        return {**sd, "state": state}

    def shard_optimizer_state(self, sd: Dict, model, optimizer) -> Dict:
        """The rank's shares of a tp=1 ``BertAdam.state_dict``."""
        dims = self._moment_dims(model, optimizer)
        state = {i: {k: shard(v, dims[int(i)], self.size, self.rank) if k in ("m", "v") else v
                     for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {**sd, "state": state}


def parallelize(model: torch.nn.Module, mesh) -> Optional[TensorParallel]:
    """Cut ``model`` (a ``UniVL`` holding the full weights) to this rank's
    shares over ``mesh.axis(TP_AXIS)`` and set its modules' tensor-parallel
    routes: local heads, row-parallel outputs, the vocab-parallel table and
    logits, and with ``mesh.sequence_parallel`` the row-sharded regions of
    the encoders' stacks (``parallel/sp.py``). Returns the model's
    ``TensorParallel`` (also ``model.tp``), None at tp 1."""
    from univl_tpu_torch.nn import layers

    tpv = mesh.axis(TP_AXIS)
    if tpv.size == 1:
        return None
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    layout = param_layout(model.cfg, shapes, tpv.size)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in layout.items():
            if dim is not None:
                p = params[name]
                p.data = shard(p.data, dim, tpv.size, tpv.rank)
    for prefix, module in model.named_modules():
        if isinstance(module, layers.MultiHeadAttention):
            if layout.get(f"{prefix}.query.weight") is not None:
                module.set_tensor_parallel(tpv)
        elif isinstance(module, layers.ResidualOutput):
            if layout.get(f"{prefix}.dense.weight") is not None:
                module.tp = tpv
    ctx = TensorParallel(tpv, layout, bool(mesh.sequence_parallel))
    vocab_dim = layout.get("bert.embeddings.word_embeddings.weight")
    if vocab_dim is not None:
        n = model.bert.embeddings.word_embeddings.weight.shape[0]
        model.set_vocab_shard(VocabShard(tpv, tpv.rank * n, n))
    if ctx.sequence_parallel:
        for tower in ("bert", "visual", "cross"):
            stack = getattr(model, tower, None)
            if stack is not None:
                stack.encoder.set_sequence_parallel(tpv)
    model.tp = ctx
    return ctx
