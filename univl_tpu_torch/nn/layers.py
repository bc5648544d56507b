"""Transformer building blocks of the encoders, in PyTorch.

Ports ``univl_tpu/nn/layers.py`` and keeps its numerics: erf-GELU, TF-style
LayerNorm (eps 1e-12 inside the sqrt, f32 statistics), post-LN residual
blocks. Parameters are f32; matmuls run in the model's compute dtype and
round their output to it, as flax's ``nn.Dense(dtype=...)`` does. Module and
parameter names follow the reference PyTorch checkpoint
(``bert.encoder.layer.0.attention.self.query.weight`` ...), so weights load
with ``load_state_dict(strict=True)``.

Separate q/k/v projections, as the JAX package runs by default. The FFN is
unfused by default; ``use_fused_ffn`` (``TransformerLayer``, from
``cfg.use_fused_ffn``) routes it through ``kernels.ffn``: ``True`` runs the
fused FFN kernel (#3) with the dropout, residual and LayerNorm after it in
plain PyTorch, ``"block"`` folds those into the kernel (#4) and folds the
attention output's dense, dropout, residual and LayerNorm into the dense-block
kernel (#5). The parameters keep their names either way. In eval mode an
attention masked by keys goes through
``kernels.attention.fused_attention_masked`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU one); any other additive bias (the caption
decoder's causal ``[B, 1, L, L]`` one) takes ``sdpa_bias``, plain PyTorch, as
the JAX package sends it to its XLA path.

Training mode (``module.training``) adds what the JAX package's
``deterministic=False`` adds: hidden dropout after each residual block's
dense, key-masked attention through ``kernels.train_attention`` (forward and
backward kernels, the attention-probability dropout drawn inside them), and
the additive-bias attention (the decoder's causal self-attention) through
``sdpa_bias`` with its probability dropout drawn in PyTorch, as the JAX
package's XLA path draws it. Its randomness comes from a ``Randomness``
passed down explicitly and keyed by where it is drawn (each run of a stack
folds its tower and the run's number in the step, each layer its index), so
a tower run twice in one step draws other masks the second time and
``TransformerStack``'s ``remat`` recomputes a layer with its first pass's
dropout; nothing reads PyTorch's global random state.

``LayerNormTF`` computes in plain PyTorch unless its ``fused`` flag is set
(``set_fused_layer_norm``, the counterpart of JAX's ``UNIVL_TPU_FUSED_LN=1``,
set per model): then ``kernels.layernorm.fused_layer_norm`` (#6).

Tensor parallelism (``parallel/tp.py:parallelize`` sets it on a model that
holds a rank's shares): ``MultiHeadAttention`` runs the rank's heads
(``local_heads`` from ``head0``, the column-parallel q/k/v) behind
``comm.copy_to_tp``, ``ResidualOutput`` (and ``FusedFFNOutput``) takes the
row-parallel product's partial through ``comm.reduce_from_tp`` before the
bias, or with the kernels #3-#5 their split halves (``kernels/ffn.py``), and
the layers put ``copy_to_tp`` before the FFN's column-parallel product. With
sequence parallelism (``parallel/sp.py``) on an encoder stack the stream
between the blocks is the rank's rows ``[n, H]``: the same places gather the
rows and scatter them instead. Every random draw keeps the unsplit call's
shape and bits: the plain dropout draws the full shape and takes the rank's
rows (``rows``) or heads (``sdpa_bias``'s ``heads``), and the kernels take the
offset of the rank's first head (#2) or row (#4, #5) in their counters.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from univl_tpu_torch.config import check_fused_ffn, check_remat
from univl_tpu_torch.kernels.attention import fused_attention_masked
from univl_tpu_torch.kernels.ffn import (
    fused_dense_block,
    fused_dense_block_tp,
    fused_ffn,
    fused_ffn_block,
    fused_ffn_block_tp,
    fused_ffn_tp,
)
from univl_tpu_torch.kernels.layernorm import fused_layer_norm
from univl_tpu_torch.kernels.train_attention import fused_train_attention
from univl_tpu_torch.parallel import comm, sp

MASK_BIAS = -10000.0
LN_EPS = 1e-12


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x, approximate="none")


def additive_mask_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] 0/1 mask -> [B, 1, 1, L] additive bias (0 keep, -10000 drop).

    The reference's bias. The attention here takes the 0/1 key mask itself
    and applies the kernel's -1e9, which gives the same softmax on every query
    whose keys are not all masked."""
    return ((1.0 - mask.to(dtype)) * MASK_BIAS)[:, None, None, :]


_MASK64 = (1 << 64) - 1
KEY_BITS = (1 << 62) - 1  # keys and Philox seeds are 62-bit host ints

# the tags a key is folded with: a tower's stack (then the run's number in
# the step, then its layer index), and within a layer each kernel call that
# draws in-kernel dropout
TOWER_TAGS = {"text": 1, "visual": 2, "cross": 3, "decoder": 4}
CALL_ATTENTION, CALL_DENSE_BLOCK, CALL_FFN_BLOCK = 1, 2, 3


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_key(key: int, tag: int) -> int:
    """A fixed mix of (key, tag) to a 62-bit key: flax's ``fold_in``."""
    return _splitmix64(key ^ _splitmix64(tag)) & KEY_BITS


def draw_key(generator: torch.Generator) -> int:
    """The next key of a step's CPU generator: each training forward draws
    one (``Randomness.derive``), so a data-parallel rank skips the keys of
    the micro-batches before its own by drawing them."""
    return int(torch.randint(0, KEY_BITS + 1, (), generator=generator))


class Randomness(NamedTuple):
    """A training step's randomness, keyed by where it is drawn, as flax
    folds its ``dropout`` rng stream per module path: ``key``, a host int,
    and ``device``, a generator on the activations' device seeded from it
    (the hidden, embedding and additive-bias attention dropout masks).
    ``run(tag)`` keys the n-th run of a stack in the step by (tag, n), as
    flax counts a scope's ``make_rng`` calls, and ``fold`` gives each layer
    of that run a child of its own; a kernel call inside the layer takes
    ``kernel_seed(call)``, its Philox key. A layer recomputed under
    activation checkpointing folds again from its run's key, so it draws the
    masks of its first pass. Nothing reads PyTorch's global random state."""

    key: int
    device: torch.Generator
    runs: dict  # tag -> runs counted so far in this step

    @classmethod
    def from_key(cls, key: int, device) -> "Randomness":
        return cls(key, torch.Generator(device=torch.device(device)).manual_seed(key), {})

    @classmethod
    def derive(cls, generator: torch.Generator, device) -> "Randomness":
        """The step's randomness on ``device``, keyed by the next draw of
        the step's CPU generator (one draw a forward)."""
        return cls.from_key(draw_key(generator), device)

    def fold(self, *tags: int) -> "Randomness":
        """The child keyed by ``tags`` folded in turn, with a device
        generator of its own."""
        key = self.key
        for tag in tags:
            key = fold_key(key, tag)
        return Randomness.from_key(key, self.device.device)

    def run(self, tag: int) -> "Randomness":
        """The child of the next run of the stack tagged ``tag`` in this
        step: ``fold(tag, n)`` for its n-th run. It counts, so it is called
        once a run and outside any checkpointed region."""
        n = self.runs.get(tag, 0)
        self.runs[tag] = n + 1
        return self.fold(tag, n)

    def kernel_seed(self, call: int) -> int:
        """The Philox key of one training-attention or fused-FFN call,
        fixed by its call tag (JAX's ``_kernel_dropout_seed``)."""
        return fold_key(self.key, call)


def kernel_dropout(training: bool, rate: float, rng: Optional[Randomness], call: int):
    """(rate, Philox seed) of a kernel with in-kernel dropout at call tag
    ``call``: rate 0 outside training, and a rate of 0 takes seed 0
    (``univl_tpu/nn/layers.py:270-282``)."""
    rate = rate if training else 0.0
    if rate > 0.0 and rng is None:
        raise ValueError("dropout in training mode needs a Randomness")
    return rate, (rng.kernel_seed(call) if rate > 0.0 else 0)


def dropout(x: torch.Tensor, rate: float, rng: Optional[Randomness],
            rows: Optional[tuple] = None, heads: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by it; rate 0 is the identity and draws nothing. A
    tensor-parallel rank's share draws the whole tensor's mask and takes its
    part, so its bits, and every later draw of the generator, are the
    unsplit run's: ``rows`` = (row0, total) for rows [row0, row0 + n) of a
    ``[total, H]`` stream (x ``[n, H]``), ``heads`` = (head0, total) for heads
    [head0, head0 + h) of ``[B, total, Lq, Lk]`` probabilities."""
    if rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs a Randomness")
    keep_prob = 1.0 - rate
    shape = x.shape
    if rows is not None:
        shape = (rows[1], *x.shape[1:])
    elif heads is not None:
        shape = (x.shape[0], heads[1], *x.shape[2:])
    draw = torch.rand(shape, generator=rng.device, device=x.device)
    if rows is not None:
        draw = draw[rows[0]:rows[0] + x.shape[0]]
    elif heads is not None:
        draw = draw[:, heads[0]:heads[0] + x.shape[1]]
    keep = draw < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def sdpa_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
              dropout_rate: float = 0.0, rng: Optional[Randomness] = None,
              heads: Optional[tuple] = None) -> torch.Tensor:
    """Attention with an additive bias broadcastable to [B, H, Lq, Lk], in
    plain PyTorch (``univl_tpu/nn/layers.py:sdpa_xla``): scores and softmax
    in f32, the probabilities dropped at ``dropout_rate`` (drawn from
    ``rng.device``), rounded to q's dtype before PV, PV summed in f32.
    ``heads`` = (head0, total): q holds heads [head0, head0 + H) of the call
    (a tensor-parallel rank's), whose dropout bits they keep."""
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
              + bias.float())
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, rng, heads=heads).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


class LayerNormTF(nn.Module):
    """TF-style LayerNorm: f32 statistics, eps inside the sqrt, output in
    the input dtype; with ``fused`` the LayerNorm kernel (#6)."""

    def __init__(self, dim: int, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.fused = False
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return fused_layer_norm(x, self.weight, self.bias, self.eps)
        xf = x.float()
        u = xf.mean(dim=-1, keepdim=True)
        s = (xf - u).square().mean(dim=-1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def set_fused_layer_norm(model: nn.Module, on: bool = True) -> nn.Module:
    """Route every ``LayerNormTF`` of ``model`` through the LayerNorm kernel
    (#6), or back: the towers, ``NormalizeVideo``, the decoder and its
    classifier transform, and so the KV-cache decoder, which calls the same
    modules. The LayerNorms folded into the fused-FFN kernels (#4, #5) stay
    where they are. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, LayerNormTF):
            m.fused = on
    return model


class Linear(nn.Linear):
    """f32 parameters, computed and returned in ``compute_dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MultiHeadAttention(nn.Module):
    """Attention with separate q/k/v projections (the reference's
    ``attention.self`` and the decoder's ``att``); ``kv_in`` gives the keys
    and values another source (the decoder's encoder attention)."""

    def __init__(self, hidden_size: int, num_heads: int, compute_dtype: torch.dtype,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.dropout_rate = dropout_rate  # of the attention probabilities, in training
        self.query = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.key = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.value = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.local_heads, self.head0 = num_heads, 0  # a tensor-parallel rank's heads
        self.tp = None  # the tp view, when q/k/v hold the rank's heads
        self.sp = None  # the tp view, when x is the rank's rows (sequence parallelism)

    def set_tensor_parallel(self, mesh) -> None:
        """q/k/v hold heads [head0, head0 + local_heads) of ``mesh``'s rank."""
        self.tp = mesh
        self.local_heads = self.num_heads // mesh.size
        self.head0 = mesh.rank * self.local_heads

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                kv_in: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        """Exactly one of ``key_mask`` ([B, Lk], 1 keep, 0 drop: the eval
        attention kernel, or in training the training-attention kernels on
        the dense projections) and ``bias`` (additive: ``sdpa_bias``, with
        probability dropout in training). Under tensor parallelism the
        result is the rank's heads' context; under sequence parallelism x
        is the rank's rows of a self-attention's ``[B, L, H]`` input (B, L
        from ``key_mask``)."""
        if (key_mask is None) == (bias is None):
            raise ValueError("give exactly one of key_mask and bias")
        if self.sp is not None:
            x = comm.gather_rows_tp(x, self.sp).view(*key_mask.shape, x.shape[-1])
            kv_in = None
        elif self.tp is not None:
            x = comm.copy_to_tp(x, self.tp)
            kv_in = None if kv_in is None else comm.copy_to_tp(kv_in, self.tp)
        kv_in = x if kv_in is None else kv_in
        heads = self.local_heads
        if self.training and key_mask is not None:
            rate, seed = kernel_dropout(True, self.dropout_rate, rng, CALL_ATTENTION)
            shard = {} if self.tp is None else {"head0": self.head0}  # the rank's heads
            return fused_train_attention(self.query(x), self.key(kv_in), self.value(kv_in),
                                         key_mask, seed, rate, heads, **shard)

        def split(t):  # a strided [B, H, L, D] view of [B, L, H*D]
            return t.view(t.shape[0], t.shape[1], heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(kv_in)), split(self.value(kv_in))
        if key_mask is not None:
            ctx = fused_attention_masked(q, k, v, key_mask)
        else:
            shard = {} if self.tp is None else {"heads": (self.head0, self.num_heads)}
            ctx = sdpa_bias(q, k, v, bias, self.dropout_rate if self.training else 0.0, rng,
                            **shard)
        b, l = x.shape[:2]
        return ctx.transpose(1, 2).reshape(b, l, heads * self.head_dim)


class ResidualOutput(nn.Module):
    """dense -> dropout (in training) -> add residual -> LayerNorm (post-LN).

    ``fold_epilogue`` runs the four in the dense-block kernel (#5,
    ``kernels.ffn.fused_dense_block``), the dropout drawn inside it."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 device=None, dropout_rate: float = 0.0, fold_epilogue: bool = False):
        super().__init__()
        self.dense = Linear(in_features, features, compute_dtype, device)
        self.LayerNorm = LayerNormTF(features, device=device)
        self.dropout_rate = dropout_rate
        self.fold_epilogue = fold_epilogue
        self.tp = None  # the tp view, when dense is row-parallel (the rank's input columns)
        self.sp = None  # the tp view, when the residual and result are the rank's rows

    def sp_parameters(self):
        """The replicated parameters of the row-sharded region."""
        return [self.dense.bias, self.LayerNorm.weight, self.LayerNorm.bias]

    def _rows(self, n: int) -> Optional[tuple]:
        """(row0, total) of the rank's ``n`` rows under sequence parallelism."""
        return None if self.sp is None else (self.sp.rank * n, n * self.sp.size)

    def _forward_tp(self, x: torch.Tensor, residual: torch.Tensor,
                    rng: Optional[Randomness]) -> torch.Tensor:
        """The row-parallel product's partial reduced over the tp ranks, then
        the bias, dropout, residual and LayerNorm (on the rank's rows under
        sequence parallelism: then ``[n, H]``)."""
        dt, ln, seq = self.dense.compute_dtype, self.LayerNorm, self.sp is not None
        if self.fold_epilogue:
            rate, seed = kernel_dropout(self.training, self.dropout_rate, rng, CALL_DENSE_BLOCK)
            r = residual.reshape(-1, residual.shape[-1]).to(dt)
            out = fused_dense_block_tp(
                x.reshape(-1, x.shape[-1]).to(dt), r, self.dense.weight.to(dt).t(),
                self.dense.bias.to(dt), ln.weight, ln.bias, seed, rate, ln.eps, self.tp, seq)
            return out if seq else out.view(residual.shape)
        h = F.linear(x.to(dt), self.dense.weight.to(dt))
        if seq:
            h = comm.scatter_rows_tp(h.reshape(-1, h.shape[-1]), self.tp)
        else:
            h = comm.reduce_from_tp(h, self.tp)
        h = h + self.dense.bias.to(dt)
        if self.training:
            h = dropout(h, self.dropout_rate, rng, rows=self._rows(h.shape[0]))
        return self.LayerNorm(h + residual)

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        if self.tp is not None:
            return self._forward_tp(x, residual, rng)
        if self.fold_epilogue:
            dt, ln = self.dense.compute_dtype, self.LayerNorm
            rate, seed = kernel_dropout(self.training, self.dropout_rate, rng, CALL_DENSE_BLOCK)
            out = fused_dense_block(
                x.reshape(-1, x.shape[-1]).to(dt), residual.reshape(-1, residual.shape[-1]).to(dt),
                self.dense.weight.to(dt).t(), self.dense.bias.to(dt), ln.weight, ln.bias, seed,
                rate, ln.eps)
            return out.view(residual.shape)
        h = self.dense(x)
        if self.training:
            h = dropout(h, self.dropout_rate, rng)
        return self.LayerNorm(h + residual)


class FusedFFNOutput(ResidualOutput):
    """The (intermediate dense -> GELU -> ``output``) pair through the fused
    FFN kernel (#3, ``kernels.ffn.fused_ffn``), then dropout, residual and
    LayerNorm; with ``fold_epilogue`` all of it in the FFN-block kernel (#4).
    The parameters are ``ResidualOutput``'s (``dense``, ``LayerNorm``); the
    intermediate dense is passed in, so the names stay the reference's."""

    def forward(self, x: torch.Tensor, intermediate: Linear,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        dt, ln = self.dense.compute_dtype, self.LayerNorm
        x2 = x.reshape(-1, x.shape[-1]).to(dt)
        w = (intermediate.weight.to(dt).t(), intermediate.bias.to(dt),
             self.dense.weight.to(dt).t(), self.dense.bias.to(dt))
        if self.tp is not None:  # the split halves; x is the rank's rows under sp
            seq = self.sp is not None
            if self.fold_epilogue:
                rate, seed = kernel_dropout(self.training, self.dropout_rate, rng,
                                            CALL_FFN_BLOCK)
                out = fused_ffn_block_tp(x2, *w, ln.weight, ln.bias, seed, rate, ln.eps,
                                         self.tp, seq)
                return out if seq else out.view(x.shape)
            y = fused_ffn_tp(x2, *w, self.tp, seq)
            if self.training:
                y = dropout(y, self.dropout_rate, rng, rows=self._rows(y.shape[0]))
            y = ln(y + x2)
            return y if seq else y.view(x.shape)
        if self.fold_epilogue:
            rate, seed = kernel_dropout(self.training, self.dropout_rate, rng, CALL_FFN_BLOCK)
            return fused_ffn_block(x2, *w, ln.weight, ln.bias, seed, rate, ln.eps).view(x.shape)
        y = fused_ffn(x2, *w).view(x.shape)
        if self.training:
            y = dropout(y, self.dropout_rate, rng)
        return ln(y + x.to(dt))


class _Attention(nn.Module):
    """Holds ``self`` (the attention) and ``output`` under the reference's names."""

    def __init__(self, cfg, compute_dtype, device=None, fold_epilogue: bool = False):
        super().__init__()
        h = cfg.hidden_size
        self.self = MultiHeadAttention(h, cfg.num_attention_heads, compute_dtype, device,
                                       cfg.attention_probs_dropout_prob)
        self.output = ResidualOutput(h, h, compute_dtype, device, cfg.hidden_dropout_prob,
                                     fold_epilogue)


class _Intermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, compute_dtype, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, intermediate_size, compute_dtype, device)


def fused_ffn_active(cfg, use_fused_ffn) -> bool:
    """JAX's structural gate (``univl_tpu/nn/layers.py:450-460``): a fused
    FFN route only for GELU and widths that are multiples of 128, so a config
    takes the same route in both packages; JAX's row-count routes are refused
    (``config.check_fused_ffn``)."""
    check_fused_ffn(use_fused_ffn)
    return (bool(use_fused_ffn) and cfg.hidden_act == "gelu" and cfg.hidden_size % 128 == 0
            and cfg.intermediate_size % 128 == 0)


class TransformerLayer(nn.Module):
    """Post-LN encoder block: self-attention, then the FFN.

    ``use_fused_ffn``: False (the unfused FFN), True (#3) or "block" (#4 and
    #5), behind ``fused_ffn_active``'s gate."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None, use_fused_ffn=False):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}: only gelu is ported")
        h = cfg.hidden_size
        self.fused_ffn = fused_ffn_active(cfg, use_fused_ffn)
        block = self.fused_ffn and use_fused_ffn == "block"
        self.attention = _Attention(cfg, compute_dtype, device, fold_epilogue=block)
        self.intermediate = _Intermediate(h, cfg.intermediate_size, compute_dtype, device)
        output = FusedFFNOutput if self.fused_ffn else ResidualOutput
        self.output = output(cfg.intermediate_size, h, compute_dtype, device,
                             cfg.hidden_dropout_prob, fold_epilogue=block)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        attn = self.attention.self(x, key_mask, rng=rng)
        attn_out = self.attention.output(attn, x, rng)
        if self.fused_ffn:
            return self.output(attn_out, self.intermediate.dense, rng)
        return self.output(gelu_erf(self.intermediate.dense(ffn_input(self.output, attn_out))),
                           attn_out, rng)

    def set_sequence_parallel(self, mesh) -> bool:
        """Run the layer on the rank's rows of the stream; False (nothing
        set) where the attention or the FFN is not split over the ranks."""
        if self.attention.self.tp is None or self.attention.output.tp is None \
                or self.output.tp is None:
            return False
        self.attention.self.sp = self.attention.output.sp = self.output.sp = mesh
        return True


def ffn_input(output: "ResidualOutput", x: torch.Tensor) -> torch.Tensor:
    """The unfused FFN's input under tensor parallelism: the column-parallel
    product's ``copy_to_tp``, or the rows gathered under sequence parallelism."""
    if output.sp is not None:
        return comm.gather_rows_tp(x, output.sp)
    if output.tp is not None:
        return comm.copy_to_tp(x, output.tp)
    return x


# the products "dots" keeps: the 2-D weight products (nn.Linear's GEMMs), as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps the dots
# without batch dimensions; batched products (bmm) and the kernels are recomputed
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: save the
    outputs of ``DOTS_SAVED``, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(layer, x, key_mask, rng, i):
    # the fold happens inside the checkpointed call: the recompute re-seeds
    # from the run's key and draws the first pass's masks
    return layer(x, key_mask, None if rng is None else rng.fold(i))


class TransformerStack(nn.Module):
    """``cfg.num_hidden_layers`` identical post-LN blocks; in the stack's
    n-th run of the step, layer i draws its randomness from
    ``rng.run(tag).fold(i)``, that is ``rng.fold(tag, n, i)``.

    ``remat`` (``univl_tpu/nn/layers.py:560-579``): False, True (each layer
    under ``torch.utils.checkpoint``: only its input is kept, the layer runs
    again in the backward) or "dots" (selective checkpointing by
    ``dots_policy``). Only where autograd records: without it there is
    nothing to recompute."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None, use_fused_ffn=False,
                 tag: int = 0, remat=False):
        super().__init__()
        check_remat(remat)
        self.tag = tag
        self.remat = remat
        self.sp = None  # the tp view, when the stack runs sequence-parallel
        self.layer = nn.ModuleList(
            TransformerLayer(cfg, compute_dtype, device, use_fused_ffn)
            for _ in range(cfg.num_hidden_layers)
        )

    def set_sequence_parallel(self, mesh) -> None:
        """Sequence parallelism over ``mesh`` (the tp view) where every layer
        is split over its ranks; otherwise the stack stays as it is."""
        if all(layer.set_sequence_parallel(mesh) for layer in self.layer):
            self.sp = mesh

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        context = (functools.partial(create_selective_checkpoint_contexts, dots_policy)
                   if self.remat == "dots" else noop_context_fn)
        if rng is not None:
            rng = rng.run(self.tag)
        shape = x.shape
        if self.sp is not None:
            x = sp.enter(x, self.sp)
        for i, layer in enumerate(self.layer):
            if remat:
                # the port's generators are keyed, so PyTorch's global RNG
                # state need not be stashed
                x = checkpoint(_run_layer, layer, x, key_mask, rng, i,
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=context)
            else:
                x = _run_layer(layer, x, key_mask, rng, i)
        if self.sp is not None:
            x = sp.leave(x, self.sp, shape)
        return x


class Pooler(nn.Module):
    """First-token pooler: dense + tanh."""

    def __init__(self, hidden_size: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


class PredictionHeadTransform(nn.Module):
    """dense -> erf-GELU -> LayerNorm (the tied classifier's ``transform``)."""

    def __init__(self, hidden_size: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.LayerNorm = LayerNormTF(hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(gelu_erf(self.dense(x)))
