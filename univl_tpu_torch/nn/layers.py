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
passed down explicitly; nothing reads PyTorch's global random state.

``LayerNormTF`` computes in plain PyTorch unless its ``fused`` flag is set
(``set_fused_layer_norm``, the counterpart of JAX's ``UNIVL_TPU_FUSED_LN=1``,
set per model): then ``kernels.layernorm.fused_layer_norm`` (#6).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from univl_tpu_torch.config import check_fused_ffn
from univl_tpu_torch.kernels.attention import fused_attention_masked
from univl_tpu_torch.kernels.ffn import fused_dense_block, fused_ffn, fused_ffn_block
from univl_tpu_torch.kernels.layernorm import fused_layer_norm
from univl_tpu_torch.kernels.train_attention import fused_train_attention

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


class Randomness(NamedTuple):
    """A training step's randomness: ``host``, a CPU generator, gives each
    training-attention call its Philox seed without a device sync; ``device``,
    a generator on the activations' device, draws the hidden and embedding
    dropout masks. The counterpart of flax's ``dropout`` rng stream."""

    host: torch.Generator
    device: torch.Generator

    @classmethod
    def derive(cls, generator: torch.Generator, device) -> "Randomness":
        """From the step's CPU generator: ``generator`` itself, and a
        generator on ``device`` seeded from its next draw."""
        device = torch.device(device)
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        return cls(generator, torch.Generator(device=device).manual_seed(seed))

    def kernel_seed(self) -> int:
        """A Philox key for one training-attention or fused-FFN call (JAX's
        ``_kernel_dropout_seed``: one draw per call)."""
        return int(torch.randint(0, 2**62, (), generator=self.host))


def kernel_dropout(training: bool, rate: float, rng: Optional[Randomness]):
    """(rate, Philox seed) of a kernel with in-kernel dropout: rate 0 outside
    training, and a rate of 0 draws no seed (``univl_tpu/nn/layers.py:270-282``)."""
    rate = rate if training else 0.0
    if rate > 0.0 and rng is None:
        raise ValueError("dropout in training mode needs a Randomness")
    return rate, (rng.kernel_seed() if rate > 0.0 else 0)


def dropout(x: torch.Tensor, rate: float, rng: Optional[Randomness]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by it; rate 0 is the identity and draws nothing."""
    if rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs a Randomness")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def sdpa_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
              dropout_rate: float = 0.0, rng: Optional[Randomness] = None) -> torch.Tensor:
    """Attention with an additive bias broadcastable to [B, H, Lq, Lk], in
    plain PyTorch (``univl_tpu/nn/layers.py:sdpa_xla``): scores and softmax
    in f32, the probabilities dropped at ``dropout_rate`` (drawn from
    ``rng.device``), rounded to q's dtype before PV, PV summed in f32."""
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
              + bias.float())
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, rng).to(q.dtype)
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

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                kv_in: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        """Exactly one of ``key_mask`` ([B, Lk], 1 keep, 0 drop: the eval
        attention kernel, or in training the training-attention kernels on
        the dense projections) and ``bias`` (additive: ``sdpa_bias``, with
        probability dropout in training)."""
        if (key_mask is None) == (bias is None):
            raise ValueError("give exactly one of key_mask and bias")
        kv_in = x if kv_in is None else kv_in
        if self.training and key_mask is not None:
            rate, seed = kernel_dropout(True, self.dropout_rate, rng)
            return fused_train_attention(self.query(x), self.key(kv_in), self.value(kv_in),
                                         key_mask, seed, rate, self.num_heads)

        def split(t):  # a strided [B, H, L, D] view of [B, L, H*D]
            return t.view(t.shape[0], t.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(kv_in)), split(self.value(kv_in))
        if key_mask is not None:
            ctx = fused_attention_masked(q, k, v, key_mask)
        else:
            ctx = sdpa_bias(q, k, v, bias, self.dropout_rate if self.training else 0.0, rng)
        b, l = x.shape[:2]
        return ctx.transpose(1, 2).reshape(b, l, self.num_heads * self.head_dim)


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

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        if self.fold_epilogue:
            dt, ln = self.dense.compute_dtype, self.LayerNorm
            rate, seed = kernel_dropout(self.training, self.dropout_rate, rng)
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
        if self.fold_epilogue:
            rate, seed = kernel_dropout(self.training, self.dropout_rate, rng)
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
        inter = gelu_erf(self.intermediate.dense(attn_out))
        return self.output(inter, attn_out, rng)


class TransformerStack(nn.Module):
    """``cfg.num_hidden_layers`` identical post-LN blocks."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None, use_fused_ffn=False):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(cfg, compute_dtype, device, use_fused_ffn)
            for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, key_mask, rng)
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
