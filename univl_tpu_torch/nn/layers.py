"""Transformer building blocks of the encoders, in PyTorch (inference only).

Ports ``univl_tpu/nn/layers.py`` and keeps its numerics: erf-GELU, TF-style
LayerNorm (eps 1e-12 inside the sqrt, f32 statistics), post-LN residual
blocks. Parameters are f32; matmuls run in the model's compute dtype and
round their output to it, as flax's ``nn.Dense(dtype=...)`` does. Module and
parameter names follow the reference PyTorch checkpoint
(``bert.encoder.layer.0.attention.self.query.weight`` ...), so weights load
with ``load_state_dict(strict=True)``.

Only the serving path is ported: no dropout, separate q/k/v projections, the
unfused FFN. An attention masked by keys goes through
``kernels.attention.fused_attention_masked`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU one); any other additive bias (the
caption decoder's causal ``[B, 1, L, L]`` one) takes ``sdpa_bias``, plain
PyTorch, as the JAX package sends it to its XLA path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from univl_tpu_torch.kernels.attention import fused_attention_masked

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


def sdpa_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Attention with an additive bias broadcastable to [B, H, Lq, Lk], in
    plain PyTorch (``univl_tpu/nn/layers.py:sdpa_xla``): scores and softmax
    in f32, probs rounded to q's dtype before PV, PV summed in f32."""
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
              + bias.float())
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


class LayerNormTF(nn.Module):
    """TF-style LayerNorm: f32 statistics, eps inside the sqrt, output in the input dtype."""

    def __init__(self, dim: int, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(dim=-1, keepdim=True)
        s = (xf - u).square().mean(dim=-1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


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
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.query = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.key = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.value = Linear(hidden_size, hidden_size, compute_dtype, device)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                kv_in: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Exactly one of ``key_mask`` ([B, Lk], 1 keep, 0 drop: the eval
        attention kernel) and ``bias`` (additive: ``sdpa_bias``)."""
        if (key_mask is None) == (bias is None):
            raise ValueError("give exactly one of key_mask and bias")
        kv_in = x if kv_in is None else kv_in

        def split(t):  # a strided [B, H, L, D] view of [B, L, H*D]
            return t.view(t.shape[0], t.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(kv_in)), split(self.value(kv_in))
        if key_mask is not None:
            ctx = fused_attention_masked(q, k, v, key_mask)
        else:
            ctx = sdpa_bias(q, k, v, bias)
        b, l = x.shape[:2]
        return ctx.transpose(1, 2).reshape(b, l, self.num_heads * self.head_dim)


class ResidualOutput(nn.Module):
    """dense -> add residual -> LayerNorm (post-LN)."""

    def __init__(self, in_features: int, features: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dense = Linear(in_features, features, compute_dtype, device)
        self.LayerNorm = LayerNormTF(features, device=device)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    """Holds ``self`` (the attention) and ``output`` under the reference's names."""

    def __init__(self, hidden_size: int, num_heads: int, compute_dtype, device=None):
        super().__init__()
        self.self = MultiHeadAttention(hidden_size, num_heads, compute_dtype, device)
        self.output = ResidualOutput(hidden_size, hidden_size, compute_dtype, device)


class _Intermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, compute_dtype, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, intermediate_size, compute_dtype, device)


class TransformerLayer(nn.Module):
    """Post-LN encoder block: self-attention, then the FFN."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}: only gelu is ported")
        h = cfg.hidden_size
        self.attention = _Attention(h, cfg.num_attention_heads, compute_dtype, device)
        self.intermediate = _Intermediate(h, cfg.intermediate_size, compute_dtype, device)
        self.output = ResidualOutput(cfg.intermediate_size, h, compute_dtype, device)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        attn = self.attention.self(x, key_mask)
        attn_out = self.attention.output(attn, x)
        inter = gelu_erf(self.intermediate.dense(attn_out))
        return self.output(inter, attn_out)


class TransformerStack(nn.Module):
    """``cfg.num_hidden_layers`` identical post-LN blocks."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerLayer(cfg, compute_dtype, device) for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, key_mask)
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
