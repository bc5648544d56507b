"""Transformer building blocks of the encoders, in PyTorch (inference only).

Ports ``univl_tpu/nn/layers.py`` and keeps its numerics: erf-GELU, TF-style
LayerNorm (eps 1e-12 inside the sqrt, f32 statistics), post-LN residual
blocks. Parameters are f32; matmuls run in the model's compute dtype and
round their output to it, as flax's ``nn.Dense(dtype=...)`` does. Module and
parameter names follow the reference PyTorch checkpoint
(``bert.encoder.layer.0.attention.self.query.weight`` ...), so weights load
with ``load_state_dict(strict=True)``.

Only the serving path is ported: no dropout, separate q/k/v projections, the
unfused FFN, and every attention core goes through
``kernels.attention.fused_attention_masked`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU one).
"""

from __future__ import annotations

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
    """Self-attention with separate q/k/v projections (the reference's ``attention.self``)."""

    def __init__(self, hidden_size: int, num_heads: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.query = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.key = Linear(hidden_size, hidden_size, compute_dtype, device)
        self.value = Linear(hidden_size, hidden_size, compute_dtype, device)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape

        def split(t):  # a strided [B, H, L, D] view of [B, L, H*D]
            return t.view(b, l, self.num_heads, self.head_dim).transpose(1, 2)

        ctx = fused_attention_masked(
            split(self.query(x)), split(self.key(x)), split(self.value(x)), key_mask
        )
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
