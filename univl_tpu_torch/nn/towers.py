"""The three encoder towers: text (BERT), visual (S3D features), cross (fusion).

Ports ``univl_tpu/nn/towers.py``. The towers share ``TransformerStack`` and
differ only in their embeddings; every tower sums its embeddings and takes
their LayerNorm in f32, then runs its stack in the compute dtype. Module
names are the reference checkpoint's (``bert.embeddings.word_embeddings``,
``visual.embeddings.word_embeddings`` for the feature projection, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from univl_tpu_torch.nn.layers import LayerNormTF, Pooler, TransformerStack


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)[None, :]


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, device=device)
        self.LayerNorm = LayerNormTF(cfg.hidden_size, device=device)


class TextEncoder(nn.Module):
    """BERT text encoder without its pooler, which UniVL never reads."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embeddings = _TextEmbeddings(cfg, device)
        self.encoder = TransformerStack(cfg, compute_dtype, device)

    def forward(self, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
        e = self.embeddings
        x = (e.word_embeddings(input_ids) + e.position_embeddings(_positions(input_ids))
             + e.token_type_embeddings(token_type_ids))
        x = e.LayerNorm(x).to(self.compute_dtype)
        return self.encoder(x, attention_mask.to(torch.float32))


class FeatureProjection(nn.Linear):
    """Linear(video_dim -> hidden): a product in the compute dtype, rounded to
    it, plus the f32 bias -- so the result is f32, as in the JAX tower."""

    def __init__(self, video_dim: int, hidden_size: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__(video_dim, hidden_size, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias


class _VisualEmbeddings(nn.Module):
    def __init__(self, cfg, video_dim: int, compute_dtype, device=None):
        super().__init__()
        self.word_embeddings = FeatureProjection(video_dim, cfg.hidden_size, compute_dtype,
                                                 device)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.LayerNorm = LayerNormTF(cfg.hidden_size, device=device)


class VisualEncoder(nn.Module):
    """Transformer over LayerNorm-normalised S3D features."""

    def __init__(self, cfg, video_dim: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embeddings = _VisualEmbeddings(cfg, video_dim, compute_dtype, device)
        self.encoder = TransformerStack(cfg, compute_dtype, device)

    def forward(self, video: torch.Tensor, video_mask: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        x = e.word_embeddings(video) + e.position_embeddings(_positions(video))
        x = e.LayerNorm(x).to(self.compute_dtype)
        return self.encoder(x, video_mask.to(torch.float32))


class _CrossEmbeddings(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, device=device)
        self.LayerNorm = LayerNormTF(cfg.hidden_size, device=device)


class CrossEncoder(nn.Module):
    """Fusion transformer over [text ; video] hidden states; returns
    (last hidden states, CLS pooler output)."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embeddings = _CrossEmbeddings(cfg, device)
        self.encoder = TransformerStack(cfg, compute_dtype, device)
        self.pooler = Pooler(cfg.hidden_size, compute_dtype, device)

    def forward(self, concat_features, concat_type, concat_mask):
        e = self.embeddings
        x = (concat_features + e.position_embeddings(_positions(concat_features))
             + e.token_type_embeddings(concat_type))
        x = e.LayerNorm(x).to(self.compute_dtype)
        h = self.encoder(x, concat_mask.to(torch.float32))
        return h, self.pooler(h)
