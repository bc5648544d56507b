"""The autoregressive caption decoder, in PyTorch.

Ports ``univl_tpu/nn/decoder.py``. Each layer: causal self-attention,
attention over the cross encoder's output, then the FFN, all post-LN. In
training mode it drops where the JAX decoder does: the embedding (after its
LayerNorm), every residual block's dense output, and the attention
probabilities of both attentions. The causal self-attention keeps its
additive ``[B, 1, L, L]`` bias (``sdpa_bias``, dropout drawn in PyTorch);
the encoder attention is masked by keys, so in training it takes the
training-attention kernels (#2) as every key-masked attention of the port
does, where the JAX decoder stays on XLA. The
word and position tables and the classifier weight are BERT's: they are
passed in at call time, so the decoder owns no copy of them and its state
dict holds only its own parameters, under the reference names
(``decoder.decoder.layer.0.slf_attn.att.query.weight``,
``decoder.classifier.cls.predictions.bias``, ...).

This is the full-prefix decoder: it runs every position at once. Beam
search runs the KV-cache decoder (``univl_tpu_torch/evals/fast_decoder.py``)
over the same weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from univl_tpu_torch.nn.layers import (
    MASK_BIAS,
    LayerNormTF,
    MultiHeadAttention,
    PredictionHeadTransform,
    Randomness,
    TOWER_TAGS,
    ResidualOutput,
    _Intermediate,
    dropout,
    gelu_erf,
)


def decoder_self_attn_bias(answer_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] pad mask -> [B, 1, L, L] additive bias, -10000 where the key is
    padding or in the future (the strict upper triangle), else 0."""
    L = answer_mask.shape[-1]
    pad = 1.0 - answer_mask.float()[:, None, None, :]
    future = torch.triu(torch.ones(L, L, device=answer_mask.device), diagonal=1)[None, None]
    return ((pad + future) > 0).float() * MASK_BIAS


class _DecoderAttention(nn.Module):
    """Holds ``att`` (the attention) and ``output`` under the reference's names."""

    def __init__(self, cfg, compute_dtype, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.att = MultiHeadAttention(h, cfg.num_attention_heads, compute_dtype, device,
                                      cfg.attention_probs_dropout_prob)
        self.output = ResidualOutput(h, h, compute_dtype, device, cfg.hidden_dropout_prob)


class DecoderLayer(nn.Module):
    """Self-attention, encoder attention, FFN."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}: only gelu is ported")
        h = cfg.hidden_size
        self.slf_attn = _DecoderAttention(cfg, compute_dtype, device)
        self.enc_attn = _DecoderAttention(cfg, compute_dtype, device)
        self.intermediate = _Intermediate(h, cfg.intermediate_size, compute_dtype, device)
        self.output = ResidualOutput(cfg.intermediate_size, h, compute_dtype, device,
                                     cfg.hidden_dropout_prob)

    def forward(self, x, encoder_out, self_bias, encoder_mask,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        slf = self.slf_attn.att(x, bias=self_bias, rng=rng)
        slf_out = self.slf_attn.output(slf, x, rng)
        enc = self.enc_attn.att(slf_out, key_mask=encoder_mask, kv_in=encoder_out, rng=rng)
        enc_out = self.enc_attn.output(enc, slf_out, rng)
        return self.output(gelu_erf(self.intermediate.dense(enc_out)), enc_out, rng)


class _Stack(nn.Module):
    def __init__(self, cfg, compute_dtype, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            DecoderLayer(cfg, compute_dtype, device) for _ in range(cfg.num_decoder_layers))


class _Embeddings(nn.Module):
    def __init__(self, hidden_size: int, device=None):
        super().__init__()
        self.LayerNorm = LayerNormTF(hidden_size, device=device)


class _Predictions(nn.Module):
    def __init__(self, cfg, compute_dtype, device=None):
        super().__init__()
        self.transform = PredictionHeadTransform(cfg.hidden_size, compute_dtype, device)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))


class _Cls(nn.Module):
    def __init__(self, cfg, compute_dtype, device=None):
        super().__init__()
        self.predictions = _Predictions(cfg, compute_dtype, device)


class _Classifier(nn.Module):
    def __init__(self, cfg, compute_dtype, device=None):
        super().__init__()
        self.cls = _Cls(cfg, compute_dtype, device)


class CaptionDecoder(nn.Module):
    """Decoder stack and tied classifier; returns f32 logits [B, L, vocab]."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embeddings = _Embeddings(cfg.hidden_size, device)
        self.decoder = _Stack(cfg, compute_dtype, device)
        self.classifier = _Classifier(cfg, compute_dtype, device)

    def forward(self, input_caption_ids, encoder_out, answer_mask, encoder_mask,
                word_table: torch.Tensor, pos_table: torch.Tensor,
                rng: Optional[Randomness] = None) -> torch.Tensor:
        """``word_table``/``pos_table``: BERT's word and position embeddings;
        ``rng``: the training step's randomness (training mode only)."""
        L = input_caption_ids.shape[1]
        x = word_table[input_caption_ids] + pos_table[:L][None]
        x = self.embeddings.LayerNorm(x)
        if self.training:
            x = dropout(x, self.cfg.hidden_dropout_prob, rng)
        x = x.to(self.compute_dtype)
        self_bias = decoder_self_attn_bias(answer_mask)
        encoder_mask = encoder_mask.float()
        if rng is not None:
            rng = rng.run(TOWER_TAGS["decoder"])
        for i, layer in enumerate(self.decoder.layer):
            x = layer(x, encoder_out, self_bias, encoder_mask, None if rng is None else rng.fold(i))
        pred = self.classifier.cls.predictions
        h = pred.transform(x)
        table = word_table.to(self.compute_dtype)
        # products of compute-dtype operands, summed in f32
        return torch.matmul(h.float(), table.float().t()) + pred.bias
