"""The autoregressive caption decoder, in PyTorch (inference only).

Ports ``univl_tpu/nn/decoder.py``. Each layer: causal self-attention,
attention over the cross encoder's output, then the FFN, all post-LN. The
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

import torch
from torch import nn

from univl_tpu_torch.nn.layers import (
    MASK_BIAS,
    LayerNormTF,
    MultiHeadAttention,
    PredictionHeadTransform,
    ResidualOutput,
    _Intermediate,
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

    def __init__(self, hidden_size: int, num_heads: int, compute_dtype, device=None):
        super().__init__()
        self.att = MultiHeadAttention(hidden_size, num_heads, compute_dtype, device)
        self.output = ResidualOutput(hidden_size, hidden_size, compute_dtype, device)


class DecoderLayer(nn.Module):
    """Self-attention, encoder attention, FFN."""

    def __init__(self, cfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}: only gelu is ported")
        h, heads = cfg.hidden_size, cfg.num_attention_heads
        self.slf_attn = _DecoderAttention(h, heads, compute_dtype, device)
        self.enc_attn = _DecoderAttention(h, heads, compute_dtype, device)
        self.intermediate = _Intermediate(h, cfg.intermediate_size, compute_dtype, device)
        self.output = ResidualOutput(cfg.intermediate_size, h, compute_dtype, device)

    def forward(self, x, encoder_out, self_bias, encoder_mask) -> torch.Tensor:
        slf_out = self.slf_attn.output(self.slf_attn.att(x, bias=self_bias), x)
        enc = self.enc_attn.att(slf_out, key_mask=encoder_mask, kv_in=encoder_out)
        enc_out = self.enc_attn.output(enc, slf_out)
        return self.output(gelu_erf(self.intermediate.dense(enc_out)), enc_out)


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
                word_table: torch.Tensor, pos_table: torch.Tensor) -> torch.Tensor:
        """``word_table``/``pos_table``: BERT's word and position embeddings."""
        L = input_caption_ids.shape[1]
        x = word_table[input_caption_ids] + pos_table[:L][None]
        x = self.embeddings.LayerNorm(x).to(self.compute_dtype)
        self_bias = decoder_self_attn_bias(answer_mask)
        encoder_mask = encoder_mask.float()
        for layer in self.decoder.layer:
            x = layer(x, encoder_out, self_bias, encoder_mask)
        pred = self.classifier.cls.predictions
        h = pred.transform(x)
        table = word_table.to(self.compute_dtype)
        # products of compute-dtype operands, summed in f32
        return torch.matmul(h.float(), table.float().t()) + pred.bias
