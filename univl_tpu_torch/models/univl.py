"""UniVL's serving subset in PyTorch: text, visual and cross towers, the
FT-Align similarity head and the caption decoder.

Ports the serving parts of ``univl_tpu/models/univl.py``. The pretraining
heads are not ported yet. Parameters are f32;
``cfg.compute_dtype`` ("float32" or "bfloat16") is the dtype the towers
compute in. The state dict uses the reference checkpoint's names:

    bert.*                      text tower (with the shared word/position tables)
    visual.*                    visual tower; visual.embeddings.word_embeddings is
                                the feature projection
    normalize_video.visual_norm2d.*   raw-feature LayerNorm
    cross.*, similarity_dense.*       cross tower and FT-Align head (with
                                      train_sim_after_cross or stage_two)
    decoder.*                   caption decoder (with stage_two and without
                                train_sim_after_cross); its word and position
                                tables and classifier weight are bert's
"""

from __future__ import annotations

import torch
from torch import nn

from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.nn.decoder import CaptionDecoder
from univl_tpu_torch.nn.layers import LayerNormTF, Linear
from univl_tpu_torch.nn.towers import CrossEncoder, TextEncoder, VisualEncoder


class NormalizeVideo(nn.Module):
    """LayerNorm over the raw feature dim, in f32; flattens pair dims."""

    def __init__(self, video_dim: int, device=None):
        super().__init__()
        self.visual_norm2d = LayerNormTF(video_dim, device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        video = video.float()
        return self.visual_norm2d(video.reshape(-1, video.shape[-2], video.shape[-1]))


class UniVL(nn.Module):
    def __init__(self, cfg: UniVLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
        self.compute_dtype = dt
        self.bert = TextEncoder(cfg.bert, dt, device)
        self.visual = VisualEncoder(cfg.visual, cfg.video_dim, dt, device)
        self.normalize_video = NormalizeVideo(cfg.video_dim, device)
        self.has_cross = cfg.stage_two or cfg.train_sim_after_cross
        if self.has_cross:
            self.cross = CrossEncoder(cfg.cross, dt, device)
            self.similarity_dense = Linear(cfg.cross.hidden_size, 1, dt, device)
        self.has_decoder = cfg.stage_two and not cfg.train_sim_after_cross
        if self.has_decoder:
            self.decoder = CaptionDecoder(cfg.decoder, dt, device)

    def encode(self, input_ids, token_type_ids, attention_mask, video, video_mask):
        """Text and visual towers: (sequence output, visual output)."""
        return (self.encode_text(input_ids, token_type_ids, attention_mask),
                self.encode_video(video, video_mask))

    def encode_text(self, input_ids, token_type_ids, attention_mask) -> torch.Tensor:
        """Text tower only: the serving path's queries."""
        return self.bert(input_ids, token_type_ids, attention_mask)

    def encode_video(self, video, video_mask) -> torch.Tensor:
        """Raw-feature LayerNorm, then the visual tower: the serving path's index build."""
        return self.visual(self.normalize_video(video), video_mask)

    def get_cross_output(self, sequence_output, visual_output, attention_mask, video_mask):
        """Fusion encoder over [text ; video]; returns (hidden, pooled, concat_mask)."""
        concat_features = torch.cat([sequence_output, visual_output], dim=1)
        concat_mask = torch.cat([attention_mask, video_mask], dim=1)
        concat_type = torch.cat(
            [torch.zeros_like(attention_mask), torch.ones_like(video_mask)], dim=1
        ).long()
        cross_out, pooled = self.cross(concat_features, concat_type, concat_mask)
        return cross_out, pooled, concat_mask

    @staticmethod
    def mean_pool(sequence_output, visual_output, attention_mask, video_mask):
        """Masked mean pooling; the text side leaves out CLS."""
        am = attention_mask.float()[:, :, None].clone()
        am[:, 0, :] = 0.0
        text_out = (sequence_output.float() * am).sum(dim=1) / am.sum(dim=1)
        vm = video_mask.float()[:, :, None]
        vm_sum = vm.sum(dim=1)
        vm_sum = torch.where(vm_sum == 0.0, torch.ones_like(vm_sum), vm_sum)
        video_out = (visual_output.float() * vm).sum(dim=1) / vm_sum
        return text_out, video_out

    def cross_similarity_pairs(self, sequence_output, visual_output, attention_mask,
                               video_mask) -> torch.Tensor:
        """Row-aligned cross-encoder similarity [N] (the rerank path)."""
        _, pooled, _ = self.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask)
        return self.similarity_dense(pooled)[:, 0].float()

    def decoder_logits(self, sequence_output, visual_output, attention_mask, video_mask,
                       input_caption_ids, decoder_mask) -> torch.Tensor:
        """Cross-encode once, then the full-prefix decoder: f32 logits [B, L, V]."""
        cross_out, _, concat_mask = self.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask)
        return self.decode_step_logits(cross_out, concat_mask, input_caption_ids, decoder_mask)

    def decode_step_logits(self, cross_out, concat_mask, input_caption_ids,
                           decoder_mask) -> torch.Tensor:
        """The decoder on a cross output computed beforehand (the full-prefix
        beam search's step)."""
        emb = self.bert.embeddings
        return self.decoder(input_caption_ids, cross_out, decoder_mask, concat_mask,
                            emb.word_embeddings.weight, emb.position_embeddings.weight)
