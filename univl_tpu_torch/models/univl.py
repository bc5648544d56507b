"""UniVL in PyTorch: text, visual and cross towers, the FT-Align similarity
head, the caption decoder, the pretraining heads, and the training forward.

Ports ``univl_tpu/models/univl.py``: serving (encoders, similarities, the
decoder) and, in ``forward``, every training route. Stage one (retrieval,
the max-margin ranking loss, or MIL-NCE with ``use_mil``): FT-Joint and
pretraining stage I, on the mean-pooled joint similarity, and FT-Align
(``train_sim_after_cross``), on the cross encoder's similarity over all
text-video pairs of the batch. Stage two (``stage_two``): caption
fine-tuning (``task_type="caption"``, the decoder's masked cross entropy over
the tied classifier's logits), retrieval fine-tuning (CrossEn over the cross
similarity) and, with ``do_pretrain``, pretraining stage II's five
objectives. Parameters are f32;
``cfg.compute_dtype`` ("float32" or "bfloat16") is the dtype the towers
compute in, and ``cfg.use_fused_ffn`` (False, True or "block") the FFN
route of every tower layer (``nn/layers.py``). The state dict uses the
reference checkpoint's names:

    bert.*                      text tower (with the shared word/position tables)
    visual.*                    visual tower; visual.embeddings.word_embeddings is
                                the feature projection
    normalize_video.visual_norm2d.*   raw-feature LayerNorm
    cross.*, similarity_dense.*       cross tower and FT-Align head (with
                                      train_sim_after_cross or stage_two)
    decoder.*                   caption decoder (with stage_two and without
                                train_sim_after_cross); its word and position
                                tables and classifier weight are bert's
    cls.predictions.*           the masked-language head (with do_pretrain and
                                stage_two); its weight is bert's word table
    cls_visual.predictions.*    the masked-frame head (likewise); its weight is
                                the feature projection's
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.models.losses import (
    cross_en_loss,
    masked_cross_entropy,
    max_margin_ranking_loss,
    mfm_nce_loss,
    milnce_loss,
)
from univl_tpu_torch.nn.decoder import CaptionDecoder
from univl_tpu_torch.nn.layers import LayerNormTF, Linear, PredictionHeadTransform, Randomness
from univl_tpu_torch.nn.towers import CrossEncoder, TextEncoder, VisualEncoder


class NormalizeVideo(nn.Module):
    """LayerNorm over the raw feature dim, in f32; flattens pair dims."""

    def __init__(self, video_dim: int, device=None):
        super().__init__()
        self.visual_norm2d = LayerNormTF(video_dim, device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        video = video.float()
        return self.visual_norm2d(video.reshape(-1, video.shape[-2], video.shape[-1]))


class _HeadPredictions(nn.Module):
    def __init__(self, hidden_size: int, out_size: int, compute_dtype, device=None):
        super().__init__()
        self.transform = PredictionHeadTransform(hidden_size, compute_dtype, device)
        self.bias = nn.Parameter(torch.zeros(out_size, device=device))


class TiedHead(nn.Module):
    """A pretraining head (JAX's ``TiedLMHead`` and ``TiedVisualHead``): the
    transform, then ``h @ W + bias`` with W a tied [hidden, out] matrix,
    products of compute-dtype operands summed in f32 (f32 scores). The
    masked-language head gets bert's word table transposed, the masked-frame
    head the feature projection's weight."""

    def __init__(self, hidden_size: int, out_size: int, compute_dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.predictions = _HeadPredictions(hidden_size, out_size, compute_dtype, device)

    def forward(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        pred = self.predictions
        return torch.matmul(pred.transform(h).float(),
                            w.to(self.compute_dtype).float()) + pred.bias


class UniVL(nn.Module):
    def __init__(self, cfg: UniVLConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
        self.compute_dtype = dt
        ffn = cfg.use_fused_ffn
        self.bert = TextEncoder(cfg.bert, dt, device, ffn)
        self.visual = VisualEncoder(cfg.visual, cfg.video_dim, dt, device, ffn)
        self.normalize_video = NormalizeVideo(cfg.video_dim, device)
        self.has_cross = cfg.stage_two or cfg.train_sim_after_cross
        if self.has_cross:
            self.cross = CrossEncoder(cfg.cross, dt, device, ffn)
            self.similarity_dense = Linear(cfg.cross.hidden_size, 1, dt, device)
        self.has_decoder = cfg.stage_two and not cfg.train_sim_after_cross
        if self.has_decoder:
            self.decoder = CaptionDecoder(cfg.decoder, dt, device)
        self.has_pretrain_heads = cfg.do_pretrain and cfg.stage_two
        if self.has_pretrain_heads:
            self.cls = TiedHead(cfg.bert.hidden_size, cfg.bert.vocab_size, dt, device)
            self.cls_visual = TiedHead(cfg.visual.hidden_size, cfg.video_dim, dt, device)

    def encode(self, input_ids, token_type_ids, attention_mask, video, video_mask,
               rng: Optional[Randomness] = None):
        """Text and visual towers: (sequence output, visual output)."""
        return (self.encode_text(input_ids, token_type_ids, attention_mask, rng),
                self.encode_video(video, video_mask, rng))

    def encode_text(self, input_ids, token_type_ids, attention_mask,
                    rng: Optional[Randomness] = None) -> torch.Tensor:
        """Text tower only: the serving path's queries."""
        return self.bert(input_ids, token_type_ids, attention_mask, rng)

    def encode_video(self, video, video_mask, rng: Optional[Randomness] = None,
                     video_normalized: bool = False) -> torch.Tensor:
        """Raw-feature LayerNorm (unless ``video_normalized``), then the
        visual tower: the serving path's index build."""
        if not video_normalized:
            video = self.normalize_video(video)
        return self.visual(video, video_mask, rng)

    def get_cross_output(self, sequence_output, visual_output, attention_mask, video_mask,
                         rng: Optional[Randomness] = None):
        """Fusion encoder over [text ; video]; returns (hidden, pooled, concat_mask)."""
        concat_features = torch.cat([sequence_output, visual_output], dim=1)
        concat_mask = torch.cat([attention_mask, video_mask], dim=1)
        concat_type = torch.cat(
            [torch.zeros_like(attention_mask), torch.ones_like(video_mask)], dim=1
        ).long()
        cross_out, pooled = self.cross(concat_features, concat_type, concat_mask, rng)
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

    def joint_similarity(self, sequence_output, visual_output, attention_mask,
                         video_mask) -> torch.Tensor:
        """Mean-pooled dot-product similarity [Bt, Bv], L2-normalised without MIL."""
        text_out, video_out = self.mean_pool(sequence_output, visual_output, attention_mask,
                                             video_mask)
        if not self.cfg.use_mil:
            text_out = text_out / torch.linalg.norm(text_out, dim=-1, keepdim=True)
            video_out = video_out / torch.linalg.norm(video_out, dim=-1, keepdim=True)
        return text_out @ video_out.t()

    def cross_similarity(self, sequence_output, visual_output, attention_mask, video_mask,
                         rng: Optional[Randomness] = None) -> torch.Tensor:
        """All-pairs cross-encoder similarity, f32 [Bt, Bv]: text row i
        against every video, as ``jnp.repeat``/``jnp.tile`` lay the pairs out
        (``univl_tpu/models/univl.py:301-328``)."""
        b_text, b_visual = sequence_output.shape[0], visual_output.shape[0]
        return self.cross_similarity_pairs(
            sequence_output.repeat_interleave(b_visual, dim=0),
            visual_output.repeat(b_text, 1, 1),
            attention_mask.repeat_interleave(b_visual, dim=0),
            video_mask.repeat(b_text, 1), rng).reshape(b_text, b_visual)

    def similarity_logits(self, sequence_output, visual_output, attention_mask, video_mask,
                          rng: Optional[Randomness] = None,
                          pretrain_joint: bool = False) -> torch.Tensor:
        """The cross similarity with ``train_sim_after_cross``, or with
        ``stage_two`` unless ``pretrain_joint``, else the joint one
        (``univl_tpu/models/univl.py:347-364``)."""
        c = self.cfg
        if (c.stage_two and not pretrain_joint) or c.train_sim_after_cross:
            return self.cross_similarity(sequence_output, visual_output, attention_mask,
                                         video_mask, rng)
        return self.joint_similarity(sequence_output, visual_output, attention_mask, video_mask)

    def _stage_one_loss(self, sim: torch.Tensor) -> torch.Tensor:
        """MIL-NCE with ``use_mil``, else the max-margin ranking loss
        (``univl_tpu/models/univl.py:366-392``)."""
        c = self.cfg
        if c.use_mil:
            return milnce_loss(sim, c.batch_size_per_device, c.n_pair)
        return max_margin_ranking_loss(
            sim, margin=c.margin, negative_weighting=c.negative_weighting,
            batch_size=c.batch_size_per_device, n_pair=c.n_pair,
            hard_negative_rate=c.hard_negative_rate)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The training forward of every route
        (``univl_tpu/models/univl.py:446-536``): both towers, then in stage
        one the joint similarity (FT-Joint, pretraining stage I) or with
        ``train_sim_after_cross`` the cross similarity (FT-Align), and
        ``_stage_one_loss`` (``sim_loss``). In stage two with ``do_pretrain``
        (pretraining stage II): the towers again on the masked text and
        frames, the cross encoder over them, the masked-language loss
        (``alm_loss``) and the masked-frame NCE (``nce_loss``) on its text
        and video halves, ``_stage_one_loss`` of the unmasked joint
        similarity (``sim_loss_joint``), the decoder on the masked encode
        (``decoder_loss``) and CrossEn of its cross similarity
        (``sim_loss_text_visual``). In stage two without it: for captioning,
        the cross encoder and the decoder under teacher forcing and
        ``masked_cross_entropy`` (``decoder_loss``), for retrieval the cross
        similarity and ``cross_en_loss`` (``sim_loss_text_visual``). Returns
        the JAX dict of losses, with their sum under ``"loss"``.

        ``batch``: ``input_ids``, ``token_type_ids``, ``attention_mask``
        [B, Lw]; ``video`` [B, Lv, video_dim]; ``video_mask`` [B, Lv] (any
        pair dims before the last are flattened); for captioning and
        pretraining stage II also ``input_caption_ids``,
        ``output_caption_ids`` and ``decoder_mask`` [B, Lc] (a batch without
        them has no decoder loss, as in JAX), and for pretraining stage II
        ``masked_text``, ``token_labels`` [B, Lw], ``masked_video`` [B, Lv,
        video_dim] and ``video_labels_index`` [B, Lv]. In training mode
        ``generator`` (a CPU ``torch.Generator``, the step's) gives all the
        dropout; in eval mode nothing is dropped."""
        c = self.cfg
        device = batch["video"].device
        rng = None
        if self.training and generator is not None:
            rng = Randomness.derive(generator, device)

        def flat2(x):
            return x.reshape(-1, x.shape[-1])

        input_ids, token_type_ids = flat2(batch["input_ids"]), flat2(batch["token_type_ids"])
        attention_mask, video_mask = flat2(batch["attention_mask"]), flat2(batch["video_mask"])
        has_captions = batch.get("input_caption_ids") is not None
        if c.stage_two and c.task_type == "caption" and not c.do_pretrain and not has_captions:
            # JAX adds the decoder loss only for a batch with caption ids
            # (univl_tpu/models/univl.py:509); without them its total stays 0
            return {"loss": torch.zeros((), device=device)}
        video = self.normalize_video(batch["video"])
        seq_out = self.encode_text(input_ids, token_type_ids, attention_mask, rng)
        vis_out = self.encode_video(video, video_mask, rng, video_normalized=True)
        if not c.stage_two:
            sim = self.similarity_logits(seq_out, vis_out, attention_mask, video_mask, rng)
            sim_loss = self._stage_one_loss(sim)
            return {"sim_loss": sim_loss, "loss": sim_loss}
        out: Dict[str, torch.Tensor] = {}
        src_seq, src_vis = seq_out, vis_out
        if c.do_pretrain:
            src_seq = self.encode_text(flat2(batch["masked_text"]), token_type_ids,
                                       attention_mask, rng)
            src_vis = self.encode_video(self.normalize_video(batch["masked_video"]), video_mask,
                                        rng, video_normalized=True)
            cross_out, _, _ = self.get_cross_output(src_seq, src_vis, attention_mask, video_mask,
                                                    rng)
            lt = attention_mask.shape[-1]
            word_table = self.bert.embeddings.word_embeddings.weight
            mlm_logits = self.cls(cross_out[:, :lt], word_table.t())
            out["alm_loss"] = masked_cross_entropy(mlm_logits, flat2(batch["token_labels"]))
            mfm_scores = self.cls_visual(cross_out[:, lt:],
                                         self.visual.embeddings.word_embeddings.weight)
            out["nce_loss"] = mfm_nce_loss(mfm_scores, video, video_mask,
                                           flat2(batch["video_labels_index"]))
            sim_joint = self.similarity_logits(seq_out, vis_out, attention_mask, video_mask, rng,
                                               pretrain_joint=True)
            out["sim_loss_joint"] = self._stage_one_loss(sim_joint)
        if has_captions and (c.do_pretrain or c.task_type == "caption"):
            logits = self.decoder_logits(src_seq, src_vis, attention_mask, video_mask,
                                         flat2(batch["input_caption_ids"]),
                                         flat2(batch["decoder_mask"]), rng)
            out["decoder_loss"] = masked_cross_entropy(logits, flat2(batch["output_caption_ids"]))
        if c.do_pretrain or c.task_type == "retrieval":
            sim = self.similarity_logits(src_seq, src_vis, attention_mask, video_mask, rng)
            out["sim_loss_text_visual"] = cross_en_loss(sim)
        out["loss"] = sum(out.values())
        return out

    def cross_similarity_pairs(self, sequence_output, visual_output, attention_mask,
                               video_mask, rng: Optional[Randomness] = None) -> torch.Tensor:
        """Row-aligned cross-encoder similarity [N], f32 (the rerank path)."""
        _, pooled, _ = self.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask, rng)
        return self.similarity_dense(pooled)[:, 0].float()

    def decoder_logits(self, sequence_output, visual_output, attention_mask, video_mask,
                       input_caption_ids, decoder_mask,
                       rng: Optional[Randomness] = None) -> torch.Tensor:
        """Cross-encode once, then the full-prefix decoder: f32 logits [B, L, V]."""
        cross_out, _, concat_mask = self.get_cross_output(
            sequence_output, visual_output, attention_mask, video_mask, rng)
        return self.decode_step_logits(cross_out, concat_mask, input_caption_ids, decoder_mask,
                                       rng)

    def decode_step_logits(self, cross_out, concat_mask, input_caption_ids, decoder_mask,
                           rng: Optional[Randomness] = None) -> torch.Tensor:
        """The decoder on a cross output computed beforehand (the full-prefix
        beam search's step, and the caption training step's decoder)."""
        emb = self.bert.embeddings
        return self.decoder(input_caption_ids, cross_out, decoder_mask, concat_mask,
                            emb.word_embeddings.weight, emb.position_embeddings.weight, rng)
