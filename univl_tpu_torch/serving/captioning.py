"""Batched captioning service over raw S3D feature clips, in PyTorch.

Ports ``univl_tpu/serving/captioning.py``: ragged request lists are padded
into the generator's fixed batch and decoded with or without transcripts:
  - with transcripts: the YouCook2 caption setting (the encoder's text is the
    transcript);
  - without: the MSRVTT video-only setting (the encoder's text is [CLS][SEP]).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from univl_tpu_torch.data.text_encoding import encode_text, pad_video
from univl_tpu_torch.evals.beam import CaptionGenerator


def resolve_fused(explicit: Optional[bool], device: torch.device) -> bool:
    """The serving default of ``fused_decode`` and ``fused_vocab``: an
    explicit value wins either way; otherwise on for a CUDA device (the
    kernels) and off on the CPU (their plain versions gain nothing there)."""
    return bool(explicit) if explicit is not None else device.type == "cuda"


class CaptionService:
    """``batch_size`` is the decode batch: requests are padded (or merged by
    the coalescer) up to it. ``model`` must already be on ``device``."""

    def __init__(self, model, tokenizer, device, beam_size: int = 5,
                 max_len: Optional[int] = None, batch_size: int = 16,
                 fused_decode: Optional[bool] = None, fused_vocab: Optional[bool] = None,
                 fused_cls: bool = False):
        cfg = model.cfg
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        self.max_words = cfg.max_words
        self.max_frames = cfg.max_frames
        self.video_dim = cfg.video_dim
        self.batch_size = batch_size
        self.fused_decode = resolve_fused(fused_decode, self.device)
        self.fused_vocab = resolve_fused(fused_vocab, self.device)
        # the transform inside the vocab kernel: off by default, as in JAX
        self.fused_cls = bool(fused_cls) and self.fused_vocab
        self.generator = CaptionGenerator(
            model, tokenizer, self.device, beam_size=beam_size,
            max_len=max_len or cfg.max_words, fused_decode=self.fused_decode,
            fused_vocab=self.fused_vocab, fused_cls=fused_cls)

    def caption(self, videos: Sequence[np.ndarray],
                transcripts: Optional[Sequence[str]] = None) -> List[str]:
        """``videos``: [T_i, video_dim] feature arrays (ragged);
        ``transcripts``: optional encoder-side text per clip."""
        n = len(videos)
        if transcripts is not None and len(transcripts) != n:
            raise ValueError(f"{len(transcripts)} transcripts for {n} videos")
        outs: List[str] = []
        B = self.batch_size
        for i0 in range(0, n, B):
            chunk_v = videos[i0: i0 + B]
            chunk_t = transcripts[i0: i0 + B] if transcripts is not None else None
            outs.extend(self.generator.generate(self._build_batch(chunk_v, chunk_t))
                        [: len(chunk_v)])
        return outs

    def _build_batch(self, videos, transcripts):
        B = self.batch_size
        feats = np.zeros((B, self.max_frames, self.video_dim), np.float32)
        vmask = np.zeros((B, self.max_frames), np.int32)
        ids = np.zeros((B, self.max_words), np.int32)
        amask = np.zeros((B, self.max_words), np.int32)
        for i in range(B):
            j = min(i, len(videos) - 1)  # pad slots repeat the last row
            feats[i], vmask[i], _ = pad_video(np.asarray(videos[j], np.float32),
                                              self.max_frames, self.video_dim)
            text = transcripts[j] if transcripts is not None else ""
            e = encode_text(text, self.tokenizer, self.max_words)
            ids[i], amask[i] = e["input_ids"], e["attention_mask"]
        return {
            "input_ids": ids,
            "token_type_ids": np.zeros((B, self.max_words), np.int32),
            "attention_mask": amask,
            "video": feats,
            "video_mask": vmask,
        }
